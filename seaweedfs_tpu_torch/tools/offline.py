"""Offline volume tools: operate on `.dat`/`.idx` without a server — the
port's copy of seaweedfs_tpu/tools/offline.py.

Reference: `weed fix` rebuilds a corrupted `.idx` by scanning the `.dat`
(weed/command/fix.go:22) and `weed export` writes needles to a tar with
filters (weed/command/export.go:41).
"""

from __future__ import annotations

import io
import os
import tarfile
import time
from typing import Iterator

from ..storage import types as t
from ..storage.idx import IndexWriter, walk_index_file
from ..storage.needle import FLAG_HAS_NAME, Needle, body_length
from ..storage.super_block import SuperBlock


def volume_base(directory: str, volume_id: int, collection: str = "") -> str:
    name = f"{collection}_{volume_id}" if collection else str(volume_id)
    return os.path.join(directory, name)


def scan_dat_file(dat_path: str) -> Iterator[tuple[int, Needle]]:
    """Yield (offset, needle) for every record in a .dat, in file order.

    The reference's ScanVolumeFile walk (needle_read_write.go ReadNeedleHeader
    + body).  Tombstone records (size<0) are yielded too — callers decide.
    """
    import struct

    with open(dat_path, "rb") as f:
        sb = SuperBlock.from_bytes(f.read(64))
        version = sb.version
        offset = sb.block_size()
        f.seek(offset)
        while True:
            header = f.read(t.NEEDLE_HEADER_SIZE)
            if len(header) < t.NEEDLE_HEADER_SIZE:
                return
            n = Needle.parse_header(header)
            size = n.size if n.size > 0 else 0
            body = f.read(body_length(size, version))
            if size > 0:
                n = Needle.from_bytes(header + body, version, verify=False)
            elif version == 3 and len(body) >= 12:
                # tombstone: checksum(4) + append_at_ns(8); consumers like
                # incremental tail sync need deletion timestamps too
                n.append_at_ns = struct.unpack(">Q", body[4:12])[0]
            yield offset, n
            offset += t.NEEDLE_HEADER_SIZE + len(body)


def fix_index(directory: str, volume_id: int, collection: str = "") -> int:
    """Rebuild the .idx by scanning the .dat (weed/command/fix.go:22).
    Returns the number of live entries written."""
    base = volume_base(directory, volume_id, collection)
    dat, idx = base + ".dat", base + ".idx"
    if not os.path.exists(dat):
        raise FileNotFoundError(dat)
    entries: dict[int, tuple[int, int]] = {}
    for offset, n in scan_dat_file(dat):
        if n.size > 0:
            entries[n.id] = (offset, n.size)
        else:
            entries.pop(n.id, None)
    tmp = idx + ".tmp"
    if os.path.exists(tmp):
        os.remove(tmp)
    w = IndexWriter(tmp)
    for key in entries:
        offset, size = entries[key]
        w.put(key, offset, size)
    w.flush()
    w.close()
    os.replace(tmp, idx)
    return len(entries)


def export_volume(directory: str, volume_id: int, collection: str = "",
                  output: str = "export.tar",
                  newer_than_ns: int = 0) -> int:
    """Write live needles to a tar (weed/command/export.go:41).  Entry names
    use the needle name when present, else the hex file id."""
    base = volume_base(directory, volume_id, collection)
    dat = base + ".dat"
    if not os.path.exists(dat):
        raise FileNotFoundError(dat)
    live: dict[int, int] = {}
    idx = base + ".idx"
    if os.path.exists(idx):
        for key, offset, size in walk_index_file(idx):
            if offset > 0 and not t.size_is_deleted(size):
                live[key] = offset
            else:
                live.pop(key, None)
    count = 0
    with tarfile.open(output, "w") as tar:
        for offset, n in scan_dat_file(dat):
            if n.size <= 0:
                continue
            if live and live.get(n.id) != offset:
                continue  # deleted or superseded
            if newer_than_ns and n.append_at_ns and n.append_at_ns < newer_than_ns:
                continue
            if n.has(FLAG_HAS_NAME) and n.name:
                name = n.name.decode(errors="replace")
            else:
                name = f"{volume_id}#{n.id:x}"
            info = tarfile.TarInfo(name=name)
            info.size = len(n.data)
            info.mtime = (n.append_at_ns // 1_000_000_000) or int(time.time())
            tar.addfile(info, io.BytesIO(bytes(n.data)))
            count += 1
    return count


def tail_watermark_ns(dat_path: str) -> int:
    """Max append_at_ns across a .dat (incl. tombstones) — the since_ns
    resume point for tail subscriptions and incremental backup."""
    import os as _os

    last = 0
    if _os.path.exists(dat_path):
        for _off, n in scan_dat_file(dat_path):
            last = max(last, n.append_at_ns)
    return last
