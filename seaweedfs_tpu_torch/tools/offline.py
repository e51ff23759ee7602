"""Offline volume tools: operate on `.dat`/`.idx` without a server — the
port's copy of `fix_index` from seaweedfs_tpu/tools/offline.py, which the
scrubber's index repair calls.

Reference: `weed fix` rebuilds a corrupted `.idx` by scanning the `.dat`
(weed/command/fix.go:22).  Not ported yet: `export_volume` and
`tail_watermark_ns` (they belong to the CLI and the servers).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

from ..storage import types as t
from ..storage.idx import IndexWriter
from ..storage.needle import Needle, body_length
from ..storage.super_block import SuperBlock


def volume_base(directory: str, volume_id: int, collection: str = "") -> str:
    name = f"{collection}_{volume_id}" if collection else str(volume_id)
    return os.path.join(directory, name)


def scan_dat_file(dat_path: str) -> Iterator[tuple[int, Needle]]:
    """Yield (offset, needle) for every record in a .dat, in file order.

    The reference's ScanVolumeFile walk (needle_read_write.go ReadNeedleHeader
    + body).  Tombstone records (size<0) are yielded too — callers decide.
    """
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
                # tombstone: checksum(4) + append_at_ns(8)
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
