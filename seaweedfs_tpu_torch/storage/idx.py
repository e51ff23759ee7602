"""`.idx` index files: a flat log of 16-byte (key, offset, size) entries
(17 with 5-byte offsets) — the port's copy of seaweedfs_tpu/storage/idx.py.

Reference: weed/storage/idx/walk.go.  Offsets are stored /8; size -1 marks
deletion; a zero offset also deletes.  A torn trailing partial entry is
ignored.
"""

from __future__ import annotations

import io
import os
from typing import Callable, Iterator

import numpy as np

from . import types as t


def walk_index_blob(blob: bytes) -> Iterator[tuple[int, int, int]]:
    """Yield (key, actual_offset, size) for every whole entry."""
    n = len(blob) - (len(blob) % t.NEEDLE_MAP_ENTRY_SIZE)
    for i in range(0, n, t.NEEDLE_MAP_ENTRY_SIZE):
        yield t.unpack_index_entry(blob[i: i + t.NEEDLE_MAP_ENTRY_SIZE])


def walk_index_file(
    path: "str | os.PathLike",
    fn: "Callable[[int, int, int], None] | None" = None,
) -> list[tuple[int, int, int]]:
    """Walk a .idx file; returns entries (and calls fn per entry if given)."""
    out = []
    with open(path, "rb") as f:
        while True:
            chunk = f.read(t.NEEDLE_MAP_ENTRY_SIZE * 1024)
            if not chunk:
                break
            for e in walk_index_blob(chunk):
                if fn is not None:
                    fn(*e)
                out.append(e)
    return out


def parse_index_arrays(path: "str | os.PathLike"):
    """Vectorised parse of a whole .idx file -> (keys, offsets, sizes) numpy
    arrays (uint64, int64 actual bytes, int32).  Entry order preserved."""
    with open(path, "rb") as f:
        blob = f.read()
    esz = t.NEEDLE_MAP_ENTRY_SIZE
    n = len(blob) // esz
    raw = np.frombuffer(blob, dtype=np.uint8, count=n * esz).reshape(n, esz)
    # explicit big-endian dtypes keep this host-endianness-independent
    keys = raw[:, 0:8].copy().view(">u8").reshape(n).astype(np.uint64)
    off_end = 8 + t.OFFSET_SIZE
    stored = raw[:, 8:12].copy().view(">u4").reshape(n).astype(np.int64)
    if t.OFFSET_SIZE == 5:  # high byte appended after the BE lower word
        stored = stored | (raw[:, 12].astype(np.int64) << 32)
    offsets = stored * t.NEEDLE_PADDING_SIZE
    sizes = raw[:, off_end:off_end + 4].copy().view(">i4").reshape(n) \
        .astype(np.int32)
    return keys, offsets, sizes


def heal_index_tail(path: "str | os.PathLike") -> int:
    """Truncate a torn trailing PARTIAL entry (a crash mid-put leaves
    size % 16 != 0).  Readers already ignore the partial tail, but an
    append landing after it would misalign every later entry — so the
    writer path must drop it first.  -> the healed file size."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    healed = size - size % t.NEEDLE_MAP_ENTRY_SIZE
    if healed != size:
        with open(path, "r+b") as f:
            f.truncate(healed)
    return healed


def append_index_tombstone(path: "str | os.PathLike", key: int) -> None:
    """Record that `key`'s last index entry is dead (load-time healer:
    its .dat record was truncated away).  Without this, the stale entry
    would resurface on the NEXT load and claim whatever new record was
    appended at the reclaimed offset — truncating an acked write."""
    if not os.path.exists(path):
        return
    heal_index_tail(path)
    with open(path, "ab") as f:
        f.write(t.pack_index_entry(key, 0, t.TOMBSTONE_FILE_SIZE))
        f.flush()
        os.fsync(f.fileno())


class IndexWriter:
    """Append-only .idx writer.

    Every entry is flushed to the KERNEL immediately (no fsync): the
    .dat append reaches the page cache per write, and the load-time
    torn-tail healer treats unindexed .dat bytes as garbage — a
    userspace-buffered .idx lagging by many entries would turn a plain
    SIGTERM into real data loss.
    """

    def __init__(self, path: "str | os.PathLike"):
        self.path = os.fspath(path)
        heal_index_tail(self.path)  # never append after a torn entry
        self._f: io.BufferedWriter = open(path, "ab")

    def _write(self, entry: bytes) -> None:
        # the disk.write faultpoint family covers index appends too — a
        # torn .idx entry is exactly what a crash mid-put leaves, and the
        # loader must shrug it off (walk drops the partial tail)
        from .disk_health import inject_write_fault

        entry = inject_write_fault(self.path, self._f, self._f.tell(),
                                   entry)
        self._f.write(entry)
        self._f.flush()

    def put(self, key: int, actual_offset: int, size: int) -> None:
        self._write(t.pack_index_entry(key, actual_offset, size))

    def delete(self, key: int, actual_offset: int) -> None:
        """Tombstone entry: offset of the delete marker, size -1."""
        self._write(t.pack_index_entry(key, actual_offset,
                                       t.TOMBSTONE_FILE_SIZE))

    def tell(self) -> int:
        """Current append position (rollback point for a failed
        volume mutation)."""
        self._f.flush()
        return self._f.tell()

    def truncate(self, size: int) -> None:
        """Roll a failed append back to a previous tell()."""
        self._f.flush()
        self._f.truncate(size)
        self._f.seek(size)

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()
