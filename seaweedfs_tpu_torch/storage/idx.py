"""`.idx` index files: a flat log of 16-byte (key, offset, size) entries —
the port's copy of the parser in seaweedfs_tpu/storage/idx.py.

Reference: weed/storage/idx/walk.go.  Offsets are stored /8; size -1 marks
deletion; a zero offset also deletes.  A torn trailing partial entry is
ignored.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from . import types as t


def walk_index_blob(blob: bytes) -> Iterator[tuple[int, int, int]]:
    """Yield (key, actual_offset, size) for every whole 16-byte entry."""
    n = len(blob) - (len(blob) % t.NEEDLE_MAP_ENTRY_SIZE)
    for i in range(0, n, t.NEEDLE_MAP_ENTRY_SIZE):
        yield t.unpack_index_entry(blob[i: i + t.NEEDLE_MAP_ENTRY_SIZE])


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
    stored = raw[:, 8:12].copy().view(">u4").reshape(n).astype(np.int64)
    offsets = stored * t.NEEDLE_PADDING_SIZE
    sizes = raw[:, 12:16].copy().view(">i4").reshape(n).astype(np.int32)
    return keys, offsets, sizes
