"""In-memory needle map: needle id -> (offset, size) — the port's copy of
the part of seaweedfs_tpu/storage/needle_map.py that builds `.ecx`.

The base tier is three parallel sorted numpy arrays (uint64 key, int64
offset, int32 size), recent mutations land in a small dict/set overflow,
and the tiers merge when the overflow reaches ``merge_threshold`` or the
sorted index is written.
"""

from __future__ import annotations

import os

import numpy as np

from . import idx as idx_mod
from . import types as t


class NeedleMap:
    """Live-needle map loadable from .idx, writable as the sorted .ecx."""

    def __init__(self, merge_threshold: int = 100_000) -> None:
        self._keys = np.empty(0, dtype=np.uint64)
        self._offsets = np.empty(0, dtype=np.int64)
        self._sizes = np.empty(0, dtype=np.int32)
        self._overflow: dict[int, tuple[int, int]] = {}
        self._overflow_deleted: set[int] = set()
        self._merge_threshold = merge_threshold

    def __len__(self) -> int:
        self._merge()
        return len(self._keys)

    def _base_find(self, key: int) -> int:
        """Index of key in the sorted base arrays, or -1."""
        if len(self._keys) == 0:
            return -1
        i = int(np.searchsorted(self._keys, np.uint64(key)))
        if i < len(self._keys) and int(self._keys[i]) == key:
            return i
        return -1

    def _live(self, key: int) -> bool:
        if key in self._overflow:
            return True
        return key not in self._overflow_deleted and self._base_find(key) >= 0

    def _maybe_merge(self) -> None:
        if len(self._overflow) + len(self._overflow_deleted) \
                >= self._merge_threshold:
            self._merge()

    def _merge(self) -> None:
        if not self._overflow and not self._overflow_deleted:
            return
        drop = self._overflow_deleted | set(self._overflow)
        keys, offsets, sizes = self._keys, self._offsets, self._sizes
        if len(keys) and drop:
            drop_arr = np.fromiter(drop, dtype=np.uint64, count=len(drop))
            pos = np.searchsorted(keys, drop_arr)
            pos = pos[pos < len(keys)]
            hit = pos[np.isin(keys[pos], drop_arr)]
            if len(hit):
                mask = np.ones(len(keys), dtype=bool)
                mask[hit] = False
                keys, offsets, sizes = keys[mask], offsets[mask], sizes[mask]
        if self._overflow:
            n = len(self._overflow)
            ins_k = np.fromiter(self._overflow.keys(), dtype=np.uint64, count=n)
            order = np.argsort(ins_k, kind="stable")
            ins_k = ins_k[order]
            vals = list(self._overflow.values())
            ins_o = np.asarray([vals[i][0] for i in order], dtype=np.int64)
            ins_s = np.asarray([vals[i][1] for i in order], dtype=np.int32)
            pos = np.searchsorted(keys, ins_k)
            keys = np.insert(keys, pos, ins_k)
            offsets = np.insert(offsets, pos, ins_o)
            sizes = np.insert(sizes, pos, ins_s)
        self._keys, self._offsets, self._sizes = keys, offsets, sizes
        self._overflow.clear()
        self._overflow_deleted.clear()

    def put(self, key: int, offset: int, size: int) -> None:
        self._overflow[key] = (offset, size)
        self._overflow_deleted.discard(key)
        self._maybe_merge()

    def delete(self, key: int) -> None:
        if not self._live(key):
            return
        self._overflow.pop(key, None)
        if self._base_find(key) >= 0:
            self._overflow_deleted.add(key)
            self._maybe_merge()

    @classmethod
    def load_from_idx(cls, path: "str | os.PathLike") -> "NeedleMap":
        """Replay a .idx file: tombstones/zero offsets delete, else insert
        (readNeedleMap, weed/storage/erasure_coding/ec_encoder.go).
        Pure-append files (no deletes, no overwrites — the common case)
        take a fully vectorised path; otherwise entries replay in order."""
        nm = cls()
        keys, offsets, sizes = idx_mod.parse_index_arrays(path)
        n = len(keys)
        if n == 0:
            return nm
        if bool((offsets != 0).all()) and bool((sizes > 0).all()) \
                and len(np.unique(keys)) == n:
            order = np.argsort(keys, kind="stable")
            nm._keys = keys[order].copy()
            nm._offsets = offsets[order].copy()
            nm._sizes = sizes[order].copy()
            return nm
        for i in range(n):
            key, offset, size = int(keys[i]), int(offsets[i]), int(sizes[i])
            if offset != 0 and not t.size_is_deleted(size):
                nm.put(key, offset, size)
            else:
                nm.delete(key)
        return nm

    def write_sorted_index(self, path: "str | os.PathLike") -> None:
        """Write entries in ascending key order (the .ecx format) — a
        vectorised big-endian pack of the merged base arrays."""
        self._merge()
        n = len(self._keys)
        out = np.empty((n, t.NEEDLE_MAP_ENTRY_SIZE), dtype=np.uint8)
        out[:, 0:8] = self._keys.astype(">u8")[:, None].view(np.uint8) \
            .reshape(n, 8)
        stored = self._offsets // t.NEEDLE_PADDING_SIZE
        out[:, 8:12] = (stored & 0xFFFFFFFF).astype(">u4")[:, None] \
            .view(np.uint8).reshape(n, 4)
        out[:, 12:16] = self._sizes.astype(np.uint32).astype(">u4")[:, None] \
            .view(np.uint8).reshape(n, 4)
        with open(path, "wb") as f:
            f.write(out.tobytes())
