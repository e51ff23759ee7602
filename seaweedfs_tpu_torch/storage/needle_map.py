"""In-memory needle maps: needle id -> (offset, size) — the port's copy of
seaweedfs_tpu/storage/needle_map.py (4-byte offsets only).

The reference's memory kind is a two-level compact map — sorted batched
arrays plus an overflow area, ~20 bytes/entry, rebuilt in 100k-entry
sections (weed/storage/needle_map/compact_map.go:28-50, with a 10M-entry
perf test).  The same shape here, vectorised: the base tier is three
parallel sorted numpy arrays (uint64 key, int64 offset, int32 size — 20
bytes/entry), recent mutations land in a small dict/set overflow, and the
tiers merge when the overflow reaches ``merge_threshold``.  Lookups check
the overflow then binary-search the base (np.searchsorted); iteration and
the `.ecx` writer force a merge and stream the arrays.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from . import idx as idx_mod
from . import types as t


@dataclass(frozen=True)
class NeedleValue:
    key: int
    offset: int  # actual byte offset
    size: int

    def to_index_bytes(self) -> bytes:
        return t.pack_index_entry(self.key, self.offset, self.size)


class NeedleMap:
    """Live-needle map with deleted-byte accounting, loadable from .idx."""

    def __init__(self, merge_threshold: int = 100_000) -> None:
        self._keys = np.empty(0, dtype=np.uint64)
        self._offsets = np.empty(0, dtype=np.int64)
        self._sizes = np.empty(0, dtype=np.int32)
        self._overflow: dict[int, tuple[int, int]] = {}
        self._overflow_deleted: set[int] = set()
        self._merge_threshold = merge_threshold
        self._live = 0
        self._content = 0
        self.file_count = 0
        self.deleted_count = 0
        self.deleted_bytes = 0
        self.maximum_key = 0

    # -- base-tier helpers -------------------------------------------------

    def _base_find(self, key: int) -> int:
        """Index of key in the sorted base arrays, or -1."""
        if len(self._keys) == 0:
            return -1
        i = int(np.searchsorted(self._keys, np.uint64(key)))
        if i < len(self._keys) and int(self._keys[i]) == key:
            return i
        return -1

    def _maybe_merge(self) -> None:
        if len(self._overflow) + len(self._overflow_deleted) >= self._merge_threshold:
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

    # -- mutation ---------------------------------------------------------

    def put(self, key: int, offset: int, size: int) -> None:
        old = self.get(key)
        if old is not None:
            if old.size > 0:
                self.deleted_count += 1
                self.deleted_bytes += old.size
                self._content -= old.size
        else:
            self._live += 1
        self._overflow[key] = (offset, size)
        self._overflow_deleted.discard(key)
        self.file_count += 1
        if size > 0:
            self._content += size
        if key > self.maximum_key:
            self.maximum_key = key
        self._maybe_merge()

    def delete(self, key: int) -> int:
        old = self.get(key)
        if old is None:
            return 0
        self.deleted_count += 1
        freed = max(old.size, 0)
        self.deleted_bytes += freed
        self._content -= freed
        self._live -= 1
        self._overflow.pop(key, None)
        if self._base_find(key) >= 0:
            self._overflow_deleted.add(key)
            self._maybe_merge()
        return freed

    # -- lookup -----------------------------------------------------------

    def get(self, key: int) -> NeedleValue | None:
        v = self._overflow.get(key)
        if v is not None:
            return NeedleValue(key, v[0], v[1])
        if key in self._overflow_deleted:
            return None
        i = self._base_find(key)
        if i < 0:
            return None
        return NeedleValue(key, int(self._offsets[i]), int(self._sizes[i]))

    def __contains__(self, key: int) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        return self._live

    @property
    def content_size(self) -> int:
        return self._content

    # -- iteration --------------------------------------------------------

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        for v in self.items_ascending():
            fn(v)

    def sorted_keys(self) -> list[int]:
        self._merge()
        return self._keys.tolist()

    def items_ascending(self) -> Iterator[NeedleValue]:
        self._merge()
        for i in range(len(self._keys)):
            yield NeedleValue(
                int(self._keys[i]), int(self._offsets[i]), int(self._sizes[i])
            )

    def next_key_after(self, key: int) -> int | None:
        self._merge()
        i = int(np.searchsorted(self._keys, np.uint64(key), side="right"))
        return int(self._keys[i]) if i < len(self._keys) else None

    # -- persistence ------------------------------------------------------

    @classmethod
    def load_from_idx(cls, path: str | os.PathLike) -> "NeedleMap":
        """Replay a .idx file: tombstones/zero offsets delete, else insert.

        Mirrors readNeedleMap in the reference ec_encoder.go:289-306.
        Pure-append files (no deletes, no overwrites — the common case) take
        a fully vectorised path; otherwise entries replay sequentially.
        """
        nm = cls()
        keys, offsets, sizes = idx_mod.parse_index_arrays(path)
        n = len(keys)
        if n == 0:
            return nm
        clean = (
            bool((offsets != 0).all())
            and bool((sizes > 0).all())
            and len(np.unique(keys)) == n
        )
        if clean:
            order = np.argsort(keys, kind="stable")
            nm._keys = keys[order].copy()
            nm._offsets = offsets[order].copy()
            nm._sizes = sizes[order].copy()
            nm._live = n
            nm.file_count = n
            nm._content = int(sizes.sum())
            nm.maximum_key = int(keys.max())
            return nm
        for i in range(n):
            key, offset, size = int(keys[i]), int(offsets[i]), int(sizes[i])
            if offset != 0 and not t.size_is_deleted(size):
                nm.put(key, offset, size)
            else:
                nm.delete(key)
        return nm

    def write_sorted_index(self, path: str | os.PathLike) -> None:
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
