"""Disk-backed needle map for RAM-constrained volume servers — the port's
copy of seaweedfs_tpu/storage/disk_needle_map.py.

Reference: weed/storage/needle_map.go:13-19 — the leveldb /
sorted-file NeedleMapKinds that keep the id->(offset,size) index OUT of
process memory.  This design is an own construction with the same
property: steady-state resident memory is a bounded overflow dict, not
20 bytes x needle count.

  * the base tier is a SORTED index file (`.sdx`, same record layout as
    `.idx`/`.ecx`) searched by on-disk binary search (the `.ecx` lookup
    discipline, ec_volume.go:225-250);
  * mutations land in a bounded in-RAM overflow (dict + tombstone set);
  * when the overflow exceeds `overflow_limit`, a STREAMING merge writes
    a new `.sdx.tmp` (sequential read of the old base against the sorted
    overflow) and atomically replaces the base — peak memory during the
    merge is the overflow, never the whole index.

Loading from a `.idx` log sorts once via the vectorised parser (transient
cost); thereafter the volume serves with O(overflow) resident memory.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator

from . import idx as idx_mod
from . import types as t
from .needle_map import NeedleValue


class DiskNeedleMap:
    """NeedleMap-compatible API; base tier on disk."""

    def __init__(self, sdx_path: str, overflow_limit: int = 10_000):
        self.sdx_path = sdx_path
        self.overflow_limit = overflow_limit
        self._overflow: dict[int, tuple[int, int]] = {}
        self._deleted: set[int] = set()
        self._f = None
        self._base_count = 0
        self.file_count = 0
        self.deleted_count = 0
        self.deleted_bytes = 0
        self.maximum_key = 0
        self._live = 0
        self._content = 0
        if not os.path.exists(sdx_path):
            open(sdx_path, "wb").close()
        self._open_base()

    def _open_base(self) -> None:
        if self._f:
            self._f.close()
        self._f = open(self.sdx_path, "rb")
        self._base_count = os.path.getsize(self.sdx_path) \
            // t.NEEDLE_MAP_ENTRY_SIZE

    # -- on-disk binary search (ec_volume.go:225-250 discipline) ----------

    def _base_read(self, i: int) -> tuple[int, int, int]:
        # positioned read: concurrent lookups share this handle
        esz = t.NEEDLE_MAP_ENTRY_SIZE
        return t.unpack_index_entry(os.pread(self._f.fileno(), esz, i * esz))

    def _base_get(self, key: int) -> tuple[int, int] | None:
        lo, hi = 0, self._base_count
        while lo < hi:
            mid = (lo + hi) // 2
            k, off, size = self._base_read(mid)
            if k == key:
                return (off, size)
            if k < key:
                lo = mid + 1
            else:
                hi = mid
        return None

    # -- mutation ----------------------------------------------------------

    def put(self, key: int, offset: int, size: int) -> None:
        old = self.get(key)
        if old is not None:
            self.deleted_count += 1
            self.deleted_bytes += max(old.size, 0)
            self._live -= 1
            self._content -= max(old.size, 0)
        self._overflow[key] = (offset, size)
        self._deleted.discard(key)
        self.file_count += 1
        self.maximum_key = max(self.maximum_key, key)
        self._live += 1
        self._content += max(size, 0)
        self._maybe_merge()

    def delete(self, key: int) -> int:
        nv = self.get(key)
        if nv is None:
            return 0
        self._overflow.pop(key, None)
        self._deleted.add(key)
        self.deleted_count += 1
        self.deleted_bytes += max(nv.size, 0)
        self._live -= 1
        self._content -= max(nv.size, 0)
        self._maybe_merge()
        return max(nv.size, 0)

    def get(self, key: int) -> NeedleValue | None:
        if key in self._deleted:
            return None
        hit = self._overflow.get(key)
        if hit is None:
            hit = self._base_get(key)
        if hit is None:
            return None
        return NeedleValue(key, hit[0], hit[1])

    def __contains__(self, key: int) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        return self._live

    @property
    def content_size(self) -> int:
        return self._content

    # -- streaming merge ----------------------------------------------------

    def _maybe_merge(self) -> None:
        if len(self._overflow) + len(self._deleted) > self.overflow_limit:
            self._merge()

    def _merge(self) -> None:
        tmp = self.sdx_path + ".tmp"
        with open(tmp, "wb") as out:
            for nv in self.items_ascending():
                out.write(t.pack_index_entry(nv.key, nv.offset, nv.size))
            out.flush()
            os.fsync(out.fileno())
        self._f.close()
        self._f = None
        os.replace(tmp, self.sdx_path)
        self._overflow.clear()
        self._deleted.clear()
        self._open_base()

    # -- iteration (merge of sorted base + sorted overflow) -----------------

    def items_ascending(self) -> Iterator[NeedleValue]:
        pending = sorted(self._overflow.items())
        pi = 0
        for i in range(self._base_count):
            k, off, size = self._base_read(i)
            while pi < len(pending) and pending[pi][0] < k:
                ok, (ooff, osize) = pending[pi]
                yield NeedleValue(ok, ooff, osize)
                pi += 1
            if pi < len(pending) and pending[pi][0] == k:
                ok, (ooff, osize) = pending[pi]
                yield NeedleValue(ok, ooff, osize)
                pi += 1
                continue
            if k in self._deleted:
                continue
            yield NeedleValue(k, off, size)
        while pi < len(pending):
            ok, (ooff, osize) = pending[pi]
            yield NeedleValue(ok, ooff, osize)
            pi += 1

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        for nv in self.items_ascending():
            fn(nv)

    def sorted_keys(self) -> list[int]:
        return [nv.key for nv in self.items_ascending()]

    def next_key_after(self, key: int) -> int | None:
        for nv in self.items_ascending():
            if nv.key > key:
                return nv.key
        return None

    def write_sorted_index(self, path: str | os.PathLike) -> None:
        with open(path, "wb") as out:
            for nv in self.items_ascending():
                out.write(t.pack_index_entry(nv.key, nv.offset, nv.size))

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    # -- construction --------------------------------------------------------

    @classmethod
    def load_from_idx(cls, idx_path: str | os.PathLike,
                      sdx_path: str | None = None,
                      overflow_limit: int = 10_000) -> "DiskNeedleMap":
        """Replay the append-ordered .idx into a fresh sorted base.

        The sort itself is the vectorised in-memory pass (transient);
        serving memory afterwards is O(overflow_limit)."""
        idx_path = str(idx_path)
        if sdx_path is None:
            sdx_path = idx_path[: -len(".idx")] + ".sdx" \
                if idx_path.endswith(".idx") else idx_path + ".sdx"
        from .needle_map import NeedleMap

        mem = NeedleMap.load_from_idx(idx_path)
        mem.write_sorted_index(sdx_path)
        m = cls(sdx_path, overflow_limit=overflow_limit)
        m.file_count = mem.file_count
        m.deleted_count = mem.deleted_count
        m.deleted_bytes = mem.deleted_bytes
        m.maximum_key = mem.maximum_key
        m._live = len(mem)
        m._content = mem.content_size
        return m
