"""Bounded LRUs of hot needles, of reconstructed EC shard intervals and
of the filer's chunks — the port's copy of
seaweedfs_tpu/util/chunk_cache.py.

Reference: weed/util/chunk_cache/chunk_cache.go:25 (TieredChunkCache) —
small chunks live in a memory LRU keyed by fid, which the filer's reads
consult before any volume-server round trip.  The reference's disk tier
(mount's ``-cacheDir``) is not ported yet: it comes with mount (ROADMAP
A-7b).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..stats.metrics import (
    CHUNK_CACHE_COUNTER,
    EC_INTERVAL_CACHE,
    NEEDLE_CACHE_EVICT,
    NEEDLE_CACHE_HIT,
    NEEDLE_CACHE_MISS,
)

# resolve the label-less children once: Metric.labels() takes the metric
# lock, and these fire on every needle read
_NC_HIT = NEEDLE_CACHE_HIT.labels()
_NC_MISS = NEEDLE_CACHE_MISS.labels()
_NC_EVICT = NEEDLE_CACHE_EVICT.labels()
_IC_HIT = EC_INTERVAL_CACHE.labels("hit")
_IC_MISS = EC_INTERVAL_CACHE.labels("miss")
_IC_EVICT = EC_INTERVAL_CACHE.labels("evict")


class MemoryChunkCache:
    """Byte-bounded LRU of fid -> chunk bytes."""

    def __init__(self, limit_bytes: int = 64 << 20,
                 max_entry_bytes: int = 4 << 20):
        self.limit = limit_bytes
        self.max_entry = max_entry_bytes
        self._lock = threading.Lock()
        self._data: OrderedDict[str, bytes] = OrderedDict()
        self._bytes = 0

    def get(self, fid: str) -> bytes | None:
        with self._lock:
            data = self._data.get(fid)
            if data is not None:
                self._data.move_to_end(fid)
            return data

    def set(self, fid: str, data: bytes) -> bool:
        if len(data) > self.max_entry or len(data) > self.limit:
            return False
        with self._lock:
            old = self._data.pop(fid, None)
            if old is not None:
                self._bytes -= len(old)
            self._data[fid] = data
            self._bytes += len(data)
            while self._bytes > self.limit and self._data:
                _, evicted = self._data.popitem(last=False)
                self._bytes -= len(evicted)
            return True

    def __len__(self) -> int:
        return len(self._data)


class NeedleCache:
    """Bytes-bounded LRU of hot needles on the volume-server read path.

    Keyed (volume_id, needle_id); values are whole parsed Needle objects
    (treated as immutable by every reader), so a hit skips the needle-map
    lookup, the disk read AND the header/CRC parse.  Writers invalidate
    per needle on every append/delete; vacuum and volume removal drop the
    whole volume's entries.  Same LRU-by-bytes discipline as
    MemoryChunkCache above, with its own metric family
    seaweedfs_needle_cache_{hit,miss,evict}_total.
    """

    def __init__(self, limit_bytes: int = 32 << 20,
                 max_entry_bytes: int = 1 << 20):
        self.limit = limit_bytes
        self.max_entry = max_entry_bytes
        self._lock = threading.Lock()
        self._data: OrderedDict[tuple[int, int], tuple] = OrderedDict()
        self._bytes = 0

    @staticmethod
    def _size_of(needle) -> int:
        # payload dominates; 64B covers header fields + dict slot
        return len(needle.data) + 64

    def get(self, vid: int, needle_id: int):
        with self._lock:
            entry = self._data.get((vid, needle_id))
            if entry is None:
                _NC_MISS.inc()
                return None
            self._data.move_to_end((vid, needle_id))
            _NC_HIT.inc()
            return entry[0]

    def put(self, vid: int, needle_id: int, needle) -> bool:
        size = self._size_of(needle)
        if size > self.max_entry or size > self.limit:
            return False
        with self._lock:
            old = self._data.pop((vid, needle_id), None)
            if old is not None:
                self._bytes -= old[1]
            self._data[(vid, needle_id)] = (needle, size)
            self._bytes += size
            while self._bytes > self.limit and self._data:
                _, (_n, sz) = self._data.popitem(last=False)
                self._bytes -= sz
                _NC_EVICT.inc()
            return True

    def invalidate(self, vid: int, needle_id: int) -> None:
        with self._lock:
            old = self._data.pop((vid, needle_id), None)
            if old is not None:
                self._bytes -= old[1]

    def drop_volume(self, vid: int) -> None:
        """Remove every cached needle of one volume (vacuum commit,
        volume delete/unmount — offsets and liveness may have changed
        wholesale)."""
        with self._lock:
            doomed = [k for k in self._data if k[0] == vid]
            for k in doomed:
                self._bytes -= self._data.pop(k)[1]

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes = 0

    def __len__(self) -> int:
        return len(self._data)


class IntervalCache:
    """Bytes-bounded LRU of RECONSTRUCTED EC shard intervals on the
    degraded-read path.

    Keyed (shard_id, offset, length); every entry carries the volume's
    invalidation token — (mount_seq, delete_seq) — captured BEFORE the
    gather that produced it.  A get with a newer token drops the entry
    (shard mount/unmount re-copies files wholesale; a delete bumps
    delete_seq), the same compare-before-publish discipline as the
    needle cache above.  Metric family
    seaweedfs_ec_interval_cache_total{result}.
    """

    def __init__(self, limit_bytes: int = 8 << 20,
                 max_entry_bytes: int = 1 << 20):
        self.limit = limit_bytes
        self.max_entry = max_entry_bytes
        self._lock = threading.Lock()
        self._data: OrderedDict[tuple, tuple[bytes, tuple]] = OrderedDict()
        self._bytes = 0

    def get(self, key: tuple, token: tuple) -> bytes | None:
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                _IC_MISS.inc()
                return None
            data, entry_token = entry
            if entry_token != token:
                # captured under an older shard layout / delete state
                self._bytes -= len(data)
                del self._data[key]
                _IC_MISS.inc()
                return None
            self._data.move_to_end(key)
            _IC_HIT.inc()
            return data

    def put(self, key: tuple, data: bytes, token: tuple) -> bool:
        if len(data) > self.max_entry or len(data) > self.limit:
            return False
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= len(old[0])
            self._data[key] = (data, token)
            self._bytes += len(data)
            while self._bytes > self.limit and self._data:
                _, (evicted, _t) = self._data.popitem(last=False)
                self._bytes -= len(evicted)
                _IC_EVICT.inc()
            return True

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes = 0

    def __len__(self) -> int:
        return len(self._data)


class TieredChunkCache:
    """The filer's fid-keyed chunk cache: the reference's memory tier.

    Chunks at or under ``mem_max_entry`` live in a bytes-bounded LRU.  The
    reference's disk tier serves mount's ``-cacheDir``; it comes with
    mount (ROADMAP A-7b).
    """

    def __init__(self, mem_limit_bytes: int = 64 << 20,
                 mem_max_entry: int = 1 << 20):
        self.mem = MemoryChunkCache(mem_limit_bytes, mem_max_entry)

    def get(self, fid: str) -> bytes | None:
        data = self.mem.get(fid)
        CHUNK_CACHE_COUNTER.labels(
            "hit" if data is not None else "miss"
        ).inc()
        return data

    def set(self, fid: str, data: bytes) -> None:
        self.mem.set(fid, data)
