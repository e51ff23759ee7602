"""Bounded LRUs of hot needles and of reconstructed EC shard intervals —
the port's copy of `NeedleCache` and `IntervalCache` from
seaweedfs_tpu/util/chunk_cache.py (its fid-keyed chunk caches belong to
the filer and the gateways and are not ported yet).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..stats.metrics import (
    EC_INTERVAL_CACHE,
    NEEDLE_CACHE_EVICT,
    NEEDLE_CACHE_HIT,
    NEEDLE_CACHE_MISS,
)

# the children resolved once: labels() takes the metric's lock, and these
# fire on every needle read and degraded interval
_NC_HIT = NEEDLE_CACHE_HIT.labels()
_NC_MISS = NEEDLE_CACHE_MISS.labels()
_NC_EVICT = NEEDLE_CACHE_EVICT.labels()
_IC_HIT = EC_INTERVAL_CACHE.labels("hit")
_IC_MISS = EC_INTERVAL_CACHE.labels("miss")
_IC_EVICT = EC_INTERVAL_CACHE.labels("evict")


class NeedleCache:
    """Bytes-bounded LRU of hot needles on the volume-server read path.

    Keyed (volume_id, needle_id); values are whole parsed Needle objects
    (treated as immutable by every reader), so a hit skips the needle-map
    lookup, the disk read AND the header/CRC parse.  Writers invalidate
    per needle on every append/delete; vacuum and volume removal drop the
    whole volume's entries.  LRU by bytes, with its own metric family
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
