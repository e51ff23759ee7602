"""Bounded LRU of reconstructed EC shard intervals — the port's copy of
`IntervalCache` from seaweedfs_tpu/util/chunk_cache.py (the needle and
chunk caches of that module belong to the servers and are not ported).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..stats.metrics import EC_INTERVAL_CACHE

# the children resolved once: labels() takes the metric's lock, and these
# fire on every degraded interval
_IC_HIT = EC_INTERVAL_CACHE.labels("hit")
_IC_MISS = EC_INTERVAL_CACHE.labels("miss")
_IC_EVICT = EC_INTERVAL_CACHE.labels("evict")


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
