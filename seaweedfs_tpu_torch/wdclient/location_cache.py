"""Tiered TTL cache for EC shard locations — the port's copy of
seaweedfs_tpu/wdclient/location_cache.py.

Reference: weed/storage/store_ec.go:223-264 (cachedLookupEcShardLocations)
keeps shard locations fresh on a tiered schedule instead of one flat TTL:
recently-confirmed locations are trusted for a while, EMPTY lookup results
are negative-cached only briefly (the shards may be mounting right now),
and a FAILED lookup serves stale data rather than silently returning
nothing — a dead master must degrade reads to "possibly stale", not
"volume vanished".
"""

from __future__ import annotations

import threading
import time
from typing import Callable

# lookup() -> {shard_id: [urls]}; raises on transport failure
LookupFn = Callable[[], "dict[int, list[str]]"]


class TieredLocationCache:
    """One instance caches the shard->locations map of a single EC volume.

    Tiers (seconds):
      found_ttl    — a lookup that returned locations is trusted this long
      empty_ttl    — a lookup that returned {} is negative-cached this long
      error_retry  — after a failed lookup, wait this long before retrying
                     (stale locations keep being served meanwhile)
    """

    def __init__(
        self,
        lookup: LookupFn,
        found_ttl: float = 300.0,
        empty_ttl: float = 11.0,
        error_retry: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._lookup = lookup
        self.found_ttl = found_ttl
        self.empty_ttl = empty_ttl
        self.error_retry = error_retry
        self._clock = clock
        self._lock = threading.Lock()
        self._locations: dict[int, list[str]] = {}
        self._fetched_at = float("-inf")  # last SUCCESSFUL lookup
        self._errored_at = float("-inf")  # last FAILED lookup
        self.lookups = 0  # successful upstream lookups (for tests/metrics)
        self.errors = 0

    def get(self) -> dict[int, list[str]]:
        with self._lock:
            now = self._clock()
            age = now - self._fetched_at
            ttl = self.found_ttl if self._locations else self.empty_ttl
            if age < ttl:
                return self._locations
            if now - self._errored_at < self.error_retry:
                return self._locations  # stale (or empty) until retry time
            try:
                fresh = self._lookup()
            except Exception:
                self.errors += 1
                self._errored_at = now
                return self._locations  # serve stale over nothing
            self.lookups += 1
            self._locations = fresh
            self._fetched_at = now
            return self._locations

    def invalidate(self) -> None:
        """Force the next get() to hit the upstream (e.g. after a fetch
        from a cached location failed — it may have moved)."""
        with self._lock:
            self._fetched_at = float("-inf")
            self._errored_at = float("-inf")
