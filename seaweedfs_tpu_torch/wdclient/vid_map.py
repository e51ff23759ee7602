"""vid -> locations cache with a round-robin read cursor.

The port's copy of seaweedfs_tpu/wdclient/vid_map.py.

Reference: weed/wdclient/vid_map.go:30-43 — a map of volume id to server
locations plus an atomic cursor so concurrent readers spread load across
replicas.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class Location:
    url: str
    public_url: str = ""


class VidMap:
    def __init__(self):
        self._locations: dict[int, list[Location]] = {}
        self._lock = threading.RLock()
        self._cursor = itertools.count()

    def lookup(self, vid: int) -> list[Location]:
        with self._lock:
            return list(self._locations.get(vid, ()))

    def pick(self, vid: int) -> Location | None:
        """Round-robin one location for a read."""
        with self._lock:
            locs = self._locations.get(vid)
            if not locs:
                return None
            return locs[next(self._cursor) % len(locs)]

    def add_location(self, vid: int, loc: Location) -> None:
        with self._lock:
            locs = self._locations.setdefault(vid, [])
            if all(l.url != loc.url for l in locs):
                locs.append(loc)

    def delete_location(self, vid: int, url: str) -> None:
        with self._lock:
            locs = self._locations.get(vid)
            if not locs:
                return
            locs[:] = [l for l in locs if l.url != url]
            if not locs:
                del self._locations[vid]

    def delete_volume(self, vid: int) -> None:
        with self._lock:
            self._locations.pop(vid, None)

    def delete_server(self, url: str) -> None:
        with self._lock:
            for vid in list(self._locations):
                self.delete_location(vid, url)

    def vids(self) -> list[int]:
        with self._lock:
            return list(self._locations)
