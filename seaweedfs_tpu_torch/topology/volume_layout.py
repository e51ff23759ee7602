"""VolumeLayout: writable-volume tracking per (collection, rp, ttl).

Reference: weed/topology/volume_layout.go — tracks which vids are writable
(enough replicas, not oversized, not read-only) and where they live.

The port's copy of seaweedfs_tpu/topology/volume_layout.py.
"""

from __future__ import annotations

import random
import threading

from ..storage.replica_placement import ReplicaPlacement


class VolumeLayout:
    def __init__(self, rp: ReplicaPlacement, ttl: str,
                 volume_size_limit: int):
        self.rp = rp
        self.ttl = ttl
        self.volume_size_limit = volume_size_limit
        self.locations: dict[int, list[str]] = {}  # vid -> node ids
        self.writable: set[int] = set()
        self.readonly: set[int] = set()
        self.oversized: set[int] = set()
        self._lock = threading.RLock()
        self._rng = random.Random(0)

    def register(self, vid: int, node_id: str, size: int,
                 read_only: bool) -> None:
        with self._lock:
            locs = self.locations.setdefault(vid, [])
            if node_id not in locs:
                locs.append(node_id)
            if read_only:
                self.readonly.add(vid)
            else:
                self.readonly.discard(vid)
            if size >= self.volume_size_limit:
                self.oversized.add(vid)
            self._update_writable(vid)

    def unregister(self, vid: int, node_id: str) -> None:
        with self._lock:
            locs = self.locations.get(vid, [])
            if node_id in locs:
                locs.remove(node_id)
            if not locs:
                self.locations.pop(vid, None)
                self.writable.discard(vid)
            else:
                self._update_writable(vid)

    def _update_writable(self, vid: int) -> None:
        locs = self.locations.get(vid, [])
        ok = (
            len(locs) >= self.rp.copy_count()
            and vid not in self.readonly
            and vid not in self.oversized
        )
        if ok:
            self.writable.add(vid)
        else:
            self.writable.discard(vid)

    def pick_for_write(self) -> tuple[int, list[str]]:
        with self._lock:
            if not self.writable:
                raise LookupError("no writable volume")
            vid = self._rng.choice(sorted(self.writable))
            return vid, list(self.locations[vid])

    def set_oversized(self, vid: int, size: int) -> None:
        with self._lock:
            if size >= self.volume_size_limit:
                self.oversized.add(vid)
                self._update_writable(vid)

    def active_writable_count(self) -> int:
        with self._lock:
            return len(self.writable)
