"""Group-commit flush barrier: ONE fsync acks a whole batch of appends —
the port's copy of seaweedfs_tpu/storage/group_commit.py.

Durability modes for a Volume (``SEAWEEDFS_TPU_DURABILITY``):

  none   (default) today's behavior — mutations reach the kernel page
         cache per write, fsync only on explicit Volume.sync(); a crash
         can lose recently-acked writes (the torture harness acks after
         an explicit sync for exactly this reason).
  sync   strict strawman: every mutation pays its own fsync pair
         (.dat + .idx) before the ack.  Durable but serial — the A/B
         baseline the batch mode is measured against.
  batch  group commit: concurrent mutations land their bytes in the
         .dat/.idx under the volume lock, then park on this barrier.
         The first parker becomes the flush LEADER: it waits up to
         ``SEAWEEDFS_TPU_FSYNC_MAX_DELAY_MS`` (default ~2ms) for up to
         ``SEAWEEDFS_TPU_FSYNC_MAX_BATCH`` (default 64) mutations to
         accumulate, fsyncs the .dat and .idx ONCE, publishes every
         batched entry to the needle map in append order, and wakes the
         waiters.  No ack and no needle-map publish happen before the
         barrier's fsync — the durability contract (a crash loses only
         unacked writes; acked writes are remount-provable via the
         .idx) holds with N writers sharing one fsync.

Failure discipline: if the barrier's fsync fails, the WHOLE batch (plus
anything queued behind it — their bytes sit above the rollback point)
rolls back through Volume._fail_write: the .dat and .idx truncate to
the lowest pre-mutation positions, the error is classified
(DiskFullError/DiskFailingError), ENOSPC flips the volume
read-only-full, and every parked writer gets the typed error.  Nothing
was published, so no reader ever saw the rolled-back needles.
"""

from __future__ import annotations

import os
import threading
import time

from ..stats.metrics import (
    FSYNC_BATCH_COMMITS,
    FSYNC_BATCH_SIZE,
    FSYNC_BATCH_WRITES,
)
from ..util import glog

# a parked writer waits this long for its barrier before giving up: far
# above any sane fsync, so it only fires if the leader thread died
_PARK_TIMEOUT_S = 60.0


def batch_knobs() -> tuple[int, float]:
    """(max_batch, max_delay_seconds) from the env, clamped sane."""
    try:
        max_batch = int(os.environ.get("SEAWEEDFS_TPU_FSYNC_MAX_BATCH", "64"))
    except ValueError:
        max_batch = 64
    try:
        delay_ms = float(
            os.environ.get("SEAWEEDFS_TPU_FSYNC_MAX_DELAY_MS", "2"))
    except ValueError:
        delay_ms = 2.0
    return max(1, max_batch), max(0.0, delay_ms) / 1e3


class Pending:
    """One parked mutation: its publish thunk + rollback positions."""

    __slots__ = ("publish", "dat_start", "idx_start", "done", "error")

    def __init__(self, publish, dat_start: int, idx_start: int | None):
        self.publish = publish
        self.dat_start = dat_start
        self.idx_start = idx_start
        self.done = threading.Event()
        self.error: BaseException | None = None


class GroupCommitter:
    """Leader-elected flush barrier for one Volume."""

    def __init__(self, volume):
        self._volume = volume
        self.max_batch, self.max_delay = batch_knobs()
        self._cv = threading.Condition()
        self._queue: list[Pending] = []
        self._flushing = False

    def park(self, p: Pending) -> None:
        """Block until `p` is fsync-durable and published (or its batch
        rolled back, in which case the typed error re-raises here).
        Call with NO volume lock held — the whole point is that other
        writers append while this one waits."""
        with self._cv:
            self._queue.append(p)
            self._cv.notify()
            if not self._flushing:
                self._flushing = True
                leader = True
            else:
                leader = False
        if leader:
            self._lead()
        if not p.done.wait(_PARK_TIMEOUT_S):
            raise IOError(
                f"volume {self._volume.volume_id}: flush barrier timed out")
        if p.error is not None:
            raise p.error

    # -- leader -----------------------------------------------------------

    def _lead(self) -> None:
        v = self._volume
        while True:
            with self._cv:
                deadline = time.monotonic() + self.max_delay
                while len(self._queue) < self.max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
                batch = self._queue
                self._queue = []
            if batch:
                try:
                    v._dat.sync()
                    v._idx.flush()
                except (OSError, ValueError) as e:
                    # ValueError = fsync raced a handle swap/close; feed
                    # the health machine an EIO-shaped error either way
                    if not isinstance(e, OSError):
                        e = OSError(5, str(e))
                    self._fail(batch, e)
                else:
                    self._commit(batch)
            with self._cv:
                if not self._queue:
                    self._flushing = False
                    return
                # entries arrived during the fsync: run another round

    def _commit(self, batch: list[Pending]) -> None:
        with self._volume._lock:
            for p in batch:  # append order: later offsets win in the map
                try:
                    p.publish()
                except Exception as e:  # noqa: BLE001 — isolate waiters
                    p.error = e
        FSYNC_BATCH_COMMITS.inc()
        FSYNC_BATCH_WRITES.inc(len(batch))
        FSYNC_BATCH_SIZE.observe(len(batch))
        for p in batch:
            p.done.set()

    def _fail(self, batch: list[Pending], e: OSError) -> None:
        # anything queued behind the failed batch has bytes ABOVE the
        # rollback point — it must fail (and roll back) with it
        with self._cv:
            batch = batch + self._queue
            self._queue = []
        dat_start = min(p.dat_start for p in batch)
        idx_starts = [p.idx_start for p in batch if p.idx_start is not None]
        idx_start = min(idx_starts) if idx_starts else None
        v = self._volume
        glog.warning(
            "volume %d: group-commit fsync failed (%s); rolling back "
            "%d parked mutation(s) to dat=%d", v.volume_id, e,
            len(batch), dat_start)
        with v._lock:
            typed = v._fail_write(e, dat_start, idx_start)
        for p in batch:
            p.error = typed
            p.done.set()
