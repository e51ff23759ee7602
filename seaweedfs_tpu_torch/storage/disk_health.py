"""Disk-fault survival plane: typed I/O failure classification + the
per-data-directory health state machine — the port's copy of
seaweedfs_tpu/storage/disk_health.py.

The dominant real-world disk failure is not a clean node death but a
device that fills up (ENOSPC) or starts throwing EIO while the process
stays alive (arXiv:1709.05365 measures device-level degradation
dominating online-EC SSD arrays).  This module is the one place that
knows how to tell those apart:

  * **Typed errors** — `DiskFullError` (out of space: the volume flips
    read-only-full and the client re-assigns on a 409) vs
    `DiskFailingError` (device errors: the disk becomes an evacuation
    candidate before it dies, arXiv:1309.0186's motivation).
  * **State machine** — per `DiskLocation` directory:
    ``healthy -> low_space -> full`` driven by statvfs watermark polling
    (`SEAWEEDFS_TPU_MIN_FREE_MB` / `SEAWEEDFS_TPU_MIN_FREE_PERCENT`),
    plus ``failing`` once a decayed EIO counter crosses
    `SEAWEEDFS_TPU_EIO_THRESHOLD`.  `failing` is sticky (a device that
    threw K I/O errors is not trusted again just because one write
    succeeded); `full` clears as soon as the watermark does.
  * **`disk.write` faultpoint family** — error / enospc / partial /
    short, fired at the backend layer (`backend.DiskFile.write_at`) so
    chaos tests and the crash-torture harness can produce exactly the
    torn-tail states a real ENOSPC/EIO mid-blob write leaves behind.
  * **statvfs dedupe** — `disk_stats()` is the one statvfs wrapper
    (grpc VolumeServerStatus and the heartbeat both use it).

Gauges: seaweedfs_disk_{free,total}_bytes{dir} + seaweedfs_disk_state{dir}
(0=healthy 1=low_space 2=full 3=failing), refreshed by every poll().
"""

from __future__ import annotations

import errno
import os
import threading

from ..stats.metrics import (
    DISK_FREE_GAUGE,
    DISK_STATE_GAUGE,
    DISK_TOTAL_GAUGE,
    DISK_WRITE_ERROR,
)
from ..util import faultpoint, glog

MIN_FREE_MB_ENV = "SEAWEEDFS_TPU_MIN_FREE_MB"
MIN_FREE_PERCENT_ENV = "SEAWEEDFS_TPU_MIN_FREE_PERCENT"
EIO_THRESHOLD_ENV = "SEAWEEDFS_TPU_EIO_THRESHOLD"

# low-space warns this many times earlier than full: the lifecycle plane
# gets a window to vacuum/tier before writers hit the hard watermark
LOW_SPACE_FACTOR = 4.0

STATES = ("healthy", "low_space", "full", "failing")
STATE_CODE = {s: i for i, s in enumerate(STATES)}

# the `disk.write` faultpoint family, fired by DiskFile.write_at.
# ctx is the file path, so `match=` scopes a fault to one data dir
# (one volume server among several in a test process).
FP_WRITE_ERROR = faultpoint.register("disk.write.error")
FP_WRITE_ENOSPC = faultpoint.register("disk.write.enospc")
FP_WRITE_PARTIAL = faultpoint.register("disk.write.partial")
FP_WRITE_SHORT = faultpoint.register("disk.write.short")

_ENOSPC_ERRNOS = (errno.ENOSPC, errno.EDQUOT)


class DiskFullError(OSError):
    """Out of space (ENOSPC/EDQUOT or watermark): the volume is
    read-only-full; clients should re-assign, not retry here."""


class DiskFailingError(OSError):
    """Device-level write failure (EIO class): the disk may be dying —
    repeated occurrences make the location an evacuation candidate."""


def is_enospc(exc: BaseException) -> bool:
    return (isinstance(exc, OSError)
            and getattr(exc, "errno", None) in _ENOSPC_ERRNOS)


def classify_write_error(exc: OSError, path: str = "") -> OSError:
    """-> the typed error to raise for a storage-write OSError (counted
    in seaweedfs_disk_write_errors_total)."""
    if isinstance(exc, (DiskFullError, DiskFailingError)):
        return exc
    if is_enospc(exc):
        DISK_WRITE_ERROR.labels("enospc").inc()
        return DiskFullError(
            errno.ENOSPC, f"disk full writing {path or '?'}: {exc}")
    kind = "eio" if getattr(exc, "errno", None) == errno.EIO else "other"
    DISK_WRITE_ERROR.labels(kind).inc()
    e = DiskFailingError(
        getattr(exc, "errno", None) or errno.EIO,
        f"disk write failed on {path or '?'}: {exc}")
    return e


def disk_stats(directory: str):
    """-> (total_bytes, free_bytes) of the filesystem holding
    `directory` — the ONE statvfs wrapper (heartbeat, grpc status and
    the watermark poll all go through here)."""
    st = os.statvfs(directory)
    return st.f_blocks * st.f_frsize, st.f_bavail * st.f_frsize


def inject_write_fault(path: str, f, offset: int, data: bytes) -> bytes:
    """Fire the `disk.write` faultpoint family for a write of `data` at
    `offset` of file object `f` (path is the match context).

    - ``disk.write.error``   -> OSError(EIO) before any byte lands
    - ``disk.write.enospc``  -> writes a TORN half, then OSError(ENOSPC)
      (the mid-blob short write a filling disk actually produces)
    - ``disk.write.partial`` -> writes a torn half, then OSError(EIO)
    - ``disk.write.short``   -> returns a truncated buffer to write
      silently (arm with mode=partial; models a lying device)

    Returns the (possibly truncated) data the caller should write."""
    if not faultpoint.FAULTS._armed:  # same fast path as inject()
        return data
    try:
        faultpoint.inject(FP_WRITE_ERROR, ctx=path)
    except faultpoint.FaultInjected as e:
        raise OSError(errno.EIO, f"injected EIO on {path}") from e
    for point, err in ((FP_WRITE_ENOSPC, errno.ENOSPC),
                       (FP_WRITE_PARTIAL, errno.EIO)):
        try:
            faultpoint.inject(point, ctx=path)
        except faultpoint.FaultInjected as e:
            torn = data[: len(data) // 2]
            if torn:
                f.seek(offset)
                f.write(torn)
                f.flush()
            raise OSError(err, os.strerror(err) + f" (injected, {path})"
                          ) from e
    out = faultpoint.inject(FP_WRITE_SHORT, ctx=path, data=data)
    return data if out is None else out


class DiskHealth:
    """Health state for one data directory.

    Thread-safe; poll() is called from the heartbeat cadence (and after
    any classified write error), write errors are recorded from the
    volume write path."""

    def __init__(self, directory: str, min_free_mb: float | None = None,
                 min_free_percent: float | None = None,
                 eio_threshold: float | None = None,
                 statvfs=None):
        self.directory = directory
        if min_free_mb is None:
            min_free_mb = float(os.environ.get(MIN_FREE_MB_ENV, "64"))
        if min_free_percent is None:
            min_free_percent = float(
                os.environ.get(MIN_FREE_PERCENT_ENV, "1"))
        if eio_threshold is None:
            eio_threshold = float(os.environ.get(EIO_THRESHOLD_ENV, "3"))
        self.min_free_bytes = int(min_free_mb * (1 << 20))
        self.min_free_percent = min_free_percent
        self.eio_threshold = eio_threshold
        self._statvfs = statvfs or disk_stats
        self._lock = threading.Lock()
        self._eio_score = 0.0
        self._saw_enospc = False
        self._state = "healthy"
        self.free_bytes = 0
        self.total_bytes = 0

    # -- watermarks -------------------------------------------------------

    def _floor(self, total: int) -> int:
        return max(self.min_free_bytes,
                   int(total * self.min_free_percent / 100.0))

    def poll(self) -> str:
        """Refresh statvfs + gauges; -> the current state."""
        try:
            total, free = self._statvfs(self.directory)
        except OSError as e:
            # the filesystem itself errors: that IS a failing disk
            glog.warning("disk health: statvfs %s failed: %s",
                         self.directory, e)
            with self._lock:
                self._eio_score = max(self._eio_score, self.eio_threshold)
            return self._set_state()
        with self._lock:
            self.total_bytes = total
            self.free_bytes = free
            if self._saw_enospc and free > self._floor(total):
                # space came back (vacuum/ttl/operator): trust statvfs
                self._saw_enospc = False
        state = self._set_state()
        DISK_FREE_GAUGE.labels(self.directory).set(free)
        DISK_TOTAL_GAUGE.labels(self.directory).set(total)
        return state

    def _set_state(self) -> str:
        with self._lock:
            floor = self._floor(self.total_bytes)
            if self._eio_score >= self.eio_threshold:
                state = "failing"  # sticky: cleared only by mark_repaired
            elif self._saw_enospc or (
                    self.total_bytes and self.free_bytes <= floor):
                state = "full"
            elif (self.total_bytes
                    and self.free_bytes <= floor * LOW_SPACE_FACTOR):
                state = "low_space"
            else:
                state = "healthy"
            if state != self._state:
                glog.warning(
                    "disk %s: %s -> %s (free=%dMB floor=%dMB eio=%.1f)",
                    self.directory, self._state, state,
                    self.free_bytes >> 20, floor >> 20, self._eio_score)
            self._state = state
        DISK_STATE_GAUGE.labels(self.directory).set(STATE_CODE[state])
        return state

    # -- write-error feedback --------------------------------------------

    def record_write_error(self, exc: BaseException) -> None:
        """Feed a classified write failure into the state machine."""
        with self._lock:
            if is_enospc(exc) or isinstance(exc, DiskFullError):
                self._saw_enospc = True
            else:
                # decayed counter, not consecutive: a disk alternating
                # ok/EIO still crosses the threshold
                self._eio_score += 1.0
        self._set_state()

    def record_write_ok(self) -> None:
        with self._lock:
            if self._eio_score and self._eio_score < self.eio_threshold:
                self._eio_score = max(0.0, self._eio_score - 0.05)

    def mark_repaired(self) -> None:
        """Operator reset after a disk was replaced/repaired."""
        with self._lock:
            self._eio_score = 0.0
            self._saw_enospc = False
        self.poll()

    # -- views ------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def writable(self) -> bool:
        return self.state not in ("full", "failing")

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "dir": self.directory,
                "state": self._state,
                "free_bytes": self.free_bytes,
                "total_bytes": self.total_bytes,
                "eio_score": round(self._eio_score, 2),
            }
