"""Heavy-hitter attribution: which keys are hot RIGHT NOW.

The port's copy of seaweedfs_tpu/telemetry/hotkeys.py.

Every real incident on a blob store starts with the same question —
*which needle / bucket / tenant / client is doing this to us* — and
counters can't answer it without unbounded per-key label cardinality.
The space-saving sketch (Metwally et al., "Efficient Computation of
Frequent and Top-k Elements in Data Streams") answers it in O(k)
memory: track at most k counters; on a miss, evict the minimum counter
and inherit its count as the new key's overestimation error.  Any key
whose true frequency exceeds N/k is guaranteed to be present, and every
reported count is exact to within its per-key `error`.

One `HotKeyRecorder` per process holds a sketch per dimension over a
rolling window (current + previous, so a reader always sees one fully
closed window).  Feeds are one call per request from the existing
handler paths:

    needle — volume server GET/POST/DELETE fid
    bucket — S3 gateway request routing
    tenant — filer admission (tenant_for_path)
    peer   — request middleware (client address, every server type)

Surfaces: `/debug/hot` per node, `GET /cluster/hot` federated on the
master, `seaweedfs_hotkey_*` metric families, and the hot-key section
of flight-recorder debug bundles.
"""

from __future__ import annotations

import heapq
import os
import threading
import time

from ..stats.metrics import HOTKEY_EVENTS, HOTKEY_TOP, HOTKEY_TRACKED

DIMENSIONS = ("needle", "bucket", "tenant", "peer")

# kill-switch mirrors the profiler's polarity: attribution only costs a
# little CPU, so it is on by default and =0 closes it fleet-wide
DISABLE_VAR = "SEAWEEDFS_TPU_HOTKEYS"
K_VAR = "SEAWEEDFS_TPU_HOTKEYS_K"
WINDOW_VAR = "SEAWEEDFS_TPU_HOTKEYS_WINDOW_S"
DEFAULT_K = 64
DEFAULT_WINDOW_S = 60.0
# per-key gauge children published per dimension per window — the hard
# cardinality bound on the seaweedfs_hotkey_top_count family
TOP_GAUGE_KEYS = 10


def enabled() -> bool:
    return os.environ.get(DISABLE_VAR, "") != "0"


def _env_num(var: str, default: float) -> float:
    try:
        return float(os.environ.get(var, "") or default)
    except ValueError:
        return default


class SpaceSaving:
    """Bounded top-k frequency sketch.  Not thread-safe; the recorder
    serializes access.

    Eviction uses a lazy min-heap: every count update pushes a fresh
    (count, key) entry and leaves the old one stale; a miss pops until
    the top entry matches the live count — that key is the true minimum
    (every live count has an entry, smaller stale ones are skipped).
    Misses cost O(log k) amortized instead of an O(k) scan, which is
    what keeps the all-miss feed (distinct needle ids on every request)
    inside the flight recorder's <3% overhead budget."""

    __slots__ = ("k", "_counts", "_errors", "_heap")

    def __init__(self, k: int):
        self.k = max(1, int(k))
        self._counts: dict[str, int] = {}
        self._errors: dict[str, int] = {}
        self._heap: list[tuple[int, str]] = []

    def __len__(self) -> int:
        return len(self._counts)

    def record(self, key: str, n: int = 1) -> None:
        counts = self._counts
        cur = counts.get(key)
        if cur is not None:
            counts[key] = cur + n
            heapq.heappush(self._heap, (cur + n, key))
        elif len(counts) < self.k:
            counts[key] = n
            self._errors[key] = 0
            heapq.heappush(self._heap, (n, key))
        else:
            # evict the minimum; the newcomer inherits its count as error
            heap = self._heap
            while True:
                c, victim = heap[0]
                if counts.get(victim) == c:
                    break
                heapq.heappop(heap)  # stale entry
            floor = counts.pop(victim)
            self._errors.pop(victim, None)
            heapq.heapreplace(heap, (floor + n, key))
            counts[key] = floor + n
            self._errors[key] = floor
        # bound the stale backlog: rebuild from live counts when the
        # heap outgrows the sketch by a constant factor
        if len(self._heap) > 8 * self.k:
            self._heap = [(c, k) for k, c in counts.items()]
            heapq.heapify(self._heap)

    def top(self, n: int | None = None) -> list[dict]:
        items = sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if n is not None:
            items = items[:n]
        return [{"key": k, "count": c, "error": self._errors.get(k, 0)}
                for k, c in items]


class HotKeyRecorder:
    """Per-dimension rolling-window sketches behind one cheap lock."""

    def __init__(self, k: int | None = None,
                 window_s: float | None = None):
        self.k = int(_env_num(K_VAR, DEFAULT_K)) if k is None else int(k)
        self.window_s = (_env_num(WINDOW_VAR, DEFAULT_WINDOW_S)
                         if window_s is None else float(window_s))
        self.window_s = max(0.05, self.window_s)
        self._lock = threading.Lock()
        self._cur = {d: SpaceSaving(self.k) for d in DIMENSIONS}
        self._prev = {d: SpaceSaving(self.k) for d in DIMENSIONS}
        self._window_start = time.time()
        # resolved counter children: skips the labels() lookup on the
        # per-request hot path
        self._events = {d: HOTKEY_EVENTS.labels(d) for d in DIMENSIONS}

    def record(self, dim: str, key: str, n: int = 1) -> None:
        if not key or dim not in self._cur:
            return
        with self._lock:
            now = time.time()
            if now - self._window_start >= self.window_s:
                self._rotate_locked(now)
            self._cur[dim].record(str(key), n)
        self._events[dim].inc(n)

    def _rotate_locked(self, now: float) -> None:
        # the closing window becomes the readable "previous"; its top
        # keys replace the per-key gauge children wholesale, so the
        # family's cardinality stays <= dims * TOP_GAUGE_KEYS forever
        self._prev = self._cur
        self._cur = {d: SpaceSaving(self.k) for d in DIMENSIONS}
        self._window_start = now
        with HOTKEY_TOP._lock:
            HOTKEY_TOP._children.clear()
        for dim, sketch in self._prev.items():
            HOTKEY_TRACKED.labels(dim).set(len(sketch))
            for entry in sketch.top(TOP_GAUGE_KEYS):
                HOTKEY_TOP.labels(dim, entry["key"]).set(entry["count"])

    def snapshot(self, n: int = 32) -> dict:
        """JSON doc for /debug/hot: current (in-progress) and previous
        (closed) window top keys per dimension."""
        with self._lock:
            now = time.time()
            if now - self._window_start >= self.window_s:
                self._rotate_locked(now)
            doc = {
                "enabled": enabled(),
                "k": self.k,
                "windowS": self.window_s,
                "windowAgeS": now - self._window_start,
                "dims": {
                    d: {
                        "current": self._cur[d].top(n),
                        "previous": self._prev[d].top(n),
                    }
                    for d in DIMENSIONS
                },
            }
        return doc


_RECORDER: HotKeyRecorder | None = None
_RECORDER_LOCK = threading.Lock()


def recorder() -> HotKeyRecorder:
    global _RECORDER
    r = _RECORDER
    if r is None:
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = HotKeyRecorder()
            r = _RECORDER
    return r


def reset() -> None:
    """Drop the process singleton (tests / bench A-B re-read the env)."""
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = None


def record(dim: str, key: str, n: int = 1) -> None:
    """The hot-path feed: no-op when the kill-switch is set."""
    if not enabled():
        return
    recorder().record(dim, key, n)


def snapshot(n: int = 32) -> dict:
    return recorder().snapshot(n)
