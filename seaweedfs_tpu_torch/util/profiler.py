"""Sampling thread-stack profiler behind /debug/profile.

The port's copy of seaweedfs_tpu/util/profiler.py.

The previous /debug/profile was a status stub (rusage + thread count) —
useful for "is it big", useless for "where is the time going".  This is
the py-spy idea without the external process: `sys._current_frames()`
returns every thread's current frame for the cost of one dict build, so
sampling all stacks at ~100 Hz costs well under 5% of one core and needs
no signal handlers, no tracing hooks, and no stopping the world.

Output is flamegraph-collapsed format — one line per unique stack,
root;...;leaf count — feedable straight into flamegraph.pl / speedscope
/ inferno.  Sampling is capped (duration <= 60s, hz <= 250, one run at a
time process-wide) so a curious operator cannot turn the profiler into a
self-inflicted load test.

Two consumers share the stack walker:

  * on-demand runs (`sample_stacks`) — an operator asks for N seconds
    at up to 250 Hz, single-flight per process;
  * the flight recorder (`ContinuousProfiler`) — an always-on low-hz
    background sampler keeping a bounded ring of per-window collapsed
    deltas, so when an alert fires the minutes BEFORE it are already on
    record (`/debug/profile/history`).  It deliberately does not take
    `_RUN_LOCK`: at its default 7 Hz it does not disturb an on-demand
    run enough to matter, and pausing history during the one moment an
    operator is actively profiling would blind the recorder exactly
    when things are interesting.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque

# operator kill-switch: profiling only costs CPU (unlike /debug/faults,
# which mutates behavior and therefore needs opt-IN), so the sampler is
# on by default and this disables it fleet-wide when a deployment wants
# the surface closed
DISABLE_VAR = "SEAWEEDFS_TPU_PROFILER_DISABLED"


def enabled() -> bool:
    return os.environ.get(DISABLE_VAR, "") != "1"


MAX_DURATION_S = 60.0
MAX_HZ = 250
DEFAULT_DURATION_S = 2.0
DEFAULT_HZ = 99  # off the common 100 Hz timer beat, flamegraph folklore

# one sampler per process: two concurrent runs would halve each other's
# accuracy and double the overhead for no information gain
_RUN_LOCK = threading.Lock()


class ProfilerBusy(RuntimeError):
    pass


def _frame_stack(frame, max_depth: int = 64) -> str:
    """root;...;leaf collapsed-stack label for one thread's frame."""
    parts: list[str] = []
    while frame is not None and len(parts) < max_depth:
        code = frame.f_code
        module = frame.f_globals.get("__name__", "?")
        parts.append(f"{module}.{code.co_name}")
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


def sample_stacks(duration_s: float = DEFAULT_DURATION_S,
                  hz: int = DEFAULT_HZ) -> dict[str, int]:
    """Sample every thread's stack for `duration_s` at `hz`.

    -> {collapsed stack: samples}.  The sampling thread itself is
    excluded.  Raises ProfilerBusy when a run is already in flight and
    ValueError on out-of-range parameters (the endpoint's 400).
    """
    duration_s = float(duration_s)
    hz = int(hz)
    if not 0.0 < duration_s <= MAX_DURATION_S:
        raise ValueError(
            f"duration must be in (0, {MAX_DURATION_S:.0f}] seconds")
    if not 1 <= hz <= MAX_HZ:
        raise ValueError(f"hz must be in [1, {MAX_HZ}]")
    if not _RUN_LOCK.acquire(blocking=False):
        raise ProfilerBusy("a profile run is already in progress")
    try:
        counts: dict[str, int] = {}
        me = threading.get_ident()
        interval = 1.0 / hz
        deadline = time.perf_counter() + duration_s
        next_tick = time.perf_counter()
        while True:
            now = time.perf_counter()
            if now >= deadline:
                return counts
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                stack = _frame_stack(frame)
                if stack:
                    counts[stack] = counts.get(stack, 0) + 1
            # fixed cadence with drop-behind: if a sample ran long, skip
            # the missed ticks instead of bursting to catch up
            next_tick += interval
            now = time.perf_counter()
            if next_tick <= now:
                next_tick = now + interval
            time.sleep(max(0.0, min(next_tick, deadline) - now))
    finally:
        _RUN_LOCK.release()


def collapsed(counts: dict[str, int]) -> str:
    """Flamegraph-collapsed text: `stack count` lines, hottest first."""
    lines = [f"{stack} {n}" for stack, n in
             sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))]
    return "\n".join(lines) + ("\n" if lines else "")


def profile_collapsed(duration_s: float = DEFAULT_DURATION_S,
                      hz: int = DEFAULT_HZ) -> str:
    return collapsed(sample_stacks(duration_s, hz))


# -- continuous (flight-recorder) sampler ---------------------------------

# env knobs, read at construction so tests and bench A/B can retune them
# per-instance without a process restart
CONTINUOUS_HZ_VAR = "SEAWEEDFS_TPU_PROFILER_HZ"
CONTINUOUS_WINDOW_VAR = "SEAWEEDFS_TPU_PROFILER_WINDOW_S"
CONTINUOUS_RETAIN_VAR = "SEAWEEDFS_TPU_PROFILER_RETAIN"
DEFAULT_CONTINUOUS_HZ = 7        # low + off the 100 Hz beat; 0 disables
DEFAULT_CONTINUOUS_WINDOW_S = 10.0
DEFAULT_CONTINUOUS_RETAIN = 36   # 36 x 10s = 6 minutes of history
# per-window unique-stack bound: a pathological thread count cannot grow
# a window without limit; overflow collapses into one "(other)" bucket
MAX_WINDOW_STACKS = 512


def _env_float(var: str, default: float) -> float:
    try:
        return float(os.environ.get(var, "") or default)
    except ValueError:
        return default


class ContinuousProfiler:
    """Always-on low-hz sampler with a bounded ring of window deltas.

    Each window is an independent collapsed-stack histogram, so the ring
    reads as a time series of flamegraphs: "what was this process doing
    10s/60s/5min before the page".
    """

    def __init__(self, hz: float | None = None,
                 window_s: float | None = None,
                 retain: int | None = None):
        self.hz = _env_float(CONTINUOUS_HZ_VAR,
                             DEFAULT_CONTINUOUS_HZ) if hz is None else hz
        self.window_s = (_env_float(CONTINUOUS_WINDOW_VAR,
                                    DEFAULT_CONTINUOUS_WINDOW_S)
                         if window_s is None else window_s)
        retain = (int(_env_float(CONTINUOUS_RETAIN_VAR,
                                 DEFAULT_CONTINUOUS_RETAIN))
                  if retain is None else retain)
        self.hz = min(float(self.hz), float(MAX_HZ))
        self.window_s = max(0.05, float(self.window_s))
        self._windows: deque[dict] = deque(maxlen=max(1, retain))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._cur: dict[str, int] = {}
        self._cur_start = time.time()
        self._cur_samples = 0

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.hz <= 0 or self.running:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="profiler-continuous")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def _sample_once(self) -> None:
        me = threading.get_ident()
        sampler = self._thread.ident if self._thread else me
        for tid, frame in sys._current_frames().items():
            if tid in (me, sampler):
                continue
            stack = _frame_stack(frame)
            if not stack:
                continue
            if stack in self._cur or len(self._cur) < MAX_WINDOW_STACKS:
                self._cur[stack] = self._cur.get(stack, 0) + 1
            else:
                self._cur["(other)"] = self._cur.get("(other)", 0) + 1
        self._cur_samples += 1

    def _rotate(self, now: float) -> None:
        with self._lock:
            self._windows.append({
                "start": self._cur_start,
                "end": now,
                "samples": self._cur_samples,
                "collapsed": collapsed(self._cur),
            })
            self._cur = {}
            self._cur_start = now
            self._cur_samples = 0

    def _run(self) -> None:
        interval = 1.0 / self.hz
        window_end = time.time() + self.window_s
        while not self._stop.wait(interval):
            self._sample_once()
            now = time.time()
            if now >= window_end:
                self._rotate(now)
                window_end = now + self.window_s

    def history(self) -> dict:
        """JSON doc for /debug/profile/history: closed windows oldest
        first, plus the in-progress window (partial=True) — during an
        incident the current window is the one that matters."""
        with self._lock:
            windows = list(self._windows)
            if self._cur_samples:
                windows.append({
                    "start": self._cur_start,
                    "end": time.time(),
                    "samples": self._cur_samples,
                    "collapsed": collapsed(dict(self._cur)),
                    "partial": True,
                })
        return {
            "hz": self.hz,
            "windowS": self.window_s,
            "retain": self._windows.maxlen,
            "running": self.running,
            "windows": windows,
        }


_CONTINUOUS: ContinuousProfiler | None = None
_CONTINUOUS_LOCK = threading.Lock()


def ensure_continuous() -> ContinuousProfiler | None:
    """Start (or return) the process-wide continuous sampler.

    Idempotent — every server's start() calls it; the first call wins.
    Returns None when the kill-switch is set or hz is tuned to 0."""
    if not enabled():
        return None
    global _CONTINUOUS
    with _CONTINUOUS_LOCK:
        if _CONTINUOUS is None or not _CONTINUOUS.running:
            prof = ContinuousProfiler()
            if prof.hz <= 0:
                return None
            prof.start()
            _CONTINUOUS = prof
        return _CONTINUOUS


def stop_continuous() -> None:
    """Stop and forget the process-wide sampler (bench A/B, tests)."""
    global _CONTINUOUS
    with _CONTINUOUS_LOCK:
        if _CONTINUOUS is not None:
            _CONTINUOUS.stop()
            _CONTINUOUS = None


def continuous_history() -> dict:
    """The /debug/profile/history body, whether or not the sampler runs."""
    with _CONTINUOUS_LOCK:
        prof = _CONTINUOUS
    if prof is None:
        return {
            "hz": _env_float(CONTINUOUS_HZ_VAR, DEFAULT_CONTINUOUS_HZ),
            "windowS": _env_float(CONTINUOUS_WINDOW_VAR,
                                  DEFAULT_CONTINUOUS_WINDOW_S),
            "retain": int(_env_float(CONTINUOUS_RETAIN_VAR,
                                     DEFAULT_CONTINUOUS_RETAIN)),
            "running": False,
            "windows": [],
        }
    return prof.history()
