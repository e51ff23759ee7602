"""Process profiling hooks — the port's copy of seaweedfs_tpu/util/grace.py.

Reference: weed/util/grace (the -cpuprofile/-memprofile flags every
server command exposes, command/volume.go:117-120) plus the optional
net/http/pprof handlers.  Python equivalents: cProfile for CPU (pstats
dump written at exit) and tracemalloc for memory (top-allocations
snapshot at exit); `profile_status()` backs a /debug/profile endpoint.
"""

from __future__ import annotations

import atexit
import cProfile

_cpu_profiler: cProfile.Profile | None = None


def setup_profiling(cpuprofile: str = "", memprofile: str = "") -> None:
    """Arm CPU and/or memory profiling; results land in the given files
    when the process exits."""
    global _cpu_profiler
    if cpuprofile and _cpu_profiler is None:
        prof = cProfile.Profile()
        prof.enable()
        _cpu_profiler = prof

        def _dump_cpu() -> None:
            try:
                prof.disable()
            except Exception:
                pass
            prof.dump_stats(cpuprofile)

        atexit.register(_dump_cpu)
    if memprofile:
        import tracemalloc

        tracemalloc.start(25)

        def _dump_mem() -> None:
            snap = tracemalloc.take_snapshot()
            with open(memprofile, "w") as f:
                for stat in snap.statistics("lineno")[:100]:
                    f.write(f"{stat}\n")

        atexit.register(_dump_mem)


def profile_status() -> dict:
    """Live profiling numbers for a /debug endpoint."""
    import gc
    import resource
    import threading

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {
        "max_rss_kb": ru.ru_maxrss,
        "user_cpu_s": round(ru.ru_utime, 3),
        "system_cpu_s": round(ru.ru_stime, 3),
        "threads": threading.active_count(),
        "gc_objects": len(gc.get_objects()),
        "cpu_profiler_armed": _cpu_profiler is not None,
    }
    try:
        import tracemalloc

        if tracemalloc.is_tracing():
            current, peak = tracemalloc.get_traced_memory()
            out["traced_current_bytes"] = current
            out["traced_peak_bytes"] = peak
    except ImportError:
        pass
    return out
