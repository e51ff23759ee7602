"""Process profiling status.

The port's copy of the part of seaweedfs_tpu/util/grace.py that
`/debug/profile?status=1` reads: `profile_status`.  The -cpuprofile and
-memprofile hooks (`setup_profiling`) come with the port's CLI.

Reference: weed/util/grace (the -cpuprofile/-memprofile flags every
server command exposes, command/volume.go:117-120).
"""

from __future__ import annotations

import cProfile

# armed by the CLI's -cpuprofile flag, which the port does not have yet
_cpu_profiler: cProfile.Profile | None = None


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
