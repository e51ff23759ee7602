"""Thread pools that report their own saturation — the port's copy of
seaweedfs_tpu/util/executors.py.

The EC read path fans remote interval fetches out to a shared pool, and the
rebuild reads its sources on one; without gauges a stalled stage shows
only as a throughput drop somewhere downstream.
`MeteredThreadPoolExecutor` is a drop-in
concurrent.futures.ThreadPoolExecutor that keeps three gauges per pool —

    seaweedfs_executor_queue_depth{executor}    submitted, not started
    seaweedfs_executor_active_workers{executor} running right now
    seaweedfs_executor_max_workers{executor}    capacity

so "is the pool the bottleneck" is `active == max and queue_depth > 0`
in PromQL instead of a guess.  The accounting wraps the submitted
callable (one int inc/dec either side of the call); overhead is two
lock-protected float adds per task, noise against any task that does
I/O.
"""

from __future__ import annotations

import concurrent.futures

from ..stats.metrics import (
    EXECUTOR_ACTIVE,
    EXECUTOR_MAX,
    EXECUTOR_QUEUE_DEPTH,
)


class MeteredThreadPoolExecutor(concurrent.futures.ThreadPoolExecutor):
    """ThreadPoolExecutor whose queue depth / active workers are gauges.

    `name` is the `executor` label value; instances sharing a name share
    the gauge children (intended for per-call pools like the rebuild's
    source readers, where the family tracks the stage, not the object).
    """

    def __init__(self, max_workers: int, name: str, **kwargs):
        super().__init__(max_workers=max_workers, **kwargs)
        self.name = name
        self._g_queue = EXECUTOR_QUEUE_DEPTH.labels(name)
        self._g_active = EXECUTOR_ACTIVE.labels(name)
        EXECUTOR_MAX.labels(name).set(max_workers)

    def submit(self, fn, /, *args, **kwargs):
        g_queue, g_active = self._g_queue, self._g_active

        def run(*a, **kw):
            g_queue.dec()
            g_active.inc()
            try:
                return fn(*a, **kw)
            finally:
                g_active.dec()

        g_queue.inc()
        try:
            fut = super().submit(run, *args, **kwargs)
        except BaseException:
            g_queue.dec()  # RuntimeError on a shut-down pool, etc.
            raise
        # a CANCELLED future never runs its callable, so run()'s dec never
        # fires — Executor.map cancels pending futures when the consumer
        # raises mid-iteration, which would leak queue_depth permanently
        fut.add_done_callback(
            lambda f: g_queue.dec() if f.cancelled() else None)
        return fut
