"""Request instrumentation for the port's servers — the `record_op` part of
seaweedfs_tpu/telemetry/middleware.py, which pb/rpc.py wraps around every
unary rpc.  The HTTP half (`http_request`, the /debug paths) comes with the
volume server's HTTP side.

Every operation through `record_op` gets

  * seaweedfs_request_total{type,op}        (counter)
  * seaweedfs_request_seconds{type,op}      (latency histogram)
  * an active span (joined to the caller's trace via `traceparent`)
  * a slow-request glog line carrying the trace id when the operation
    exceeds SLOW_REQUEST_SECONDS
"""

from __future__ import annotations

from contextlib import contextmanager

from ..stats.metrics import REQUEST_COUNTER, REQUEST_HISTOGRAM
from ..util import glog
from . import trace

# one threshold for the slow-request log AND the tracer's important-span
# retention ring
SLOW_REQUEST_SECONDS = trace.SLOW_SPAN_SECONDS


@contextmanager
def record_op(server_type: str, op: str, **attrs):
    """Instrument one logical operation: counter + histogram + span."""
    REQUEST_COUNTER.labels(server_type, op).inc()
    hist = REQUEST_HISTOGRAM.labels(server_type, op)
    span = None
    try:
        with trace.start_span(f"{server_type}.{op}", **attrs) as span:
            yield span
    finally:
        if span is not None:
            hist.observe(span.duration)
            if span.duration >= SLOW_REQUEST_SECONDS:
                glog.warning(
                    "slow request %s.%s took %.3fs trace=%s",
                    server_type, op, span.duration, span.trace_id,
                )
