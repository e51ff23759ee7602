"""Request tracing + telemetry: spans, traceparent propagation, middleware.

The port's copy of seaweedfs_tpu/telemetry/__init__.py.

See trace.py (span recorder + W3C context) and middleware.py (the shared
HTTP request instrumentation used by master/volume/filer/S3).
"""

from . import trace  # noqa: F401
from .middleware import (  # noqa: F401
    DEBUG_FAULTS_PATH,
    DEBUG_HOT_PATH,
    DEBUG_PROFILE_HISTORY_PATH,
    DEBUG_PROFILE_PATH,
    DEBUG_TRACES_PATH,
    METRICS_PATH,
    SLOW_REQUEST_SECONDS,
    debug_traces_body,
    http_request,
    parse_trace_query,
    record_op,
    serve_debug_http,
)
from .trace import (  # noqa: F401
    TRACER,
    Span,
    Tracer,
    current_trace_id,
    inject_headers,
    parse_traceparent,
    remote_context,
    start_span,
    traceparent_header,
    wrap_context,
)

__all__ = [
    "TRACER", "Span", "Tracer", "current_trace_id", "inject_headers",
    "parse_traceparent", "remote_context", "start_span",
    "traceparent_header", "wrap_context", "http_request", "record_op",
    "debug_traces_body", "serve_debug_http", "parse_trace_query",
    "DEBUG_FAULTS_PATH", "DEBUG_HOT_PATH", "DEBUG_PROFILE_HISTORY_PATH",
    "DEBUG_PROFILE_PATH", "DEBUG_TRACES_PATH",
    "METRICS_PATH", "SLOW_REQUEST_SECONDS",
]
