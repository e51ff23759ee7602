"""Shared request instrumentation for the four HTTP server types.

The port's copy of seaweedfs_tpu/telemetry/middleware.py.

One code path replaces the previous ad-hoc `REQUEST_COUNTER.labels(...)`
call sites: every request through `http_request` / `record_op` gets,
uniformly,

  * seaweedfs_request_total{type,op}        (counter)
  * seaweedfs_request_seconds{type,op}      (latency histogram)
  * an active span (joined to the caller's trace via `traceparent`)
  * a slow-request glog line carrying the trace id when the request
    exceeds SLOW_REQUEST_SECONDS

so the master, volume, filer and S3 gateways cannot drift apart in what
they measure (the pre-refactor state: master assign counted but never
timed, filer counted but never timed, volume did both by hand).
"""

from __future__ import annotations

from contextlib import contextmanager

from ..stats.metrics import REQUEST_COUNTER, REQUEST_HISTOGRAM
from ..util import glog
from . import trace

# one threshold for the slow-request log AND the tracer's important-span
# retention ring (defined in trace.py so the tracer needs no import from
# here)
SLOW_REQUEST_SECONDS = trace.SLOW_SPAN_SECONDS

DEBUG_TRACES_PATH = "/debug/traces"
DEBUG_FAULTS_PATH = "/debug/faults"
DEBUG_PROFILE_PATH = "/debug/profile"
DEBUG_PROFILE_HISTORY_PATH = "/debug/profile/history"
DEBUG_HOT_PATH = "/debug/hot"
METRICS_PATH = "/metrics"

TRACE_LIMIT_MAX = 1000


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
            # the span's trace id rides along as the histogram exemplar:
            # the slowest sample per bucket window keeps its trace id, so
            # a firing latency alert links straight to a timeline
            hist.observe(span.duration, trace_id=span.trace_id)
            if span.duration >= SLOW_REQUEST_SECONDS:
                glog.warning(
                    "slow request %s.%s took %.3fs trace=%s",
                    server_type, op, span.duration, span.trace_id,
                )


@contextmanager
def http_request(handler, server_type: str, op: str):
    """`record_op` for a BaseHTTPRequestHandler request: adopts the
    caller's `traceparent` (if any) so the span joins their trace."""
    incoming = handler.headers.get(trace.TRACEPARENT)
    # heavy-hitter attribution: every HTTP request feeds the peer-IP
    # sketch, so "which client is hammering us" is answerable on any
    # server type without per-handler wiring
    addr = getattr(handler, "client_address", None)
    if addr:
        from . import hotkeys

        hotkeys.record("peer", addr[0])
    with trace.remote_context(incoming):
        with record_op(
            server_type, op,
            method=handler.command, path=handler.path.split("?")[0],
        ) as span:
            yield span


def debug_traces_body(limit: int = 50, trace_id: str | None = None) -> bytes:
    """JSON body for GET /debug/traces on any server."""
    return trace.TRACER.traces_json(limit, trace_id=trace_id)


def parse_trace_query(query: dict) -> tuple[str | None, int]:
    """Validated (?trace=<32-hex id>, ?limit=N) from a parse_qs dict.

    Raises ValueError with an operator-readable message — the shared
    input validation for every server's /debug/traces and the master's
    /cluster/traces (which forwards the same parameters)."""
    trace_id: str | None = None
    raw = query.get("trace", [""])[0].strip().lower()
    if raw:
        if len(raw) != 32 or not trace._is_hex(raw):
            raise ValueError("trace must be a 32-hex-char trace id")
        trace_id = raw
    raw_limit = query.get("limit", [""])[0].strip()
    limit = 50
    if raw_limit:
        try:
            limit = int(raw_limit)
        except ValueError:
            raise ValueError("limit must be an integer") from None
        if not 1 <= limit <= TRACE_LIMIT_MAX:
            raise ValueError(f"limit must be in [1, {TRACE_LIMIT_MAX}]")
    return trace_id, limit


def _send(handler, code: int, body: bytes, ctype: str) -> None:
    handler.send_response(code)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    if handler.command != "HEAD":
        handler.wfile.write(body)


def _send_error(handler, code: int, message: str) -> None:
    import json

    _send(handler, code, json.dumps({"error": message}).encode(),
          "application/json")


def serve_debug_http(handler, path: str) -> bool:
    """Answer /metrics, /debug/traces, /debug/faults or /debug/profile on
    a BaseHTTPRequestHandler.

    The one implementation of the observability surface every server
    type mounts on its main HTTP port; returns True when `path` was one
    of the endpoints (response fully written), False otherwise."""
    import json
    import urllib.parse

    if path == DEBUG_TRACES_PATH:
        query = urllib.parse.parse_qs(
            urllib.parse.urlparse(handler.path).query)
        try:
            trace_id, limit = parse_trace_query(query)
        except ValueError as e:
            _send_error(handler, 400, str(e))
            return True
        body, ctype = debug_traces_body(limit, trace_id), "application/json"
    elif path == METRICS_PATH:
        from ..stats.metrics import REGISTRY, parse_family_prefixes

        query = urllib.parse.parse_qs(
            urllib.parse.urlparse(handler.path).query)
        try:
            prefixes = parse_family_prefixes(query.get("family", [""])[0])
        except ValueError as e:
            _send_error(handler, 400, str(e))
            return True
        body, ctype = (REGISTRY.render(prefixes).encode(),
                       "text/plain; version=0.0.4")
    elif path == DEBUG_PROFILE_HISTORY_PATH:
        from ..util import profiler

        if not profiler.enabled():
            _send_error(handler, 403,
                        f"profiler disabled ({profiler.DISABLE_VAR}=1)")
            return True
        body, ctype = (json.dumps(profiler.continuous_history()).encode(),
                       "application/json")
    elif path == DEBUG_HOT_PATH:
        from . import hotkeys

        query = urllib.parse.parse_qs(
            urllib.parse.urlparse(handler.path).query)
        try:
            n = int(query.get("n", [""])[0] or 32)
            if not 1 <= n <= 1024:
                raise ValueError("n must be in [1, 1024]")
        except ValueError as e:
            _send_error(handler, 400, str(e))
            return True
        body, ctype = (json.dumps(hotkeys.snapshot(n)).encode(),
                       "application/json")
    elif path == DEBUG_PROFILE_PATH:
        from ..util import profiler
        from ..util.grace import profile_status

        query = urllib.parse.parse_qs(
            urllib.parse.urlparse(handler.path).query)
        if query.get("status", [""])[0]:
            # the pre-sampler status stub, kept for cheap liveness checks
            body, ctype = (json.dumps(profile_status()).encode(),
                           "application/json")
        elif not profiler.enabled():
            _send_error(handler, 403,
                        f"profiler disabled ({profiler.DISABLE_VAR}=1)")
            return True
        else:
            try:
                seconds = float(query.get("seconds", [""])[0]
                                or profiler.DEFAULT_DURATION_S)
                hz = int(query.get("hz", [""])[0] or profiler.DEFAULT_HZ)
                text = profiler.profile_collapsed(seconds, hz)
            except (ValueError, TypeError) as e:
                _send_error(handler, 400, str(e))
                return True
            except profiler.ProfilerBusy as e:
                _send_error(handler, 409, str(e))
                return True
            body, ctype = text.encode(), "text/plain; charset=utf-8"
    elif path == DEBUG_FAULTS_PATH:
        from ..util import faultpoint

        query = urllib.parse.parse_qs(
            urllib.parse.urlparse(handler.path).query)
        try:
            state = faultpoint.handle_debug_request(query)
        except (ValueError, PermissionError) as e:
            _send_error(handler,
                        403 if isinstance(e, PermissionError) else 400,
                        str(e))
            return True
        body, ctype = json.dumps(state).encode(), "application/json"
    else:
        return False
    _send(handler, 200, body, ctype)
    return True
