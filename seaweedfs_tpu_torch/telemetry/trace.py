"""In-process distributed tracing: spans, W3C traceparent, a bounded ring.

The port's copy of seaweedfs_tpu/telemetry/trace.py.

Reference shape: OpenTelemetry's SDK, cut down to what a blob store's
request path needs — a thread-local context stack, wall-clock spans, and
a fixed-size ring buffer of finished spans that /debug/traces serves as
JSON.  No exporter, no sampler: every request is recorded until the ring
evicts it, which is the right trade for a debug surface (the Facebook
warehouse study's lesson is that you need per-hop latency for the tail
*after* the fact, not a 1% head sample).

Propagation uses the W3C trace-context `traceparent` header
(`00-<32 hex trace id>-<16 hex span id>-<2 hex flags>`) on HTTP and the
same string as gRPC metadata, so one client write yields one connected
trace across filer -> master assign -> volume POST -> replication.

Usage:
    from seaweedfs_tpu_torch.telemetry import trace
    with trace.start_span("volumeServer.post", path="/3,0123"):
        ...
    hdr = trace.traceparent_header()        # inject into outgoing calls
    with trace.remote_context(incoming_hdr):  # adopt a caller's context
        ...
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

from ..util import glog

# ring capacity: finished spans kept in memory per process
MAX_SPANS = int(os.environ.get("SEAWEEDFS_TPU_TRACE_BUFFER", "2048"))

# separate bounded ring for spans an alert will want: error-status and
# slow spans.  Without it a burst of healthy traffic evicts the one
# trace a firing alert's exemplar points at before anyone looks — the
# page would link to an empty timeline.
MAX_IMPORTANT_SPANS = int(
    os.environ.get("SEAWEEDFS_TPU_TRACE_IMPORTANT_BUFFER", "512"))

# slow-span retention threshold; same knob the middleware's slow-request
# log uses (middleware imports this binding — one source of truth)
SLOW_SPAN_SECONDS = float(
    os.environ.get("SEAWEEDFS_TPU_SLOW_REQUEST_S", "1.0"))

_ctx = threading.local()  # _ctx.stack: list[(trace_id, span_id)]

# ids need uniqueness, not unpredictability: os.urandom costs a syscall
# per call and every request opens a span (two ids) — a urandom-seeded
# PRNG is plenty (getrandbits is a single atomic C call, thread-safe
# under the GIL)
_id_rng = random.Random(os.urandom(16))


def _rand_hex(nbytes: int) -> str:
    return f"{_id_rng.getrandbits(8 * nbytes):0{2 * nbytes}x}"


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: str
    name: str
    start: float  # wall-clock seconds (time.time)
    duration: float = 0.0
    attrs: dict = field(default_factory=dict)
    status: str = "ok"

    def to_dict(self) -> dict:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "start": self.start,
            "durationMs": round(self.duration * 1e3, 3),
            "attrs": self.attrs,
            "status": self.status,
        }


class Tracer:
    """Bounded recorder of finished spans, grouped on read by trace id.

    Two rings: the main ring holds everything; error-status and slow
    spans are ALSO retained in a separate bounded ring, so a burst of
    healthy traffic cannot evict the trace an alert needs before an
    operator follows the exemplar link."""

    def __init__(self, max_spans: int = MAX_SPANS,
                 max_important: int = MAX_IMPORTANT_SPANS):
        self._spans: deque[Span] = deque(maxlen=max_spans)
        self._important: deque[Span] = deque(maxlen=max_important)
        self._lock = threading.Lock()

    def record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            if span.status != "ok" or span.duration >= SLOW_SPAN_SECONDS:
                self._important.append(span)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._important.clear()

    def spans(self) -> list[Span]:
        """Main + important rings, deduplicated (a span recent enough to
        still sit in the main ring appears once)."""
        with self._lock:
            main = list(self._spans)
            important = list(self._important)
        seen = {(s.trace_id, s.span_id) for s in main}
        merged = [s for s in important
                  if (s.trace_id, s.span_id) not in seen]
        merged.extend(main)
        return merged

    def recent_traces(self, limit: int = 50,
                      trace_id: str | None = None) -> list[dict]:
        """Most-recent traces first, each with its spans in start order.
        `trace_id` filters the ring down to one trace (the cluster
        stitcher's per-trace query; a full dump per node would make the
        fan-out O(ring size x nodes))."""
        by_trace: dict[str, list[Span]] = {}
        for s in self.spans():
            if trace_id is not None and s.trace_id != trace_id:
                continue
            by_trace.setdefault(s.trace_id, []).append(s)
        # order traces by the latest span end they contain, newest first
        ordered = sorted(
            by_trace.items(),
            key=lambda kv: max(s.start + s.duration for s in kv[1]),
            reverse=True,
        )[:limit]
        return [
            {
                "traceId": tid,
                "spans": [s.to_dict()
                          for s in sorted(spans, key=lambda s: s.start)],
            }
            for tid, spans in ordered
        ]

    def traces_json(self, limit: int = 50,
                    trace_id: str | None = None) -> bytes:
        # "now" = this process's wall clock at render time: the stitcher
        # compares it against its own clock (minus half the scrape RTT)
        # to annotate per-node clock skew on merged timelines
        return json.dumps({
            "now": time.time(),
            "traces": self.recent_traces(limit, trace_id=trace_id),
        }).encode()


TRACER = Tracer()


# -- thread-local context ----------------------------------------------------


def _stack() -> list:
    stack = getattr(_ctx, "stack", None)
    if stack is None:
        stack = _ctx.stack = []
    return stack


def current_context() -> tuple[str, str] | None:
    """(trace_id, span_id) of the active span, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def current_trace_id() -> str | None:
    ctx = current_context()
    return ctx[0] if ctx else None


@contextmanager
def start_span(name: str, tracer: Tracer = TRACER, **attrs):
    """Open a span under the current context (new trace when none)."""
    stack = _stack()
    if stack:
        trace_id, parent_id = stack[-1]
    else:
        trace_id, parent_id = _rand_hex(16), ""
    span = Span(
        trace_id=trace_id,
        span_id=_rand_hex(8),
        parent_id=parent_id,
        name=name,
        start=time.time(),
        attrs=dict(attrs),
    )
    stack.append((trace_id, span.span_id))
    t0 = time.perf_counter()
    try:
        yield span
    except BaseException as e:
        span.status = f"error: {type(e).__name__}"
        raise
    finally:
        span.duration = time.perf_counter() - t0
        stack.pop()
        tracer.record(span)


@contextmanager
def child_span(name: str, tracer: Tracer = TRACER, **attrs):
    """`start_span` only when already inside a trace; no-op otherwise.

    For instrumentation on paths that also run outside any request
    (codec calls from bulk encodes, client hops from background loops):
    a root span per call would flood the ring with single-span traces
    and evict the request traces /debug/traces exists to serve."""
    if current_context() is None:
        yield None
        return
    with start_span(name, tracer=tracer, **attrs) as span:
        yield span


# -- W3C traceparent ---------------------------------------------------------

TRACEPARENT = "traceparent"


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def traceparent_header() -> str | None:
    """Header value for the active context, or None outside any span."""
    ctx = current_context()
    if ctx is None:
        return None
    return format_traceparent(*ctx)


_HEX = frozenset("0123456789abcdef")


def _is_hex(s: str) -> bool:
    # strict per-character check: int(s, 16) would admit '+', '-' and
    # '_' separators and re-propagate a spec-invalid id downstream
    return bool(s) and set(s) <= _HEX


def parse_traceparent(value: str | None) -> tuple[str, str] | None:
    """-> (trace_id, span_id) or None on anything malformed."""
    if not value:
        return None
    parts = value.strip().lower().split("-")
    if len(parts) < 4 or len(parts[0]) != 2 or len(parts[1]) != 32 \
            or len(parts[2]) != 16:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if not (_is_hex(version) and _is_hex(trace_id) and _is_hex(span_id)):
        return None
    if version == "ff":  # forbidden version per spec
        return None
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None  # all-zero ids are invalid per spec
    return trace_id, span_id


@contextmanager
def remote_context(traceparent: str | None):
    """Adopt a remote caller's context for the duration of the block.

    With a malformed/absent header this is a no-op: spans opened inside
    start a fresh trace, exactly like an edge request."""
    parsed = parse_traceparent(traceparent)
    if parsed is None:
        yield None
        return
    stack = _stack()
    stack.append(parsed)
    try:
        yield parsed
    finally:
        stack.pop()


def inject_headers(headers: dict) -> dict:
    """Add traceparent to an outgoing-request header dict (mutates + returns)."""
    hdr = traceparent_header()
    if hdr is not None:
        headers[TRACEPARENT] = hdr
    return headers


def wrap_context(fn):
    """Carry the caller's trace context into a thread-pool worker.

    The filer fans chunk uploads and chunk reads out to an executor;
    without this the volume-server hops would each start orphan traces."""
    ctx = current_context()
    if ctx is None:
        return fn

    def bound(*args, **kwargs):
        stack = _stack()
        stack.append(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            stack.pop()

    return bound


# log correlation: every glog line emitted under an active span carries
# the trace id (the slow-request log's join key back to /debug/traces)
glog.set_context_provider(current_trace_id)
