"""In-process tracing: spans, a thread-local context stack and a bounded
ring of finished spans — the part of seaweedfs_tpu/telemetry/trace.py that
the codec and the EC read path use.

Usage:
    from seaweedfs_tpu_torch.telemetry import trace
    with trace.start_span("ec.read_needle", volume=3):
        ...
    with trace.child_span("ec.device_compute", impl="cuda"):
        ...  # recorded only inside an active trace

Spans carry the same names and attributes as the reference's, so a trace
of the port reads like one of the reference.  W3C `traceparent`
propagation (`traceparent_header`, `remote_context`) carries a caller's
context across the gRPC hops of pb/rpc.py.  Not ported: the
/debug/traces rendering and the log lines' trace ids (the reference's
glog context provider); they belong to the HTTP side.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

# ring capacity: finished spans kept in memory per process
MAX_SPANS = int(os.environ.get("SEAWEEDFS_TPU_TRACE_BUFFER", "2048"))
# error-status and slow spans are also kept in a second ring, so a burst of
# healthy traffic cannot evict the trace an alert points at
MAX_IMPORTANT_SPANS = int(
    os.environ.get("SEAWEEDFS_TPU_TRACE_IMPORTANT_BUFFER", "512"))
SLOW_SPAN_SECONDS = float(
    os.environ.get("SEAWEEDFS_TPU_SLOW_REQUEST_S", "1.0"))

_ctx = threading.local()  # _ctx.stack: list[(trace_id, span_id)]
# ids need uniqueness, not unpredictability
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


class Tracer:
    """Bounded recorder of finished spans."""

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
        """Main and important rings, each span once."""
        with self._lock:
            main = list(self._spans)
            important = list(self._important)
        seen = {(s.trace_id, s.span_id) for s in main}
        merged = [s for s in important
                  if (s.trace_id, s.span_id) not in seen]
        merged.extend(main)
        return merged


TRACER = Tracer()


def _stack() -> list:
    stack = getattr(_ctx, "stack", None)
    if stack is None:
        stack = _ctx.stack = []
    return stack


def current_context() -> "tuple[str, str] | None":
    """(trace_id, span_id) of the active span, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def current_trace_id() -> "str | None":
    ctx = current_context()
    return ctx[0] if ctx else None


@contextmanager
def start_span(name: str, tracer: Tracer = TRACER, **attrs):
    """Open a span under the current context (a new trace when none)."""
    stack = _stack()
    if stack:
        trace_id, parent_id = stack[-1]
    else:
        trace_id, parent_id = _rand_hex(16), ""
    span = Span(trace_id=trace_id, span_id=_rand_hex(8), parent_id=parent_id,
                name=name, start=time.time(), attrs=dict(attrs))
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
    """`start_span` only inside an active trace; a no-op otherwise, so bulk
    work outside any request (an encode's thousands of codec calls) does
    not flood the ring with one-span traces."""
    if current_context() is None:
        yield None
        return
    with start_span(name, tracer=tracer, **attrs) as span:
        yield span


# -- W3C traceparent ---------------------------------------------------------

TRACEPARENT = "traceparent"


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def traceparent_header() -> "str | None":
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


def parse_traceparent(value: "str | None") -> "tuple[str, str] | None":
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
def remote_context(traceparent: "str | None"):
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
