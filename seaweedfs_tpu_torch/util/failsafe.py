"""Unified fault-tolerance policy for every cross-process call path — the
port's copy of seaweedfs_tpu/util/failsafe.py.

One place defines how the cluster retries, backs off, deadlines and
circuit-breaks — replacing the scattered `time.sleep(0.2*(attempt+1))`,
`sleep(1.747)` and bare fixed timeouts that predated it.  The design
follows the degraded-mode findings of the warehouse-cluster study
(arXiv:1309.0186): recovery traffic dominates exactly when peers fail,
so failure handling must shed load (full-jitter backoff), bound work
(deadlines) and stop hammering dead peers (per-peer breakers) instead of
synchronized linear retries.

Pieces:

  RetryPolicy   — attempts + exponential backoff with FULL jitter
                  (delay ~ U(0, min(cap, base*2^attempt))), AWS-style.
  Deadline      — a total-time budget carried in a contextvar; pb/rpc.py
                  stubs clamp their per-call timeout to the remaining
                  budget so a caller's deadline propagates through every
                  nested rpc hop.
  classify      — maps an exception to (reason, retryable) with
                  idempotency awareness: a connect error never reached
                  the server so even a POST may retry it; a mid-body
                  timeout is retryable only for idempotent ops.
  CircuitBreaker— per-peer closed/open/half-open with a consecutive-
                  failure threshold; breaker_for() is the process-wide
                  registry.
  call          — retry loop over one callable (one peer).
  call_with_failover — retry loop over a rotating peer list (masters,
                  replica locations), breaker-gated.

Everything emits through the PR-1 telemetry layer:

  seaweedfs_retry_total{type,op,reason}        every retried failure
  seaweedfs_circuit_state{peer}                0 closed / 1 open / 2 half-open
  seaweedfs_circuit_transitions_total{peer,to} state changes
"""

from __future__ import annotations

import contextlib
import contextvars
import http.client
import json
import random
import socket
import threading
import time
import urllib.error
from dataclasses import dataclass, field
from typing import Callable, Iterable

from ..stats.metrics import (  # families declared centrally for the lint
    CIRCUIT_STATE,
    CIRCUIT_TRANSITIONS,
    RETRY_COUNTER,
)
from . import glog

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_VALUE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


# ---------------------------------------------------------------------------
# Retry policy + backoff
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """How often and how fast to retry one logical operation."""

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 5.0
    timeout: float | None = None  # per-attempt timeout hint for callers

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        """Full-jitter backoff for the given 0-based failed attempt.  The
        exponent is clamped so open-ended reconnect loops can call this
        forever without overflowing a float (2.0**1024 raises)."""
        cap = min(self.max_delay,
                  self.base_delay * (2.0 ** min(attempt, 62)))
        return (rng or _rng).uniform(0.0, cap)


# sensible defaults per edge; callers may pass their own
DEFAULT_POLICY = RetryPolicy()
UPLOAD_POLICY = RetryPolicy(max_attempts=3, base_delay=0.1, max_delay=2.0)
DOWNLOAD_POLICY = RetryPolicy(max_attempts=3, base_delay=0.05, max_delay=1.0)
RPC_POLICY = RetryPolicy(max_attempts=3, base_delay=0.05, max_delay=2.0)
RECONNECT_POLICY = RetryPolicy(max_attempts=1 << 30, base_delay=0.5,
                               max_delay=30.0)

_rng = random.Random()


class Backoff:
    """Stateful jittered backoff for open-ended reconnect loops
    (replicator, keep-connected): next() grows, reset() after success."""

    def __init__(self, policy: RetryPolicy = RECONNECT_POLICY,
                 rng: random.Random | None = None):
        self.policy = policy
        self.attempt = 0
        self._rng = rng or _rng

    def next(self) -> float:
        d = self.policy.delay(self.attempt, self._rng)
        self.attempt += 1
        return d

    def reset(self) -> None:
        self.attempt = 0


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------


class DeadlineExceeded(TimeoutError):
    """The caller's total-time budget ran out before the op completed."""


class Deadline:
    def __init__(self, seconds: float, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.expires_at = clock() + seconds

    def remaining(self) -> float:
        return self.expires_at - self._clock()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0


_deadline_var: contextvars.ContextVar[Deadline | None] = contextvars.ContextVar(
    "seaweedfs_deadline", default=None)


def current_deadline() -> Deadline | None:
    return _deadline_var.get()


@contextlib.contextmanager
def deadline_scope(seconds: float):
    """Install a total-time budget for everything inside the scope.  Nested
    scopes never extend an outer budget — the tighter deadline wins."""
    outer = _deadline_var.get()
    inner = Deadline(seconds)
    if outer is not None and outer.expires_at < inner.expires_at:
        inner = outer
    token = _deadline_var.set(inner)
    try:
        yield inner
    finally:
        _deadline_var.reset(token)


def attempt_timeout(default: float | None) -> float | None:
    """Clamp a per-attempt timeout to the ambient deadline's remainder.

    Raises DeadlineExceeded when the budget is already spent — better to
    fail in the caller than to fire a guaranteed-to-timeout request."""
    dl = _deadline_var.get()
    if dl is None:
        return default
    rem = dl.remaining()
    if rem <= 0.0:
        raise DeadlineExceeded("deadline exceeded before attempt")
    if default is None:
        return rem
    return min(default, rem)


# ---------------------------------------------------------------------------
# Failure classification
# ---------------------------------------------------------------------------


def classify(exc: BaseException, idempotent: bool = True) -> tuple[str, bool]:
    """-> (reason label, retryable?) for one failed attempt.

    Idempotency-aware: a connect-phase failure (refused / unreachable /
    DNS) never delivered the request, so retrying is safe even for
    non-idempotent POSTs.  An HTTP 5xx is an explicit server-side NACK
    before the write was acknowledged — also retry-safe.  A timeout or
    reset mid-exchange is ambiguous (the body may have been applied), so
    only idempotent operations retry it."""
    # unwrap urllib's URLError(reason=<socket error>) envelope
    if isinstance(exc, urllib.error.HTTPError):
        if exc.code >= 500:
            return f"http_{exc.code}", True
        return f"http_{exc.code}", False
    if isinstance(exc, urllib.error.URLError):
        inner = exc.reason
        if isinstance(inner, BaseException):
            return classify(inner, idempotent)
        return "connect", True
    if isinstance(exc, DeadlineExceeded):
        return "deadline", False
    if isinstance(exc, ConnectionRefusedError):
        return "refused", True
    if isinstance(exc, (ConnectionResetError, ConnectionAbortedError,
                        BrokenPipeError)):
        return "reset", idempotent
    if isinstance(exc, (socket.timeout, TimeoutError)):
        return "timeout", idempotent
    if isinstance(exc, socket.gaierror):
        return "dns", True
    if isinstance(exc, http.client.RemoteDisconnected):
        return "reset", idempotent
    if isinstance(exc, http.client.HTTPException):
        return "http_proto", idempotent
    if isinstance(exc, json.JSONDecodeError):
        # a 2xx with a garbled body: the write may have landed
        return "bad_response", False
    try:  # grpc is always present in this image, but keep the probe cheap
        import grpc
    except ImportError:  # pragma: no cover
        grpc = None
    if grpc is not None and isinstance(exc, grpc.RpcError):
        code = exc.code() if callable(getattr(exc, "code", None)) else None
        if code == grpc.StatusCode.UNAVAILABLE:
            return "unavailable", True
        if code == grpc.StatusCode.DEADLINE_EXCEEDED:
            return "timeout", idempotent
        if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
            return "exhausted", True
        if code == grpc.StatusCode.FAILED_PRECONDITION:
            # "not the leader" and friends: peer-specific, rotate/retry
            return "failed_precondition", True
        return f"grpc_{code.name.lower()}" if code else "grpc", False
    if isinstance(exc, OSError):
        return "os_error", idempotent
    return "error", False


def is_connection_refused(exc: BaseException) -> bool:
    """True when the peer actively refused the connection — the signal to
    evict its cached locations (the process is gone, not just slow)."""
    if isinstance(exc, ConnectionRefusedError):
        return True
    if isinstance(exc, urllib.error.URLError) and not isinstance(
            exc, urllib.error.HTTPError):
        return isinstance(exc.reason, ConnectionRefusedError)
    return False


# ---------------------------------------------------------------------------
# Circuit breakers
# ---------------------------------------------------------------------------


class CircuitOpenError(ConnectionError):
    """Fast-failed: the peer's breaker is open (recent consecutive
    failures); no request was sent."""


class CircuitBreaker:
    """Per-peer consecutive-failure breaker.

    closed --(threshold consecutive failures)--> open
    open   --(reset_timeout elapsed)-->           half-open (one probe)
    half-open --success--> closed ; --failure--> open
    """

    def __init__(self, peer: str, failure_threshold: int = 5,
                 reset_timeout: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.peer = peer
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        CIRCUIT_STATE.labels(peer).set(0.0)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str) -> None:
        # lock held by caller
        if self._state == to:
            return
        self._state = to
        CIRCUIT_STATE.labels(self.peer).set(_STATE_VALUE[to])
        CIRCUIT_TRANSITIONS.labels(self.peer, to).inc()
        glog.info("circuit %s -> %s trace=%s", self.peer, to,
                  _trace_id() or "-")

    def allow(self) -> bool:
        """May a request go to this peer right now?  An open breaker whose
        reset timeout elapsed flips to half-open and admits ONE probe."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.reset_timeout:
                    self._transition(HALF_OPEN)
                    self._probe_in_flight = True
                    return True
                return False
            # half-open: one probe at a time
            if self._probe_in_flight:
                return False
            self._probe_in_flight = True
            return True

    def release_probe(self) -> None:
        """The admitted request was abandoned before it reached the peer
        (caller's deadline spent): free the half-open probe slot without
        judging the peer either way."""
        with self._lock:
            self._probe_in_flight = False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probe_in_flight = False
            if self._state == HALF_OPEN:
                self._opened_at = self._clock()
                self._transition(OPEN)
                return
            self._consecutive_failures += 1
            if (self._state == CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._opened_at = self._clock()
                self._transition(OPEN)


_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()

# tunables applied to breakers created after the change (tests shrink them)
BREAKER_FAILURE_THRESHOLD = 5
BREAKER_RESET_TIMEOUT = 10.0


def breaker_for(peer: str) -> CircuitBreaker:
    with _breakers_lock:
        br = _breakers.get(peer)
        if br is None:
            br = CircuitBreaker(peer, BREAKER_FAILURE_THRESHOLD,
                                BREAKER_RESET_TIMEOUT)
            _breakers[peer] = br
        return br


def reset_breakers() -> None:
    """Drop all breaker state (tests; also useful after reconfiguration)."""
    with _breakers_lock:
        _breakers.clear()


# ---------------------------------------------------------------------------
# Retry loops
# ---------------------------------------------------------------------------


def _trace_id() -> str | None:
    from ..telemetry import trace

    return trace.current_trace_id()


def _breaker_judges_failure(e: BaseException) -> bool:
    """Whether an exception counts against the peer's circuit breaker.

    An HTTP 4xx is a full answer from a live, healthy peer — a typed
    409 volume-full, a 404 stale location, a 403 auth miss say nothing
    about its availability.  Opening the breaker on them makes ONE full
    volume fail fast every other request to that server for the reset
    window (observed live: a burst of volume-full 409s opened the
    breaker and re-assigned uploads died on "circuit open" instead of
    landing on the server's other volumes).  5xx and transport errors
    still count — that is what the breaker is for."""
    return not (isinstance(e, urllib.error.HTTPError)
                and 400 <= e.code < 500)


def _breaker_record(br, e: BaseException) -> None:
    if _breaker_judges_failure(e):
        br.record_failure()
    else:
        br.record_success()  # the peer answered: it is alive


def _sleep_backoff(policy: RetryPolicy, attempt: int,
                   rng: random.Random | None = None) -> None:
    delay = policy.delay(attempt, rng)
    dl = _deadline_var.get()
    if dl is not None:
        rem = dl.remaining()
        if rem <= 0.0:
            raise DeadlineExceeded("deadline exceeded during backoff")
        delay = min(delay, rem)
    if delay > 0.0:
        time.sleep(delay)


def call(
    fn: Callable[[], object],
    *,
    op: str,
    retry_type: str = "client",
    policy: RetryPolicy = DEFAULT_POLICY,
    peer: str | None = None,
    idempotent: bool = True,
    rng: random.Random | None = None,
):
    """Run fn() under the retry policy against one peer.

    Raises the last exception once attempts/deadline are exhausted or the
    failure is classified non-retryable.  When `peer` is given, the call
    is breaker-gated: an open breaker raises CircuitOpenError without
    attempting, and every outcome feeds the breaker."""
    br = breaker_for(peer) if peer else None
    last: BaseException | None = None
    for attempt in range(max(1, policy.max_attempts)):
        if br is not None and not br.allow():
            raise CircuitOpenError(f"circuit open for {peer}")
        try:
            result = fn()
        except BaseException as e:  # noqa: BLE001 - classified below
            if br is not None:
                if isinstance(e, DeadlineExceeded):
                    # a spent budget says nothing about THIS peer's
                    # health — the request may never have been sent; but
                    # an admitted half-open probe slot must be freed or
                    # the breaker wedges open forever
                    br.release_probe()
                else:
                    _breaker_record(br, e)
            reason, retryable = classify(e, idempotent)
            last = e
            if not retryable or attempt + 1 >= policy.max_attempts:
                raise
            RETRY_COUNTER.labels(retry_type, op, reason).inc()
            glog.info("retry %s.%s attempt=%d reason=%s peer=%s trace=%s",
                      retry_type, op, attempt + 1, reason, peer or "-",
                      _trace_id() or "-")
            _sleep_backoff(policy, attempt, rng)
            continue
        if br is not None:
            br.record_success()
        return result
    raise last  # pragma: no cover - loop always returns or raises


def call_with_failover(
    peers: Iterable[str] | Callable[[int], Iterable[str]],
    fn: Callable[[str], object],
    *,
    op: str,
    retry_type: str = "client",
    policy: RetryPolicy = RPC_POLICY,
    idempotent: bool = True,
    on_peer_failure: Callable[[str, BaseException], None] | None = None,
    peer_key: Callable[[str], str] | None = None,
    rng: random.Random | None = None,
):
    """Try fn(peer) across a peer list with breaker gating and jittered
    backoff between full rounds (policy.max_attempts rounds).

    `peers` may be a callable round -> iterable so the caller can refresh
    the candidate list between rounds (e.g. re-ask the master after every
    cached location failed).  `peer_key` maps a candidate to its breaker
    key (e.g. a fid URL to its host:port) so breaker state aggregates per
    server.  If every peer in a round was skipped by an open breaker, one
    is probed anyway — total lockout must degrade to "slow", never to
    "impossible".

    Unlike call(), a non-retryable failure does NOT abort the rotation:
    one replica answering 404 (stale vid map, missing copy) says nothing
    about the others, so every candidate gets its chance and the LAST
    error surfaces.  Only an exhausted deadline ends the loop early —
    the budget is gone for every remaining peer alike."""
    key = peer_key or (lambda p: p)
    last: BaseException | None = None
    for round_no in range(max(1, policy.max_attempts)):
        candidates = list(peers(round_no) if callable(peers) else peers)
        if not candidates:
            break
        attempted = 0
        for peer in candidates:
            br = breaker_for(key(peer))
            if not br.allow():
                continue
            attempted += 1
            try:
                result = fn(peer)
            except DeadlineExceeded:
                # budget spent: no peer can help; free the probe slot the
                # allow() above may have claimed, judge the peer neither way
                br.release_probe()
                raise
            except BaseException as e:  # noqa: BLE001 - classified below
                _breaker_record(br, e)
                if on_peer_failure is not None:
                    on_peer_failure(peer, e)
                reason, _retryable = classify(e, idempotent)
                last = e
                RETRY_COUNTER.labels(retry_type, op, reason).inc()
                glog.info(
                    "failover %s.%s peer=%s reason=%s round=%d trace=%s",
                    retry_type, op, peer, reason, round_no, _trace_id() or "-")
                continue
            br.record_success()
            return result
        if attempted == 0:
            # every breaker open: force-probe the first candidate so a
            # cluster-wide blip cannot wedge us for reset_timeout
            peer = candidates[0]
            try:
                result = fn(peer)
            except DeadlineExceeded:
                breaker_for(key(peer)).release_probe()
                raise
            except BaseException as e:  # noqa: BLE001
                _breaker_record(breaker_for(key(peer)), e)
                if on_peer_failure is not None:
                    on_peer_failure(peer, e)
                reason, _retryable = classify(e, idempotent)
                last = e
                RETRY_COUNTER.labels(retry_type, op, reason).inc()
            else:
                breaker_for(key(peer)).record_success()
                return result
        if round_no + 1 < policy.max_attempts:
            _sleep_backoff(policy, round_no, rng)
    if last is not None:
        raise last
    raise CircuitOpenError(f"{op}: no peers available")
