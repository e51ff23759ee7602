"""Per-tenant namespaces: quotas + weighted-fair admission control.

The port's copy of seaweedfs_tpu/filer/fleet/tenant.py.

A tenant is a bucket (``/buckets/<b>/...`` -> tenant ``b``) — the same
unit the ring shards on, so a tenant's accounting always runs on the
shard that owns its writes and never needs cross-filer coordination.
Paths outside /buckets (config, topics, debug surfaces) carry no tenant
and are exempt from both quotas and admission.

Quotas (object count + bytes) are enforced in the Filer mutation path
before the store write; usage counters live in memory and checkpoint
into the store's KV space so restarts resume near-accurate.  Replicated
peer mutations (meta_aggregator replays) bypass the Filer path by
design, so each tenant is accounted exactly once fleet-wide: on its
owning shard.

Admission is rejection-based weighted fair queueing on the serving
executors, the scheduling-and-throttling framing of arXiv:2108.02692
applied to the filer front end: while the filer has headroom everyone
is admitted; once saturated (concurrent admitted requests at capacity,
or the ``seaweedfs_executor_queue_depth{executor="filer_chunk"}``
gauge shows the chunk fan-out pool backed up) each tenant is clamped to
its weight's share of capacity.  A saturating tenant gets ``503
SlowDown`` (proper S3 semantics, with Retry-After); a light tenant's
requests keep flowing because its share is reserved, which is the SLO
isolation the fleet acceptance test asserts.
"""

from __future__ import annotations

import json
import threading
import time

from ...stats.metrics import (
    EXECUTOR_QUEUE_DEPTH,
    TENANT_ADMIT,
    TENANT_INFLIGHT,
    TENANT_USAGE_BYTES,
    TENANT_USAGE_OBJECTS,
)
from ...util import glog

CONF_KEY = b"tenant.conf"
USAGE_KEY = b"tenant.usage"

# concurrent admitted requests before WFQ clamping kicks in
ADMIT_CAPACITY = 32
# filer_chunk executor queue depth that also counts as saturation
ADMIT_QUEUE_THRESHOLD = 64
# usage checkpoint throttle (replay-safe: counters are advisory)
USAGE_PERSIST_S = 2.0

RETRY_AFTER_S = 1


def tenant_for_path(path: str) -> str:
    """The owning tenant of a filer path; "" when untenanted."""
    p = "/" + (path or "").strip("/")
    segs = p.lstrip("/").split("/")
    if segs[0] == "buckets" and len(segs) > 1 and segs[1]:
        return segs[1]
    return ""


class QuotaExceededError(Exception):
    """The mutation would push the tenant past its configured quota.

    The message prefix is a wire contract: gRPC entry responses carry it
    in their error string and the S3 gateway maps it back to a 403
    QuotaExceeded, so keep ``quota exceeded`` stable.  Deliberately NOT
    an OSError subclass: failsafe.classify treats unknown OSErrors as
    retryable, and a quota rejection re-sent three times with backoff
    would triple load exactly when the tenant is being throttled (plain
    Exceptions classify non-retryable)."""

    def __init__(self, tenant: str, detail: str):
        super().__init__(f"quota exceeded for tenant {tenant!r}: {detail}")
        self.tenant = tenant


class SlowDownError(Exception):
    """Admission rejected the request: the tenant is over its fair share
    of a saturated filer.  Maps to S3 ``503 SlowDown``."""

    def __init__(self, tenant: str, retry_after: int = RETRY_AFTER_S):
        super().__init__(
            f"tenant {tenant!r} over its fair share; slow down")
        self.tenant = tenant
        self.retry_after = retry_after


class TenantManager:
    """Per-tenant config (quotas, WFQ weight) + usage accounting.

    Config and usage checkpoints persist in the filer store's KV space,
    so they shard — and fail over — with the namespace they govern."""

    def __init__(self, store=None):
        self.store = store
        self._lock = threading.Lock()
        self._conf: dict[str, dict] = {}
        self._usage: dict[str, dict[str, int]] = {}
        self._last_persist = time.monotonic()
        if store is not None:
            self._load()

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:
        for key, target in ((CONF_KEY, "_conf"), (USAGE_KEY, "_usage")):
            try:
                raw = self.store.kv_get(key)
                if raw:
                    setattr(self, target, json.loads(raw))
            except Exception as e:  # noqa: BLE001 — never block filer boot
                glog.warning("tenant %s load failed: %s", key, e)
        with self._lock:
            for tenant, u in self._usage.items():
                self._export_usage(tenant, u)

    def _persist_usage(self, force: bool = False) -> None:
        """Caller holds self._lock."""
        if self.store is None:
            return
        now = time.monotonic()
        if not force and now - self._last_persist < USAGE_PERSIST_S:
            return
        self._last_persist = now
        try:
            self.store.kv_put(USAGE_KEY, json.dumps(self._usage).encode())
        except Exception as e:  # noqa: BLE001 — advisory counters
            glog.warning("tenant usage persist failed: %s", e)

    def close(self) -> None:
        with self._lock:
            self._persist_usage(force=True)

    # -- config ------------------------------------------------------------

    def set_config(self, tenant: str, quota_bytes: int | None = None,
                   quota_objects: int | None = None,
                   weight: float | None = None) -> dict:
        with self._lock:
            conf = dict(self._conf.get(tenant, {}))
            if quota_bytes is not None:
                conf["quota_bytes"] = int(quota_bytes)
            if quota_objects is not None:
                conf["quota_objects"] = int(quota_objects)
            if weight is not None:
                conf["weight"] = float(weight)
            self._conf[tenant] = conf
            if self.store is not None:
                try:
                    self.store.kv_put(CONF_KEY,
                                      json.dumps(self._conf).encode())
                except Exception as e:  # noqa: BLE001
                    glog.warning("tenant conf persist failed: %s", e)
            return conf

    def config(self, tenant: str) -> dict:
        with self._lock:
            return dict(self._conf.get(tenant, {}))

    def weight(self, tenant: str) -> float:
        with self._lock:
            w = self._conf.get(tenant, {}).get("weight", 1.0)
        return max(0.01, float(w))

    # -- usage -------------------------------------------------------------

    def _export_usage(self, tenant: str, u: dict[str, int]) -> None:
        TENANT_USAGE_BYTES.labels(tenant).set(u.get("bytes", 0))
        TENANT_USAGE_OBJECTS.labels(tenant).set(u.get("objects", 0))

    def usage(self, tenant: str) -> dict[str, int]:
        with self._lock:
            u = self._usage.get(tenant, {})
            return {"objects": int(u.get("objects", 0)),
                    "bytes": int(u.get("bytes", 0))}

    def check_quota(self, tenant: str, add_objects: int,
                    add_bytes: int) -> None:
        """Raise QuotaExceededError when the pending mutation would land
        the tenant past either bound.  Deletes (negative deltas) always
        pass — a full tenant must be able to free space."""
        if not tenant or (add_objects <= 0 and add_bytes <= 0):
            return
        with self._lock:
            conf = self._conf.get(tenant)
            if not conf:
                return
            u = self._usage.get(tenant, {})
            qo = int(conf.get("quota_objects", 0))
            qb = int(conf.get("quota_bytes", 0))
            if qo and int(u.get("objects", 0)) + add_objects > qo:
                raise QuotaExceededError(
                    tenant, f"{u.get('objects', 0)} + {add_objects} "
                            f"objects > limit {qo}")
            if qb and int(u.get("bytes", 0)) + add_bytes > qb:
                raise QuotaExceededError(
                    tenant, f"{u.get('bytes', 0)} + {add_bytes} "
                            f"bytes > limit {qb}")

    def record(self, tenant: str, d_objects: int, d_bytes: int) -> None:
        if not tenant or (d_objects == 0 and d_bytes == 0):
            return
        with self._lock:
            u = self._usage.setdefault(tenant, {"objects": 0, "bytes": 0})
            u["objects"] = max(0, int(u.get("objects", 0)) + d_objects)
            u["bytes"] = max(0, int(u.get("bytes", 0)) + d_bytes)
            self._export_usage(tenant, u)
            self._persist_usage()

    def snapshot(self) -> dict:
        """/debug/tenants view: config + usage per known tenant."""
        with self._lock:
            tenants = sorted(set(self._conf) | set(self._usage))
            return {
                t: {
                    "config": dict(self._conf.get(t, {})),
                    "usage": {
                        "objects": int(
                            self._usage.get(t, {}).get("objects", 0)),
                        "bytes": int(
                            self._usage.get(t, {}).get("bytes", 0)),
                    },
                }
                for t in tenants
            }


def _chunk_pool_queue_depth() -> float:
    """The saturation signal for the filer's chunk fan-out pool."""
    return EXECUTOR_QUEUE_DEPTH.labels("filer_chunk").value


class AdmissionController:
    """Rejection-based WFQ over concurrent admitted requests.

    ``admit(tenant)`` is a context manager the serving path wraps one
    request in.  Below saturation it is one lock + two increments; at
    saturation a tenant already holding >= its weighted share of
    capacity gets SlowDownError while lighter tenants pass."""

    def __init__(self, manager: TenantManager):
        self.manager = manager
        self.capacity = ADMIT_CAPACITY
        self.queue_threshold = ADMIT_QUEUE_THRESHOLD
        self._queue_depth = _chunk_pool_queue_depth
        self._lock = threading.Lock()
        self._inflight: dict[str, int] = {}
        self._total = 0

    def _share(self, tenant: str, effective_capacity: int) -> int:
        """This tenant's WFQ share of ``effective_capacity`` among
        currently-active tenants (itself included).  At least 1: weights
        throttle, they never starve."""
        weights = {t: self.manager.weight(t)
                   for t, n in self._inflight.items() if n > 0}
        weights[tenant] = self.manager.weight(tenant)
        total_w = sum(weights.values())
        return max(1, int(effective_capacity * weights[tenant] / total_w))

    def try_enter(self, tenant: str) -> None:
        """Admit or raise SlowDownError.  Untenanted paths are exempt
        (admitted, uncounted): config reads and debug surfaces must
        never be collateral of a tenant storm."""
        if not tenant:
            return
        with self._lock:
            at_capacity = self._total >= self.capacity
            queue_backed_up = self._queue_depth() >= self.queue_threshold
            if at_capacity or queue_backed_up:
                # at capacity, shares split the configured width; when
                # only the downstream queue gauge fired, shares split
                # what is ALREADY in flight — admitting more of anyone
                # just grows the backlog, so the clamp freezes growth
                effective = (self.capacity if at_capacity
                             else max(1, self._total))
                if self._inflight.get(tenant, 0) >= \
                        self._share(tenant, effective):
                    TENANT_ADMIT.labels(tenant, "slowdown").inc()
                    raise SlowDownError(tenant)
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
            self._total += 1
        TENANT_INFLIGHT.labels(tenant).inc()
        TENANT_ADMIT.labels(tenant, "ok").inc()

    def leave(self, tenant: str) -> None:
        if not tenant:
            return
        with self._lock:
            n = self._inflight.get(tenant, 0)
            if n <= 1:
                self._inflight.pop(tenant, None)
            else:
                self._inflight[tenant] = n - 1
            if n > 0:
                self._total -= 1
                TENANT_INFLIGHT.labels(tenant).dec()

    class _Slot:
        __slots__ = ("ctl", "tenant")

        def __init__(self, ctl, tenant):
            self.ctl = ctl
            self.tenant = tenant

        def __enter__(self):
            self.ctl.try_enter(self.tenant)
            return self

        def __exit__(self, *exc):
            self.ctl.leave(self.tenant)
            return False

    def admit(self, tenant: str) -> "_Slot":
        return self._Slot(self, tenant)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "queueThreshold": self.queue_threshold,
                "inflight": dict(self._inflight),
                "total": self._total,
            }
