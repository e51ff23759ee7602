"""A small Prometheus-style registry: counters, gauges and histograms with
labels, exemplars, and the text exposition on a /metrics HTTP endpoint —
the port's own copy of seaweedfs_tpu/stats/metrics.py, with the families
the port's modules record: the codec service, the codec registry, the EC
read path and its caches, the rebuild, the executors, fault injection,
disk health, the needle cache, the scrubber and group commit (names,
labels and buckets unchanged, so dashboards built on the reference read
the port the same way).

The volume server adds the request, volume and gRPC-byte families, the
partial-sum repair families, the retry and circuit-breaker families of
util/failsafe.py, the heartbeat's compact snapshot
(`Registry.snapshot_samples`), and for its HTTP side the sendfile,
event-loop, connection-pool, replication, volume-full and hot-key
families.  `serve_metrics` renders this registry only: a process that also
runs the reference's servers keeps two registries, each on its own port.

The master adds the lifecycle and mass-repair families, and for its
quorum, judgment and flight-recorder planes the raft, SLO, canary and
debug-bundle families.  The filer adds the chunk-cache, metadata-listener
and tenant families.  Not carried over: the families of the gateways, the
filer ring and geo replication.
"""

from __future__ import annotations

import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from ..util.httpd import FrameworkHTTPServer

_DEFAULT_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
_EC_BYTE_BUCKETS = tuple(float(4 ** k) for k in range(5, 16))  # 1KB..1GB

# exemplar rotation window: each histogram bucket remembers the SLOWEST
# recent observation's trace id for this long before a smaller sample may
# replace it — long enough for an alert evaluation tick to pick it up,
# short enough that a page links to the incident, not last week's spike
EXEMPLAR_WINDOW_S = float(
    os.environ.get("SEAWEEDFS_TPU_EXEMPLAR_WINDOW_S", "60"))

_FAMILY_RE = re.compile(r"^[A-Za-z_:][A-Za-z0-9_:]*$")


def parse_family_prefixes(raw: str) -> list[str] | None:
    """Validated `?family=<prefix>[,<prefix>...]` filter shared by every
    /metrics endpoint and the master's /cluster/metrics.  Empty -> None
    (no filter); malformed -> ValueError with an operator-readable
    message (a typo'd filter silently matching nothing would read as
    'cluster emits no metrics' mid-incident)."""
    raw = (raw or "").strip()
    if not raw:
        return None
    prefixes = [p.strip() for p in raw.split(",") if p.strip()]
    if not prefixes:
        return None
    if len(prefixes) > 16:
        raise ValueError("family: at most 16 comma-separated prefixes")
    for p in prefixes:
        if not _FAMILY_RE.match(p):
            raise ValueError(
                f"family prefix {p!r} must match [A-Za-z_:][A-Za-z0-9_:]*")
    return prefixes


def escape_label_value(v: str) -> str:
    """Prometheus text exposition: label values escape \\, \" and newline."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def format_le(bound: float) -> str:
    """Render a bucket bound as a float consistently (`10.0`, not `10`),
    so scrapers that string-match bounds see one canonical spelling."""
    return repr(float(bound))


# families whose label cardinality scales with the environment (one child
# per peer / data dir / hot key) — emitted LAST from snapshot_samples so
# they can never crowd the fixed-cardinality families SLO rules read out
# of the 512-sample heartbeat snapshot fallback
SNAPSHOT_DENY_PREFIXES = (
    "seaweedfs_connpool_in_use",
    "seaweedfs_connpool_idle",
    "seaweedfs_disk_free_bytes",
    "seaweedfs_disk_total_bytes",
    "seaweedfs_disk_state",
    "seaweedfs_hotkey_",
)


class Metric:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...]):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def labels(self, *values: str):
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name}: want {len(self.label_names)} labels, got {len(key)}"
            )
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def _label_str(self, key: tuple) -> str:
        if not key:
            return ""
        pairs = ",".join(
            f'{n}="{escape_label_value(v)}"'
            for n, v in zip(self.label_names, key)
        )
        return "{" + pairs + "}"


class _CounterChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Counter(Metric):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            out.append(f"{self.name}{self._label_str(key)} {child.value}")
        return out


class _GaugeChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Gauge(Counter):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self.labels().set(v)


class _HistogramChild:
    __slots__ = ("buckets", "counts", "total", "count", "exemplars",
                 "_lock")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0.0
        self.count = 0
        # bucket index (len(buckets) = +Inf) -> [value, trace_id, wall_ts]
        # of the slowest observation in the current exemplar window
        self.exemplars: dict[int, list] = {}
        self._lock = threading.Lock()

    def observe(self, v: float, trace_id: str | None = None) -> None:
        with self._lock:
            self.total += v
            self.count += 1
            idx = len(self.buckets)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    idx = min(idx, i)
            if trace_id:
                cur = self.exemplars.get(idx)
                now = time.time()
                # keep the slowest sample per bucket, but let it rotate:
                # a stale all-time max would pin a page's exemplar to an
                # incident long resolved
                if (cur is None or v >= cur[0]
                        or now - cur[2] > EXEMPLAR_WINDOW_S):
                    self.exemplars[idx] = [v, trace_id, now]

    def time(self):
        return _Timer(self)


class _Timer:
    def __init__(self, hist):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, help_, label_names=(), buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(buckets)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float, trace_id: str | None = None) -> None:
        self.labels().observe(v, trace_id=trace_id)

    def exemplars(self) -> list[dict]:
        """Per-bucket slowest-sample exemplars across every child:
        [{labels, le, value, traceId, ageSeconds}], newest-window data
        only (entries older than 2x the window are dropped — the alert
        that wants them has already evaluated)."""
        now = time.time()
        with self._lock:
            items = list(self._children.items())
        out: list[dict] = []
        for key, child in items:
            with child._lock:
                entries = [(i, list(e)) for i, e in child.exemplars.items()]
            for idx, (value, trace_id, ts) in entries:
                age = now - ts
                if age > 2 * EXEMPLAR_WINDOW_S:
                    continue
                le = (format_le(self.buckets[idx])
                      if idx < len(self.buckets) else "+Inf")
                out.append({
                    "family": self.name,
                    "labels": dict(zip(self.label_names, key)),
                    "le": le,
                    "value": round(value, 6),
                    "traceId": trace_id,
                    "ageSeconds": round(age, 3),
                })
        return out

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            base = dict(zip(self.label_names, key))
            for b, c in zip(child.buckets, child.counts):
                labels = {**base, "le": format_le(b)}
                pairs = ",".join(
                    f'{n}="{escape_label_value(v)}"'
                    for n, v in labels.items()
                )
                out.append(f"{self.name}_bucket{{{pairs}}} {c}")
            inf_pairs = ",".join(
                f'{n}="{escape_label_value(v)}"'
                for n, v in {**base, "le": "+Inf"}.items()
            )
            out.append(f"{self.name}_bucket{{{inf_pairs}}} {child.count}")
            ls = self._label_str(key)
            out.append(f"{self.name}_sum{ls} {child.total}")
            out.append(f"{self.name}_count{ls} {child.count}")
        return out


class Registry:
    def __init__(self):
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "", labels: tuple = ()) -> Counter:
        return self._get_or_make(Counter, name, help_, tuple(labels))

    def gauge(self, name: str, help_: str = "", labels: tuple = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help_, tuple(labels))

    def histogram(self, name: str, help_: str = "", labels: tuple = (),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help_, tuple(labels), buckets)
                self._metrics[name] = m
            elif (type(m) is not Histogram
                  or m.label_names != tuple(labels)):
                raise ValueError(self._conflict(name, m))
            return m

    def _get_or_make(self, cls, name, help_, labels):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, labels)
                self._metrics[name] = m
            elif type(m) is not cls or m.label_names != labels:
                # two call sites disagreeing about a family is a bug that
                # silently corrupts one of them — fail at import, loudly
                raise ValueError(self._conflict(name, m))
            return m

    @staticmethod
    def _conflict(name: str, existing: Metric) -> str:
        return (f"metric family {name!r} already registered as "
                f"{existing.kind} with labels {existing.label_names}; "
                "register every family exactly once (stats/metrics.py)")

    def family(self, name: str) -> "Metric | None":
        """The registered family, trying histogram base names too (so
        `foo_seconds_bucket` resolves to the `foo_seconds` histogram)."""
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                return m
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix):
                    m = self._metrics.get(name[: -len(suffix)])
                    if m is not None and m.kind == "histogram":
                        return m
        return None

    def render(self, family_prefixes: "list[str] | None" = None) -> str:
        """Text exposition; `family_prefixes` (from ?family=) restricts
        the output to families whose name starts with any prefix — the
        SLO engine and operators scrape a subset instead of the full
        exposition on every evaluation tick."""
        with self._lock:
            metrics = list(self._metrics.values())
        if family_prefixes is not None:
            metrics = [m for m in metrics
                       if any(m.name.startswith(p) for p in family_prefixes)]
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def exemplars(self, family_prefix: str = "") -> list[dict]:
        """Histogram exemplars (slowest recent sample per bucket) for
        families matching the prefix, slowest first — the trace ids a
        firing latency alert embeds so /cluster/alerts links straight to
        /cluster/traces."""
        with self._lock:
            metrics = [m for m in self._metrics.values()
                       if m.kind == "histogram"
                       and m.name.startswith(family_prefix)]
        out: list[dict] = []
        for m in metrics:
            out.extend(m.exemplars())
        out.sort(key=lambda e: e["value"], reverse=True)
        return out[:32]

    def snapshot_samples(self, max_samples: int = 512) -> list:
        """-> [(exposition sample name incl. labels, float value)] for
        every counter and gauge child — the compact stats snapshot a full
        heartbeat carries to the master.  Histograms are skipped, and the
        high-cardinality families (SNAPSHOT_DENY_PREFIXES) come last."""
        with self._lock:
            metrics = list(self._metrics.values())
        metrics.sort(key=lambda m: (
            1 if m.name.startswith(SNAPSHOT_DENY_PREFIXES) else 0))
        out = []
        for m in metrics:
            if m.kind not in ("counter", "gauge"):
                continue
            with m._lock:
                items = list(m._children.items())
            for key, child in items:
                out.append((f"{m.name}{m._label_str(key)}",
                            float(child.value)))
                if len(out) >= max_samples:
                    return out
        return out


REGISTRY = Registry()

# -- requests and volumes (stats/metrics.go:25-123) --------------------------
REQUEST_COUNTER = REGISTRY.counter(
    "seaweedfs_request_total", "requests by server type and operation",
    labels=("type", "op"),
)
REQUEST_HISTOGRAM = REGISTRY.histogram(
    "seaweedfs_request_seconds", "request latency", labels=("type", "op"),
)
VOLUME_GAUGE = REGISTRY.gauge(
    "seaweedfs_volumes", "volumes hosted, by collection and kind",
    labels=("collection", "type"),
)
DISK_SIZE_GAUGE = REGISTRY.gauge(
    "seaweedfs_disk_size_bytes", "stored bytes by collection and kind",
    labels=("collection", "type"),
)
GRPC_BYTES = REGISTRY.counter(
    "seaweedfs_grpc_bytes_total",
    "serialized gRPC message bytes through this server, by rpc and "
    "direction — the exact wire payload (sans HTTP/2 framing)",
    labels=("type", "op", "direction"),  # rx | tx
)
STALE_EPOCH_REJECTED = REGISTRY.counter(
    "seaweedfs_stale_epoch_rejected_total",
    "volume-server rpcs refused because they carried a deposed leader's "
    "epoch, by rpc method",
    labels=("method",),
)

# -- fault-tolerance layer (util/failsafe.py) --------------------------------
RETRY_COUNTER = REGISTRY.counter(
    "seaweedfs_retry_total",
    "retried failures by caller type, operation and failure reason",
    labels=("type", "op", "reason"),
)
CIRCUIT_STATE = REGISTRY.gauge(
    "seaweedfs_circuit_state",
    "per-peer circuit breaker state (0 closed, 1 open, 2 half-open)",
    labels=("peer",),
)
CIRCUIT_TRANSITIONS = REGISTRY.counter(
    "seaweedfs_circuit_transitions_total",
    "circuit breaker state transitions by peer and target state",
    labels=("peer", "to"),
)

# -- partial-sum repair protocol (storage/ec/partial.py) ---------------------
# sources stream coefficient-weighted GF(2^8) sums instead of raw shard
# intervals; `serve` counts bytes a source computed and streamed out,
# `recv` the aggregated partial bytes a rebuilder pulled in, `req` the
# request bytes (coefficients) it sent
EC_PARTIAL_BYTES = REGISTRY.counter(
    "seaweedfs_ec_partial_bytes_total",
    "partial-sum repair bytes by direction",
    labels=("op",),  # serve | recv | req
)
EC_PARTIAL_JOBS = REGISTRY.counter(
    "seaweedfs_ec_partial_jobs_total",
    "partial-sum repair requests by role and outcome",
    labels=("kind", "result"),  # kind: serve|fetch; result: ok|error
)
EC_PARTIAL_FALLBACK = REGISTRY.counter(
    "seaweedfs_ec_partial_fallback_total",
    "partial-sum repairs that degraded to the full-shard fetch path",
    labels=("path",),  # rebuild | degraded
)


# -- EC codec service (ops/codec_service.py) --------------------------------
# one bounded queue between every GF caller (encode, rebuild) and the
# compute backend; the scheduler coalesces same-matrix jobs into batches.
# Occupancy near 1 under load means the producers are not concurrent
# enough to batch; queue_depth pinned at the bound means the backend is the
# bottleneck (backpressure engaged).

EC_SERVICE_QUEUE_DEPTH = REGISTRY.gauge(
    "seaweedfs_ec_service_queue_depth",
    "codec-service jobs submitted but not yet scheduled into a batch",
)
EC_SERVICE_INFLIGHT = REGISTRY.gauge(
    "seaweedfs_ec_service_inflight_batches",
    "codec-service batches dispatched to the device, results not yet read back",
)
EC_SERVICE_BATCH_JOBS = REGISTRY.histogram(
    "seaweedfs_ec_service_batch_jobs",
    "jobs coalesced into each codec-service batch (occupancy)",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0),
)
EC_SERVICE_BATCH_BYTES = REGISTRY.histogram(
    "seaweedfs_ec_service_batch_bytes",
    "input bytes per codec-service batch",
    buckets=_EC_BYTE_BUCKETS,
)
EC_SERVICE_FLUSH = REGISTRY.counter(
    "seaweedfs_ec_service_flush_total",
    "codec-service batch flushes by trigger",
    labels=("reason",),  # full | bytes | ready | drain
)
EC_SERVICE_JOBS = REGISTRY.counter(
    "seaweedfs_ec_service_jobs_total",
    "codec-service jobs by kind and outcome",
    labels=("kind", "result"),  # parity|apply x ok|error
)
EC_SERVICE_JOB_SECONDS = REGISTRY.histogram(
    "seaweedfs_ec_service_job_seconds",
    "codec-service job wall time, submit to delivered result",
    labels=("kind",),
)
EC_SERVICE_STAGE = REGISTRY.histogram(
    "seaweedfs_ec_service_stage_seconds",
    "per-batch wall time in each codec-service stage",
    labels=("stage",),  # build | compute | readback
)


# -- the hand-written CUDA kernels (ops/rs_cuda.py) --------------------------
# one count per launch, added where each wrapper adds one to its own
# `launches` counter: the only view of a server process's launches from
# outside it (chip_smoke.py's cluster phase reads it from /metrics)

CUDA_KERNEL_LAUNCHES = REGISTRY.counter(
    "seaweedfs_cuda_kernel_launches_total",
    "launches of the port's CUDA kernels, by kernel",
    # gf_matmul (gf_apply) | gf_matmul_batched | gf_xor (rs_xor) |
    # gf_bitplane_mma (rs_bitplane)
    labels=("kernel",),
)

# -- EC codec operations (ops/codec.py::InstrumentedCodec) -------------------
# every blocking codec call through get_codec, by op and by the backend
# that did the GF work (impl="cuda", "cpu", "torch_cpu")

EC_OP_HISTOGRAM = REGISTRY.histogram(
    "seaweedfs_ec_op_seconds", "EC codec operation latency",
    labels=("op", "impl"),
)
EC_BYTES_HISTOGRAM = REGISTRY.histogram(
    "seaweedfs_ec_op_bytes", "bytes processed per EC codec operation",
    labels=("op", "impl"), buckets=_EC_BYTE_BUCKETS,
)

# -- EC repair data plane (storage/ec/encoder.py::rebuild_ec_files) -----------

EC_REBUILD_SECONDS = REGISTRY.histogram(
    "seaweedfs_ec_rebuild_seconds", "wall time per EC shard rebuild",
    labels=("impl",), buckets=(0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0),
)
EC_REBUILD_BYTES = REGISTRY.counter(
    "seaweedfs_ec_rebuild_bytes_total",
    "source bytes consumed by EC shard rebuilds, by origin locality",
    labels=("source",),  # local (this node) | rack (same rack) | dc (beyond)
)
EC_REBUILD_SHARDS = REGISTRY.counter(
    "seaweedfs_ec_rebuild_shards_total", "shard files reconstructed",
)
EC_REBUILD_RESULT = REGISTRY.counter(
    "seaweedfs_ec_rebuild_total", "rebuild attempts by outcome",
    labels=("result",),  # ok | error
)

# -- EC degraded reads (storage/ec/volume.py) ---------------------------------
# reconstructed-interval LRU, single-flight coalescing, and the batched
# preadv of a needle's contiguous shard runs

EC_INTERVAL_CACHE = REGISTRY.counter(
    "seaweedfs_ec_interval_cache_total",
    "reconstructed-interval cache lookups and evictions by result",
    labels=("result",),  # hit | miss | evict
)
EC_SINGLEFLIGHT = REGISTRY.counter(
    "seaweedfs_ec_singleflight_total",
    "degraded-read interval reconstructions by single-flight role",
    labels=("result",),  # leader | coalesced
)
EC_PREADV_BATCHES = REGISTRY.counter(
    "seaweedfs_ec_preadv_batches_total",
    "contiguous EC shard interval runs gathered with one preadv",
)

# -- executors (util/executors.py::MeteredThreadPoolExecutor) -----------------
# saturation is `active == max and queue_depth > 0`

EXECUTOR_QUEUE_DEPTH = REGISTRY.gauge(
    "seaweedfs_executor_queue_depth",
    "tasks submitted to a pool but not yet started",
    labels=("executor",),
)
EXECUTOR_ACTIVE = REGISTRY.gauge(
    "seaweedfs_executor_active_workers",
    "pool tasks currently executing",
    labels=("executor",),
)
EXECUTOR_MAX = REGISTRY.gauge(
    "seaweedfs_executor_max_workers",
    "pool worker capacity (saturation = active / max)",
    labels=("executor",),
)

# -- fault injection (util/faultpoint.py) -------------------------------------

FAULT_COUNTER = REGISTRY.counter(
    "seaweedfs_fault_injected_total",
    "faults injected by point name",
    labels=("point",),
)

# -- disk-fault survival plane (storage/disk_health.py) -----------------------
# per data directory: free/total bytes and the state machine's verdict
# (0 healthy, 1 low_space, 2 full, 3 failing)

DISK_FREE_GAUGE = REGISTRY.gauge(
    "seaweedfs_disk_free_bytes", "free bytes on a data directory's filesystem",
    labels=("dir",),
)
DISK_TOTAL_GAUGE = REGISTRY.gauge(
    "seaweedfs_disk_total_bytes",
    "total bytes on a data directory's filesystem",
    labels=("dir",),
)
DISK_STATE_GAUGE = REGISTRY.gauge(
    "seaweedfs_disk_state",
    "disk health state (0=healthy 1=low_space 2=full 3=failing)",
    labels=("dir",),
)
DISK_WRITE_ERROR = REGISTRY.counter(
    "seaweedfs_disk_write_errors_total",
    "classified storage-write failures by kind",
    labels=("kind",),  # enospc | eio | short | other
)

# -- hot-needle cache (util/chunk_cache.py::NeedleCache) ---------------------

NEEDLE_CACHE_HIT = REGISTRY.counter(
    "seaweedfs_needle_cache_hit_total", "needle reads served from cache",
)
NEEDLE_CACHE_MISS = REGISTRY.counter(
    "seaweedfs_needle_cache_miss_total", "needle reads that missed the cache",
)
NEEDLE_CACHE_EVICT = REGISTRY.counter(
    "seaweedfs_needle_cache_evict_total",
    "needles evicted from the cache by the byte bound",
)

# -- scrubber (storage/scrub.py) and vacuum's corrupt-needle skips ------------

SCRUB_BYTES = REGISTRY.counter(
    "seaweedfs_scrub_bytes_total",
    "bytes read and verified by the scrubber, by target kind",
    labels=("kind",),  # volume | ec
)
SCRUB_NEEDLES = REGISTRY.counter(
    "seaweedfs_scrub_needles_total",
    "records verified by the scrubber, by kind and result",
    labels=("kind", "result"),  # volume|ec x ok|corrupt|skipped
)
SCRUB_ERRORS = REGISTRY.counter(
    "seaweedfs_scrub_errors_total",
    "corruption findings by origin",
    labels=("kind",),  # needle | shard | index | vacuum | read_path
)
SCRUB_REPAIRS = REGISTRY.counter(
    "seaweedfs_scrub_repairs_total",
    "self-healing repair attempts by kind and outcome",
    labels=("kind", "result"),  # replica|ec_shard|index x ok|error
)

# -- the master (master/server.py) --------------------------------------------

VOLUME_UNDERREPLICATED = REGISTRY.gauge(
    "seaweedfs_volume_underreplicated",
    "volumes with fewer live replicas than their placement requires",
)

# -- the lifecycle controller (maintenance/controller.py) ---------------------
# journaled jobs: seal -> ec_encode -> vacuum -> rebalance -> ttl_expire.
# `jobs` counts job executions by outcome (ok | error | parked | resumed),
# `transitions` counts completed volume state changes, and bytes/seconds
# attribute the background I/O the shared token bucket paces.

LIFECYCLE_JOBS = REGISTRY.counter(
    "seaweedfs_lifecycle_jobs_total",
    "lifecycle job executions by transition and outcome",
    labels=("transition", "result"),  # ok | error | parked | resumed
)
LIFECYCLE_BYTES = REGISTRY.counter(
    "seaweedfs_lifecycle_bytes_total",
    "bytes moved/processed by lifecycle jobs, by transition",
    labels=("transition",),
)
LIFECYCLE_SECONDS = REGISTRY.histogram(
    "seaweedfs_lifecycle_seconds",
    "wall time per lifecycle job, throttle wait included",
    labels=("transition",),
    buckets=(0.01, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0),
)
LIFECYCLE_TRANSITIONS = REGISTRY.counter(
    "seaweedfs_lifecycle_transitions_total",
    "completed volume lifecycle transitions by result",
    labels=("transition", "result"),  # ok | error
)
LIFECYCLE_QUEUE_DEPTH = REGISTRY.gauge(
    "seaweedfs_lifecycle_queue_depth",
    "lifecycle jobs journaled but not yet finished (pending + running)",
)

# -- dead-node mass repair (maintenance/mass_repair.py) -----------------------
# a dead node becomes one planned batch: volumes ranked by exposure (fewest
# surviving shards first), rebuild targets spread across the survivors, one
# VolumeEcShardsBatchRebuild per target.  bytes + seconds give the
# aggregate repair GB/s; deadline slack tracks the total-repair-time bound.

REPAIR_BATCH_QUEUE_DEPTH = REGISTRY.gauge(
    "seaweedfs_repair_batch_queue_depth",
    "mass-repair volume jobs journaled but not yet finished",
)
REPAIR_BATCH_VOLUMES = REGISTRY.counter(
    "seaweedfs_repair_batch_volumes_total",
    "volumes planned into mass-repair batches by exposure class "
    "(surviving shards above the 10-shard decode floor; lost = below it)",
    labels=("exposure",),  # "0" | "1" | "2" | "3" | "lost"
)
REPAIR_BATCH_JOBS = REGISTRY.counter(
    "seaweedfs_repair_batch_jobs_total",
    "mass-repair volume rebuild executions by outcome",
    labels=("result",),  # ok | error | parked | resumed
)
REPAIR_BATCH_BYTES = REGISTRY.counter(
    "seaweedfs_repair_batch_bytes_total",
    "shard bytes reconstructed by completed mass-repair jobs",
)
REPAIR_BATCH_SECONDS = REGISTRY.histogram(
    "seaweedfs_repair_batch_seconds",
    "wall time per mass-repair wave (one pass over the pending batch)",
    buckets=(0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0),
)
REPAIR_BATCH_DEADLINE_SLACK = REGISTRY.gauge(
    "seaweedfs_repair_batch_deadline_slack_seconds",
    "configured mass-repair deadline minus projected completion time",
)
DISK_EVACUATE_COUNTER = REGISTRY.counter(
    "seaweedfs_disk_evacuations_total",
    "proactive failing-disk evacuation moves by kind and outcome",
    labels=("kind", "result"),  # kind: ec_shard|volume; result: ok|error
)

# -- group commit (storage/group_commit.py) -----------------------------------
# one fsync pair acks a whole batch of appends, so commits_total <<
# writes_total is the win being measured

FSYNC_BATCH_COMMITS = REGISTRY.counter(
    "seaweedfs_fsync_batch_commits_total",
    "group-commit flush barriers executed (one fsync pair per commit)",
)
FSYNC_BATCH_WRITES = REGISTRY.counter(
    "seaweedfs_fsync_batch_writes_total",
    "volume mutations acked through a group-commit flush barrier",
)
_FSYNC_BATCH_BUCKETS = tuple(float(2 ** k) for k in range(0, 9))  # 1..256
FSYNC_BATCH_SIZE = REGISTRY.histogram(
    "seaweedfs_fsync_batch_size",
    "mutations committed per flush barrier",
    buckets=_FSYNC_BATCH_BUCKETS,
)


# -- the volume server's HTTP side ------------------------------------------
VOLUME_FULL_REJECT = REGISTRY.counter(
    "seaweedfs_volume_full_rejects_total",
    "writes rejected with the typed volume-full (409) error",
)
REPLICATION_ERROR = REGISTRY.counter(
    "seaweedfs_replication_error_total",
    "replica fan-out failures by operation",
    labels=("op",),
)

# keep-alive connection pool (util/connpool.py): every internal HTTP hop
# either reuses a pooled socket or pays a fresh dial; evictions count
# sockets dropped for staleness, pool overflow, or a dead keep-alive
CONNPOOL_REUSE = REGISTRY.counter(
    "seaweedfs_connpool_reuse_total",
    "internal HTTP requests served on a reused pooled connection",
)
CONNPOOL_DIAL = REGISTRY.counter(
    "seaweedfs_connpool_dial_total",
    "fresh TCP dials made by the connection pool",
)
CONNPOOL_EVICT = REGISTRY.counter(
    "seaweedfs_connpool_evict_total",
    "pooled connections discarded (idle-expired, overflow, or dead)",
)

# per-peer connection accounting for the keep-alive pool: in_use counts
# sockets checked out to in-flight requests, idle counts sockets parked
# in the pool.  in_use pinned at its ceiling = the peer is saturated.
CONNPOOL_IN_USE = REGISTRY.gauge(
    "seaweedfs_connpool_in_use",
    "pooled connections checked out to in-flight requests, per peer",
    labels=("peer",),
)
CONNPOOL_IDLE = REGISTRY.gauge(
    "seaweedfs_connpool_idle",
    "idle pooled connections, per peer",
    labels=("peer",),
)

SENDFILE_BYTES = REGISTRY.counter(
    "seaweedfs_sendfile_bytes_total",
    "needle payload bytes served zero-copy via os.sendfile",
)
SENDFILE_FALLBACK = REGISTRY.counter(
    "seaweedfs_sendfile_fallback_total",
    "whole-needle GETs that fell back to the userspace read path",
    labels=("reason",),  # disabled|cache|range|transform|ec|remote|error
)
HTTPD_OPEN_SOCKETS = REGISTRY.gauge(
    "seaweedfs_httpd_open_sockets",
    "connections currently parked on an event-loop HTTP front end",
    labels=("server",),
)
HTTPD_INFLIGHT = REGISTRY.gauge(
    "seaweedfs_httpd_inflight_requests",
    "requests currently executing on an event-loop worker pool",
    labels=("server",),
)

# heavy-hitter attribution sketches (telemetry/hotkeys.py).
# hotkey_top_count is per key and therefore deny-listed from the heartbeat
# snapshot (SNAPSHOT_DENY_PREFIXES); its cardinality is bounded by the
# recorder, which replaces the child set wholesale on every window rotation
HOTKEY_EVENTS = REGISTRY.counter(
    "seaweedfs_hotkey_events_total",
    "keys fed to the heavy-hitter sketches, by dimension",
    labels=("dim",),  # needle | bucket | tenant | peer
)
HOTKEY_TRACKED = REGISTRY.gauge(
    "seaweedfs_hotkey_tracked_keys",
    "keys currently tracked by a dimension's space-saving sketch",
    labels=("dim",),
)
HOTKEY_TOP = REGISTRY.gauge(
    "seaweedfs_hotkey_top_count",
    "estimated hits of the hottest keys in the last closed window",
    labels=("dim", "key"),
)


# -- raft consensus (master/raft.py) ----------------------------------------
# one gauge set per quorum member (`node` = ip:port) so a federated scrape
# of three masters shows term skew, commit lag and role at a glance; the
# leader-change counter is what the flap SLO pages on.

RAFT_TERM = REGISTRY.gauge(
    "seaweedfs_raft_term", "current raft term", labels=("node",),
)
RAFT_ROLE = REGISTRY.gauge(
    "seaweedfs_raft_role",
    "raft role (0 follower, 1 candidate, 2 leader)",
    labels=("node",),
)
RAFT_COMMIT_INDEX = REGISTRY.gauge(
    "seaweedfs_raft_commit_index", "highest committed log index",
    labels=("node",),
)
RAFT_LOG_ENTRIES = REGISTRY.gauge(
    "seaweedfs_raft_log_entries", "entries in the raft log",
    labels=("node",),
)
RAFT_LEADER_CHANGES = REGISTRY.counter(
    "seaweedfs_raft_leader_changes_total",
    "times this node gained or lost leadership",
    labels=("node",),
)
RAFT_RPC = REGISTRY.counter(
    "seaweedfs_raft_rpc_total",
    "outbound raft rpcs by type (vote|append) and result (ok|error|dropped)",
    labels=("type", "result"),
)

# -- SLO engine and canary (telemetry/slo.py, telemetry/canary.py) ----------
# the master-resident judgment layer: declarative SLO specs evaluated as
# multi-window multi-burn-rate rules over federated counter deltas, fed
# by a black-box canary prober (write/read/delete round trips, EC
# degraded-read, filer/S3 routed PUT/GET, geo sentinel) so "process up
# but serving garbage or slow" pages.

SLO_BURN_RATE = REGISTRY.gauge(
    "seaweedfs_slo_burn_rate",
    "error-budget burn rate per SLO and evaluation window (1.0 = "
    "burning exactly the budget; the page tier fires at its factor in "
    "BOTH windows)",
    labels=("slo", "window"),  # short | long
)
SLO_ALERT_STATE = REGISTRY.gauge(
    "seaweedfs_slo_alert_state",
    "per-SLO alert state (0 ok, 1 pending, 2 firing)",
    labels=("slo", "severity"),  # page | warn
)
SLO_TRANSITIONS = REGISTRY.counter(
    "seaweedfs_slo_alert_transitions_total",
    "alert state-machine transitions by SLO and target state",
    labels=("slo", "to"),  # pending | firing | resolved
)
SLO_EVAL_SECONDS = REGISTRY.histogram(
    "seaweedfs_slo_eval_seconds",
    "wall time per SLO engine evaluation tick (scrape + rule pass)",
)
CANARY_PROBE_TOTAL = REGISTRY.counter(
    "seaweedfs_canary_probe_total",
    "synthetic canary probes by probe kind and outcome; `error` counts "
    "failed or byte-divergent round trips, `skipped` counts probes with "
    "no eligible target",
    labels=("probe", "result"),  # ok | error | skipped
)
CANARY_PROBE_SECONDS = REGISTRY.histogram(
    "seaweedfs_canary_probe_seconds",
    "end-to-end canary probe latency (the black-box SLI the latency "
    "SLOs judge)",
    labels=("probe",),
)
CANARY_STALENESS = REGISTRY.gauge(
    "seaweedfs_canary_staleness_seconds",
    "seconds since a probe kind last fully succeeded (for the geo "
    "sentinel: age of the sentinel payload observed on the remote "
    "cluster)",
    labels=("probe",),
)

# -- flight recorder (master/flight.py) ---------------------------------------
DEBUG_BUNDLES = REGISTRY.counter(
    "seaweedfs_debug_bundles_total",
    "cluster debug bundles captured, by trigger and outcome",
    labels=("trigger", "result"),  # alert|manual ; ok|error
)
DEBUG_BUNDLE_SECONDS = REGISTRY.histogram(
    "seaweedfs_debug_bundle_capture_seconds",
    "wall time to fan out and persist one cluster debug bundle",
)

# the filer (filer/server.py, filer/meta_log.py, filer/fleet/tenant.py)
CHUNK_CACHE_COUNTER = REGISTRY.counter(
    "seaweedfs_chunk_cache_total", "chunk cache lookups by result",
    labels=("result",),
)
META_LISTENER_ERRORS = REGISTRY.counter(
    "seaweedfs_meta_listener_errors_total",
    "metadata-log listener callback failures; `evicted` counts listeners "
    "unsubscribed after too many consecutive failures",
    labels=("result",),  # error | evicted
)
TENANT_INFLIGHT = REGISTRY.gauge(
    "seaweedfs_tenant_inflight",
    "admitted in-flight filer requests per tenant",
    labels=("tenant",),
)
TENANT_ADMIT = REGISTRY.counter(
    "seaweedfs_tenant_admit_total",
    "filer admission decisions per tenant",
    labels=("tenant", "result"),  # ok | slowdown
)
TENANT_USAGE_BYTES = REGISTRY.gauge(
    "seaweedfs_tenant_usage_bytes",
    "logical bytes stored per tenant on this filer shard",
    labels=("tenant",),
)
TENANT_USAGE_OBJECTS = REGISTRY.gauge(
    "seaweedfs_tenant_usage_objects",
    "objects stored per tenant on this filer shard",
    labels=("tenant",),
)



def serve_metrics(port: int, registry: Registry = REGISTRY,
                  host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Expose GET /metrics (Prometheus text) and GET /debug/traces (JSON)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            import urllib.parse

            path = self.path.split("?")[0]
            if path.startswith("/debug/"):
                from ..telemetry import serve_debug_http

                if serve_debug_http(self, path):
                    return
            if path != "/metrics":
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            query = urllib.parse.parse_qs(
                urllib.parse.urlparse(self.path).query)
            try:
                prefixes = parse_family_prefixes(
                    query.get("family", [""])[0])
            except ValueError as e:
                body = str(e).encode()
                self.send_response(400)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            body = registry.render(prefixes).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = FrameworkHTTPServer((host, port), Handler)
    httpd.serve_thread = threading.Thread(
        target=httpd.serve_forever, name="metrics-http", daemon=True)
    httpd.serve_thread.start()
    return httpd
