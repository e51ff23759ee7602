"""A small Prometheus-style registry: counters, gauges and histograms with
labels — the port's own copy of the registry classes of
seaweedfs_tpu/stats/metrics.py, and of the families the port's modules
record: the codec service, the codec registry, the EC read path and its
caches, the rebuild, the executors, fault injection, disk health, the
needle cache, the scrubber and group commit (names, labels and buckets
unchanged, so dashboards built on the reference read the port the same
way).

Not carried over: exemplars, the HTTP /metrics endpoint, and every family
of the servers.
"""

from __future__ import annotations

import threading
import time

_DEFAULT_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
_EC_BYTE_BUCKETS = tuple(float(4 ** k) for k in range(5, 16))  # 1KB..1GB


def escape_label_value(v: str) -> str:
    """Prometheus text exposition: label values escape \\, \" and newline."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def format_le(bound: float) -> str:
    """Render a bucket bound as a float consistently (`10.0`, not `10`)."""
    return repr(float(bound))


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
    __slots__ = ("buckets", "counts", "total", "count", "_lock")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.total += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1

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

    def observe(self, v: float) -> None:
        self.labels().observe(v)

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

    def render(self, family_prefixes: "list[str] | None" = None) -> str:
        """Text exposition, optionally restricted to families whose name
        starts with one of `family_prefixes`."""
        with self._lock:
            metrics = list(self._metrics.values())
        if family_prefixes is not None:
            metrics = [m for m in metrics
                       if any(m.name.startswith(p) for p in family_prefixes)]
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()


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
