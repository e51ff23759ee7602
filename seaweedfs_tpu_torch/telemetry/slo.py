"""SLO engine: multi-window multi-burn-rate judgment over cluster SLIs —
the port's copy of seaweedfs_tpu/telemetry/slo.py.  Port difference:
`stop()` joins the evaluation thread (``master-slo-engine``); the reference
leaves a daemon thread.

The cluster emits rich passive signals (federated /cluster/metrics,
heartbeat snapshots) and the canary plane emits active ones, but nothing
*judged* them: an operator had no answer to "is the cluster meeting its
SLOs right now, and if not, which trace shows why".  This module is the
master-resident answer — declarative SLO specs evaluated as burn-rate
rules over windowed counter deltas, an alert state machine with bounded
history, and pluggable sinks.

Burn rate is the SRE-workbook quantity: (observed error rate) / (error
budget rate).  Burning at 1.0 spends exactly the budget over the SLO
period; the page tier fires when BOTH a fast short window and a longer
confirmation window burn above a factor (default 5m/1h at 14.4x — the
classic "2% of a 30-day budget in one hour" rule), so a blip can't page
but a real incident pages within the short window.  The warn tier runs
slow windows (6h/3d at 1.0x) for budget-trending problems.  Windows
scale uniformly via SEAWEEDFS_TPU_SLO_WINDOW_SCALE (or the engine's
`window_scale` argument) so tests and small clusters can evaluate the
same rules at second-scale.

Three SLI kinds:

* ``ratio``   — bad/total counter deltas (canary probe failures,
  request errors); burn = (bad/total) / (1 - objective).
* ``latency`` — histogram bucket deltas: bad = requests above the
  threshold bucket; same burn arithmetic.  Firing latency alerts embed
  the exemplar trace ids the histograms recorded, so a page is one hop
  from `/cluster/alerts` to `/cluster/traces?trace=<id>`.
* ``gauge``   — a level signal (geo lag, queue depth): pending the
  moment the threshold is crossed, firing once it has held for
  ``for_s``, resolved when it drops back.
* ``event``   — a counter delta over the SHORT window (volumes newly
  dropped below redundancy): fires the moment ``threshold`` events land
  in the window, resolves when the window rolls past them.  A gauge
  would miss a spike a fast repair drains between two evaluation ticks;
  the counter cannot un-happen.

Grounding: arXiv:1309.0186 measures the operational cost of discovering
degraded redundancy late (~98 lost-block events/day at warehouse scale);
arXiv:1709.05365 shows online-EC tail latency diverging from medians
exactly when passive averages look healthy — both argue for burn-rate
evaluation plus active probing over more raw gauges.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..stats.metrics import (
    SLO_ALERT_STATE,
    SLO_BURN_RATE,
    SLO_EVAL_SECONDS,
    SLO_TRANSITIONS,
)
from ..util import glog
from .federation import parse_exposition

WINDOW_SCALE_ENV = "SEAWEEDFS_TPU_SLO_WINDOW_SCALE"

# alert states, also the seaweedfs_slo_alert_state gauge encoding
OK, PENDING, FIRING = "ok", "pending", "firing"
_STATE_VALUE = {OK: 0, PENDING: 1, FIRING: 2}


@dataclass(frozen=True)
class BurnWindow:
    """One multi-window burn-rate rule: fire when burn exceeds `factor`
    in BOTH the short and the long window (pending on short-only)."""

    short_s: float
    long_s: float
    factor: float


# page tier: 5m/1h at 14.4x (2% of a 30d budget in 1h); warn tier:
# 6h/3d at 1.0x (burning at budget pace for days)
PAGE_WINDOW = BurnWindow(300.0, 3600.0, 14.4)
WARN_WINDOW = BurnWindow(21600.0, 259200.0, 1.0)

_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def sample_labels(sample_name: str) -> tuple[str, dict]:
    """`name{a="b",c="d"}` -> ("name", {"a": "b", "c": "d"})."""
    brace = sample_name.find("{")
    if brace < 0:
        return sample_name, {}
    name = sample_name[:brace]
    labels = {
        k: v.replace('\\"', '"').replace("\\\\", "\\").replace("\\n", "\n")
        for k, v in _LABEL_RE.findall(sample_name[brace:])
    }
    return name, labels


def _matches(labels: dict, want: "dict | None") -> bool:
    """`want` values are a string or a tuple of accepted strings."""
    if not want:
        return True
    for k, v in want.items():
        got = labels.get(k)
        if isinstance(v, (tuple, list, set)):
            if got not in v:
                return False
        elif got != v:
            return False
    return True


@dataclass
class SloSpec:
    """One declarative SLO.  `kind` selects which fields apply:

    ratio:   bad_family/bad_labels over total_family/total_labels
    latency: family/labels histogram, threshold_s, objective
    gauge:   family/labels level >= threshold for for_s seconds
    """

    name: str
    severity: str  # "page" | "warn"
    kind: str  # "ratio" | "latency" | "gauge" | "event"
    description: str = ""
    # ratio
    bad_family: str = ""
    bad_labels: dict = field(default_factory=dict)
    total_family: str = ""
    total_labels: dict = field(default_factory=dict)
    objective: float = 0.999
    # latency (reuses objective)
    family: str = ""
    labels: dict = field(default_factory=dict)
    threshold_s: float = 0.5
    # gauge
    threshold: float = 1.0
    for_s: float = 0.0
    # overrides / linking
    window: "BurnWindow | None" = None
    exemplar_family: str = ""

    def burn_window(self) -> BurnWindow:
        if self.window is not None:
            return self.window
        return PAGE_WINDOW if self.severity == "page" else WARN_WINDOW

    def families(self) -> list[str]:
        """Exposition family prefixes this spec's evaluation needs."""
        out = []
        for f in (self.bad_family, self.total_family, self.family):
            if f and f not in out:
                out.append(f)
        return out

    def to_dict(self) -> dict:
        w = self.burn_window()
        d = {
            "name": self.name, "severity": self.severity,
            "kind": self.kind, "description": self.description,
            "windowShortS": w.short_s, "windowLongS": w.long_s,
            "burnFactor": w.factor,
        }
        if self.kind in ("ratio", "latency"):
            d["objective"] = self.objective
        if self.kind == "latency":
            d["thresholdS"] = self.threshold_s
            d["family"] = self.family
        if self.kind in ("gauge", "event"):
            d["threshold"] = self.threshold
            d["forS"] = self.for_s
            d["family"] = self.family
        return d


def spec_from_dict(d: dict) -> SloSpec:
    """Declarative JSON -> SloSpec (the -sloSpecs file loader).  Window
    override: {"window": {"shortS":, "longS":, "factor":}}."""
    d = dict(d)
    w = d.pop("window", None)
    spec = SloSpec(**d)
    if w is not None:
        spec.window = BurnWindow(float(w["shortS"]), float(w["longS"]),
                                 float(w.get("factor", 1.0)))
    return spec


def specs_from_json(path: str) -> list[SloSpec]:
    with open(path) as f:
        return [spec_from_dict(d) for d in json.load(f)]


def default_specs() -> list[SloSpec]:
    """The stock judgment suite.  Thresholds are env-tunable where a
    deployment's hardware moves them."""
    read_p99 = float(os.environ.get("SEAWEEDFS_TPU_SLO_READ_P99_S", "0.5"))
    write_p99 = float(os.environ.get("SEAWEEDFS_TPU_SLO_WRITE_P99_S", "1.0"))
    geo_lag = float(os.environ.get("SEAWEEDFS_TPU_SLO_GEO_LAG_S", "60"))
    backlog = float(os.environ.get("SEAWEEDFS_TPU_SLO_BACKLOG_JOBS", "256"))
    return [
        SloSpec(
            name="availability", severity="page", kind="ratio",
            description="black-box canary round trips succeeding "
                        "(write/read/delete, EC degraded read, routed "
                        "metadata PUT/GET)",
            bad_family="seaweedfs_canary_probe_total",
            bad_labels={"result": "error"},
            total_family="seaweedfs_canary_probe_total",
            total_labels={"result": ("ok", "error")},
            # three nines on the synthetic signal: one stray probe error
            # cannot page (long-window dilution), a dead node's sustained
            # failures page within the short window
            objective=0.999,
            exemplar_family="seaweedfs_canary_probe_seconds",
        ),
        SloSpec(
            name="read-latency-p99", severity="page", kind="latency",
            description="volume-server GET latency under the p99 bound",
            family="seaweedfs_request_seconds",
            labels={"type": "volumeServer", "op": "get"},
            threshold_s=read_p99, objective=0.99,
            exemplar_family="seaweedfs_request_seconds",
        ),
        SloSpec(
            name="write-latency-p99", severity="page", kind="latency",
            description="volume-server POST latency under the p99 bound",
            family="seaweedfs_request_seconds",
            labels={"type": "volumeServer", "op": "post"},
            threshold_s=write_p99, objective=0.99,
            exemplar_family="seaweedfs_request_seconds",
        ),
        SloSpec(
            name="ec-exposure", severity="page", kind="event",
            description="EC volumes newly planned into dead-node mass "
                        "repair in the fast window (shards below full "
                        "redundancy — the lost-block events "
                        "arXiv:1309.0186 measures the cost of "
                        "discovering late)",
            family="seaweedfs_repair_batch_volumes_total",
            threshold=1.0, for_s=0.0,
        ),
        SloSpec(
            name="leader-flapping", severity="page", kind="event",
            description="raft leader changes in the fast window — more "
                        "than a couple means elections are churning "
                        "(partitioned quorum, clock trouble, or an "
                        "overloaded master losing its heartbeats) and "
                        "every flap re-runs the control-plane warm-up "
                        "barrier",
            family="seaweedfs_raft_leader_changes_total",
            threshold=3.0, for_s=0.0,
        ),
        SloSpec(
            name="repair-backlog", severity="warn", kind="gauge",
            description="mass-repair jobs journaled but unfinished — "
                        "sustained depth means repair is not keeping up "
                        "with exposure",
            family="seaweedfs_repair_batch_queue_depth",
            threshold=1.0, for_s=120.0,
        ),
        SloSpec(
            name="under-replication", severity="warn", kind="gauge",
            description="volumes with fewer live replicas than their "
                        "placement requires",
            family="seaweedfs_volume_underreplicated",
            threshold=1.0, for_s=30.0,
        ),
        SloSpec(
            name="geo-lag", severity="warn", kind="gauge",
            description="geo replication link lag",
            family="seaweedfs_geo_lag_seconds",
            threshold=geo_lag, for_s=0.0,
        ),
        SloSpec(
            name="geo-staleness", severity="warn", kind="gauge",
            description="age of the geo sentinel object observed on the "
                        "remote cluster (canary-measured end-to-end lag)",
            family="seaweedfs_canary_staleness_seconds",
            labels={"probe": "geo_sentinel"},
            threshold=2 * geo_lag, for_s=0.0,
        ),
        SloSpec(
            name="maintenance-backlog", severity="warn", kind="gauge",
            description="lifecycle + scrub/repair background jobs "
                        "journaled but unfinished",
            family="seaweedfs_lifecycle_queue_depth",
            threshold=backlog, for_s=60.0,
        ),
    ]


# -- sinks -------------------------------------------------------------------


def log_sink(alert: dict) -> None:
    """Default sink: one glog line per transition (warning for firing,
    info otherwise) — greppable next to the slow-request log."""
    line = ("slo alert %(slo)s [%(severity)s] -> %(state)s "
            "burn=%(burnShort).2f/%(burnLong).2f" % {
                "slo": alert["slo"], "severity": alert["severity"],
                "state": alert["state"],
                "burnShort": alert.get("burnShort", 0.0),
                "burnLong": alert.get("burnLong", 0.0)})
    if alert.get("exemplars"):
        line += " exemplar=" + alert["exemplars"][0]["traceId"]
    (glog.warning if alert["state"] == FIRING else glog.info)(line)


class WebhookSink:
    """POST each alert transition as JSON to a webhook URL.  Failures
    log and drop — the judgment plane must never block on its sink."""

    def __init__(self, url: str, timeout_s: float = 3.0):
        self.url = url
        self.timeout_s = timeout_s

    def __call__(self, alert: dict) -> None:
        from ..util import connpool

        try:
            with connpool.request(
                    "POST", self.url, body=json.dumps(alert).encode(),
                    headers={"Content-Type": "application/json"},
                    timeout=self.timeout_s) as r:
                r.read()
        except Exception as e:  # noqa: BLE001 — sink failure is non-fatal
            glog.warning("alert webhook %s failed: %s", self.url, e)


# -- engine ------------------------------------------------------------------


class SloEngine:
    """Evaluates SLO specs over a scrape function's counter samples.

    `scrape(family_prefixes) -> exposition text` is normally the
    master's federated /cluster/metrics render (with the ?family=
    subset filter, so a tick never pulls the full exposition);
    `exemplars(family_prefix) -> [exemplar dict]` is normally
    REGISTRY.exemplars.  Both are injectable for tests.
    """

    MAX_HISTORY_ENTRIES = 4096

    def __init__(
        self,
        scrape,
        specs: "list[SloSpec] | None" = None,
        sinks=None,
        interval_s: float = 0.0,
        exemplars=None,
        window_scale: "float | None" = None,
        now=time.time,
        max_history: int = 256,
    ):
        self._scrape = scrape
        self.specs = list(specs) if specs is not None else default_specs()
        self.interval_s = interval_s
        self._sinks = list(sinks) if sinks is not None else [log_sink]
        self._exemplars = exemplars
        if window_scale is None:
            window_scale = float(os.environ.get(WINDOW_SCALE_ENV, "1.0"))
        self.window_scale = max(float(window_scale), 1e-6)
        self._now = now
        # (t, {sample_name: value}) ring covering the longest long window
        self._history: deque = deque()
        self._states: dict[str, dict] = {}
        self.alert_history: deque = deque(maxlen=max_history)
        self._lock = threading.RLock()
        # serializes whole evaluations; the state lock above is held
        # only for the cheap history-append + rule pass, so a scrape
        # that eats its full federation budget never blocks
        # /cluster/alerts or /cluster/status reads
        self._eval_mutex = threading.Lock()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._last_eval = 0.0

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self.interval_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="master-slo-engine")
        self._thread.start()

    def stop(self) -> None:
        """Stop the loop and join it (a tick in progress finishes)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception as e:  # noqa: BLE001 — the judge must survive
                glog.warning("slo evaluation failed: %s", e)

    # -- evaluation -------------------------------------------------------

    def families(self) -> list[str]:
        out: list[str] = []
        for spec in self.specs:
            for f in spec.families():
                if f not in out:
                    out.append(f)
        return out

    def _collect(self) -> dict:
        """Scrape + parse, NO locks held: the federation fan-out can
        take seconds when nodes are unreachable."""
        text = self._scrape(self.families())
        _families, samples = parse_exposition(text)
        merged: dict[str, float] = {}
        for _family, sample_name, value in samples:
            try:
                v = float(value)
            except ValueError:
                continue
            # distinct nodes carry distinct instance labels, so samples
            # never truly collide; last write wins on a duplicate
            merged[sample_name] = v
        return merged

    def _ingest(self, t: float, merged: dict) -> None:
        self._history.append((t, merged))
        horizon = max(
            (s.burn_window().long_s for s in self.specs), default=3600.0
        ) * self.window_scale * 1.25
        while (len(self._history) > 2
               and (t - self._history[1][0] > horizon
                    or len(self._history) > self.MAX_HISTORY_ENTRIES)):
            self._history.popleft()

    def _baseline(self, t: float, window_s: float) -> "tuple[float, dict]":
        """Newest history entry at least `window_s` old; with less
        history than the window, the oldest entry (partial window)."""
        base_t, base = self._history[0]
        for et, entry in self._history:
            if t - et >= window_s:
                base_t, base = et, entry
            else:
                break
        return base_t, base

    def _sum_delta(self, cur: dict, base: dict, family: str,
                   want: "dict | None") -> float:
        total = 0.0
        prefix_b = family + "{"
        for name, v in cur.items():
            if name != family and not name.startswith(prefix_b):
                continue
            _f, labels = sample_labels(name)
            if not _matches(labels, want):
                continue
            # clamp per-sample: a restarted node's counter reset must
            # not produce a negative delta that cancels real errors
            total += max(0.0, v - base.get(name, 0.0))
        return total

    def _latency_deltas(self, cur: dict, base: dict,
                        spec: SloSpec) -> tuple[float, float]:
        """-> (bad, total) request deltas for a latency spec: total from
        `_count`, good from the cumulative bucket at the smallest bound
        >= threshold_s."""
        count_f = spec.family + "_count"
        bucket_f = spec.family + "_bucket"
        total = self._sum_delta(cur, base, count_f, spec.labels)
        # choose the snap bound from the le values actually present
        bounds = set()
        prefix = bucket_f + "{"
        for name in cur:
            if name.startswith(prefix):
                _f, labels = sample_labels(name)
                if not _matches(labels, spec.labels):
                    continue
                le = labels.get("le", "")
                if le and le != "+Inf":
                    try:
                        bounds.add(float(le))
                    except ValueError:
                        pass
        snap = min((b for b in bounds if b >= spec.threshold_s),
                   default=None)
        if snap is None:
            return 0.0, total
        want = dict(spec.labels)
        want["le"] = (repr(float(snap)), str(snap), f"{snap:g}")
        good = self._sum_delta(cur, base, bucket_f, want)
        return max(0.0, total - good), total

    def _gauge_value(self, cur: dict, spec: SloSpec) -> float:
        best = 0.0
        prefix_b = spec.family + "{"
        for name, v in cur.items():
            if name != spec.family and not name.startswith(prefix_b):
                continue
            _f, labels = sample_labels(name)
            if _matches(labels, spec.labels):
                best = max(best, v)
        return best

    def evaluate(self) -> list[dict]:
        """One tick: scrape, compute burn rates, run every spec's state
        machine.  Returns the transitions that happened this tick."""
        with self._eval_mutex:
            t0 = time.perf_counter()
            cur = self._collect()  # seconds-long worst case; no locks
            with self._lock:
                t = self._now()
                self._ingest(t, cur)
                transitions: list[dict] = []
                for spec in self.specs:
                    transitions.extend(self._eval_spec(spec, t, cur))
                self._last_eval = t
            SLO_EVAL_SECONDS.observe(time.perf_counter() - t0)
        for alert in transitions:
            for sink in self._sinks:
                try:
                    sink(alert)
                except Exception as e:  # noqa: BLE001
                    glog.warning("alert sink failed: %s", e)
        return transitions

    def _eval_spec(self, spec: SloSpec, t: float, cur: dict) -> list[dict]:
        w = spec.burn_window()
        short_s = w.short_s * self.window_scale
        long_s = w.long_s * self.window_scale
        st = self._states.setdefault(spec.name, {
            "state": OK, "since": t, "above_since": None})
        burn_short = burn_long = 0.0
        value = None
        if spec.kind in ("gauge", "event"):
            if spec.kind == "event":
                # events over the SHORT window: a spike a fast repair
                # drains between ticks still counts — the counter delta
                # cannot un-happen the way a gauge reading can
                _bt, base = self._baseline(t, short_s)
                value = self._sum_delta(cur, base, spec.family,
                                        spec.labels)
            else:
                value = self._gauge_value(cur, spec)
            above = value >= spec.threshold
            if above and st["above_since"] is None:
                st["above_since"] = t
            if not above:
                st["above_since"] = None
            for_s = spec.for_s * self.window_scale
            if above and t - st["above_since"] >= for_s:
                new_state = FIRING
            elif above:
                new_state = PENDING
            else:
                new_state = OK
            # a level signal reads naturally as a burn of 0/ceiling
            burn_short = burn_long = (
                value / spec.threshold if spec.threshold > 0 else value)
        else:
            budget = max(1e-9, 1.0 - spec.objective)
            for window_s, slot in ((short_s, "short"), (long_s, "long")):
                _bt, base = self._baseline(t, window_s)
                if spec.kind == "latency":
                    bad, total = self._latency_deltas(cur, base, spec)
                else:
                    bad = self._sum_delta(
                        cur, base, spec.bad_family, spec.bad_labels)
                    total = self._sum_delta(
                        cur, base, spec.total_family, spec.total_labels)
                burn = (bad / total / budget) if total > 0 else 0.0
                if slot == "short":
                    burn_short = burn
                else:
                    burn_long = burn
            if burn_short > w.factor and burn_long > w.factor:
                new_state = FIRING
            elif burn_short > w.factor:
                new_state = PENDING
            else:
                new_state = OK
        SLO_BURN_RATE.labels(spec.name, "short").set(burn_short)
        SLO_BURN_RATE.labels(spec.name, "long").set(burn_long)
        SLO_ALERT_STATE.labels(spec.name, spec.severity).set(
            _STATE_VALUE[new_state])
        old_state = st["state"]
        alert = {
            "slo": spec.name, "severity": spec.severity,
            "state": new_state, "since": round(st["since"], 3),
            "at": round(t, 3), "description": spec.description,
            "burnShort": round(burn_short, 4),
            "burnLong": round(burn_long, 4),
            "windowShortS": round(short_s, 3),
            "windowLongS": round(long_s, 3),
        }
        if value is not None:
            alert["value"] = round(value, 4)
        if new_state == FIRING and old_state == FIRING:
            # keep the transition tick's exemplars on the ACTIVE alert:
            # an operator opening /cluster/alerts minutes into the page
            # still gets the one-hop trace link
            prev = st.get("alert") or {}
            for key in ("exemplars", "from"):
                if key in prev:
                    alert[key] = prev[key]
        st["alert"] = alert
        if new_state == old_state:
            return []
        st["state"] = new_state
        st["since"] = t
        alert["since"] = round(t, 3)
        alert["from"] = old_state
        if new_state == FIRING:
            self._attach_exemplars(spec, alert)
        to = new_state if new_state != OK else "resolved"
        SLO_TRANSITIONS.labels(spec.name, to).inc()
        self.alert_history.append(dict(alert))
        return [alert]

    def _attach_exemplars(self, spec: SloSpec, alert: dict) -> None:
        """Embed the slowest recent exemplar trace ids so the alert is
        one hop from page to stitched timeline.

        Exemplars come from the LOCAL process registry (histograms on
        remote nodes keep their own); candidates are filtered by the
        spec's label selector so a write-latency page can never link a
        slow GET's trace.  A spec judging purely remote SLIs simply
        attaches none — honest absence beats an irrelevant link."""
        if not spec.exemplar_family or self._exemplars is None:
            return
        try:
            ex = self._exemplars(spec.exemplar_family)
        except Exception:  # noqa: BLE001 — exemplars are best-effort
            return
        want = spec.labels or None
        picked = [{
            "traceId": e["traceId"], "seconds": e["value"], "le": e["le"],
            "traceQuery": f"/cluster/traces?trace={e['traceId']}",
        } for e in ex if _matches(e.get("labels", {}), want)][:3]
        if picked:
            alert["exemplars"] = picked

    # -- surfaces ---------------------------------------------------------

    def status(self, evaluate_if_idle: bool = True) -> dict:
        """The /cluster/alerts document.  With no evaluation loop
        running (interval 0), serve a fresh evaluation so the endpoint
        is usable on a manually driven master."""
        if evaluate_if_idle and self._thread is None:
            try:
                self.evaluate()
            except Exception as e:  # noqa: BLE001
                glog.warning("on-demand slo evaluation failed: %s", e)
        with self._lock:
            active = []
            states = {}
            for spec in self.specs:
                st = self._states.get(spec.name)
                if st is None:
                    continue
                states[spec.name] = {
                    "state": st["state"],
                    "sinceS": round(self._now() - st["since"], 3),
                    "severity": spec.severity,
                }
                if st["state"] != OK and "alert" in st:
                    active.append(st["alert"])
            return {
                "specs": [s.to_dict() for s in self.specs],
                "states": states,
                "alerts": active,
                "history": list(self.alert_history),
                "windowScale": self.window_scale,
                "intervalS": self.interval_s,
                "evaluatedAt": round(self._last_eval, 3),
            }

    def health_summary(self) -> dict:
        """Compact block for /cluster/status: counts + firing names."""
        with self._lock:
            firing = [n for n, st in self._states.items()
                      if st["state"] == FIRING]
            pending = [n for n, st in self._states.items()
                       if st["state"] == PENDING]
        return {
            "firing": sorted(firing),
            "pending": sorted(pending),
            "specs": len(self.specs),
            "evaluating": self._thread is not None,
        }
