"""Flight recorder: alert-triggered cluster debug bundles — the port's copy
of seaweedfs_tpu/master/flight.py.

The SLO engine can page within seconds, but by the time an operator
answers the page the evidence is rotating out of the per-node rings.
The flight recorder closes that gap: the moment an alert transitions to
firing (or on demand via `GET /cluster/debug/capture` / the shell's
`cluster.debug -capture`), the master fans out to every live node and
snapshots what the rings hold RIGHT NOW into one bundle —

  * the full metrics exposition per node,
  * the span rings (plus a targeted fetch of the alert's exemplar
    trace id, so the paged request's timeline is pinned even if the
    recent-ring has already rotated past it),
  * the continuous profiler's window history,
  * the heavy-hitter tables,
  * master-local control-plane state (raft, lifecycle, disk health,
    alert states),
  * and, for an alert capture, the stitched cluster-wide exemplar
    trace.

Bundles persist under `-debugDir` with bounded retention (an in-memory
ring when no directory is configured) and are listed from
`/cluster/alerts` and `/cluster/debug`.  Capture bytes are charged to
the shared background-I/O budget (the lifecycle TokenBucket), so a page
storm cannot amplify the outage it is documenting.

A reference fault, repaired in the port: the reference starts its
cooldown clock at 0.0 of `time.monotonic()`, which on Linux counts
seconds since boot, so a master on a machine up for less than the
cooldown (60 s by default) drops its first page's bundle.  Here the
cooldown counts only from a capture that happened: the first page after
start is always captured.  `stop()` joins the capture threads
(``master-flight-capture``); the reference leaves daemon threads.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from ..stats.metrics import DEBUG_BUNDLE_SECONDS, DEBUG_BUNDLES, REGISTRY
from ..telemetry import debug_traces_body
from ..util import glog
from .observability import (
    FEDERATION_TIMEOUT_S,
    _scrape,
    cluster_traces,
    federation_targets,
)

RETAIN_VAR = "SEAWEEDFS_TPU_DEBUG_BUNDLE_RETAIN"
COOLDOWN_VAR = "SEAWEEDFS_TPU_DEBUG_BUNDLE_COOLDOWN_S"
DEFAULT_RETAIN = 8
DEFAULT_COOLDOWN_S = 60.0

# per-node ring endpoints snapshotted into every bundle
_NODE_SECTIONS = (
    ("metrics", "/metrics"),
    ("spans", "/debug/traces?limit=200"),
    ("profile", "/debug/profile/history"),
    ("hot", "/debug/hot"),
)


def _env_num(var: str, default: float) -> float:
    try:
        return float(os.environ.get(var, "") or default)
    except ValueError:
        return default


class FlightRecorder:
    def __init__(self, master, debug_dir: str = "",
                 retain: int | None = None,
                 cooldown_s: float | None = None):
        self.master = master
        self.debug_dir = debug_dir
        self.retain = (int(_env_num(RETAIN_VAR, DEFAULT_RETAIN))
                       if retain is None else int(retain))
        self.retain = max(1, self.retain)
        self.cooldown_s = (_env_num(COOLDOWN_VAR, DEFAULT_COOLDOWN_S)
                           if cooldown_s is None else float(cooldown_s))
        if debug_dir:
            os.makedirs(debug_dir, exist_ok=True)
        # one capture at a time; alert storms coalesce into the capture
        # already in flight (its bundle holds the same evidence)
        self._capture_lock = threading.Lock()
        # monotonic time of the last capture; None until one happened
        self._last_capture: "float | None" = None
        self._threads: list[threading.Thread] = []
        self._seq = 0
        self._seq_lock = threading.Lock()
        # in-memory ring when no debug_dir is configured
        self._mem: deque[tuple[str, dict]] = deque(maxlen=self.retain)

    # -- slo sink ---------------------------------------------------------

    def sink(self, alert: dict) -> None:
        """SloEngine sink: a transition to firing captures a bundle in
        the background.  Runs on the engine's evaluation thread, so the
        fan-out must not happen inline."""
        if alert.get("state") != "firing":
            return
        now = time.monotonic()
        if (self._last_capture is not None
                and now - self._last_capture < self.cooldown_s):
            return
        if self.master._stop.is_set():
            return
        th = threading.Thread(
            target=self._capture_safe, args=("alert", alert),
            daemon=True, name="master-flight-capture")
        self._threads = [t for t in self._threads if t.is_alive()] + [th]
        th.start()

    def stop(self) -> None:
        """Join the capture threads (the master's stop event ends a
        capture waiting on the background-I/O budget)."""
        for th in list(self._threads):
            th.join(timeout=60.0)
        self._threads = []

    def _capture_safe(self, trigger: str, alert: dict | None) -> None:
        try:
            self.capture(trigger=trigger, alert=alert)
        except Exception as e:  # noqa: BLE001 — capture must never raise
            glog.error("flight recorder capture failed: %s", e)

    # -- capture ----------------------------------------------------------

    def capture(self, trigger: str = "manual",
                alert: dict | None = None) -> dict:
        """Snapshot every live node's rings into one bundle.  Returns
        the bundle's summary {name, nodes, sizeBytes, ...}; raises only
        on a capture already in flight (the caller's 409)."""
        if not self._capture_lock.acquire(blocking=False):
            raise RuntimeError("a bundle capture is already in progress")
        t0 = time.perf_counter()
        try:
            self._last_capture = time.monotonic()
            bundle = self._collect(trigger, alert)
            payload = json.dumps(bundle).encode()
            # charge the shared background budget BEFORE persisting: a
            # page during an overload waits its turn behind lifecycle
            # and scrub traffic instead of adding unthrottled I/O
            self.master.lifecycle.bucket.consume(
                len(payload), stop=self.master._stop)
            name = bundle["name"]
            if self.debug_dir:
                path = os.path.join(self.debug_dir, name + ".json")
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(payload)
                os.replace(tmp, path)
                self._prune()
            else:
                self._mem.append((name, bundle))
            DEBUG_BUNDLES.labels(trigger, "ok").inc()
            glog.info("flight recorder: captured %s (%d nodes, %d bytes,"
                      " trigger=%s)", name, len(bundle["nodes"]),
                      len(payload), trigger)
            return {
                "name": name,
                "trigger": trigger,
                "at": bundle["at"],
                "nodes": sorted(bundle["nodes"]),
                "sizeBytes": len(payload),
                "alert": (alert or {}).get("slo", ""),
            }
        except Exception:
            DEBUG_BUNDLES.labels(trigger, "error").inc()
            raise
        finally:
            DEBUG_BUNDLE_SECONDS.observe(time.perf_counter() - t0)
            self._capture_lock.release()

    def _collect(self, trigger: str, alert: dict | None) -> dict:
        master = self.master
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
        name = f"bundle-{stamp}-{trigger}-{seq}"
        exemplar_ids = [e["traceId"] for e in (alert or {}).get(
            "exemplars", ()) if e.get("traceId")]

        def fetch_node(t: dict) -> tuple[str, dict]:
            base = f"http://{t['http_address']}"
            sections: dict = {"type": t["type"]}
            for key, path in _NODE_SECTIONS:
                try:
                    text = _scrape(base + path, FEDERATION_TIMEOUT_S)
                    sections[key] = (text if key == "metrics"
                                     else json.loads(text))
                except Exception as e:  # noqa: BLE001 — partial is fine
                    sections.setdefault("errors", {})[key] = str(e)
            # pin the exemplar trace: the targeted query hits the
            # important-span ring even after the recent ring rotated
            for tid in exemplar_ids:
                try:
                    doc = json.loads(_scrape(
                        f"{base}/debug/traces?trace={tid}&limit=200",
                        FEDERATION_TIMEOUT_S))
                except Exception:  # noqa: BLE001
                    continue
                spans = sections.setdefault("spans", {"traces": []})
                have = {tr.get("traceId")
                        for tr in spans.get("traces", ())}
                for tr in doc.get("traces", ()):
                    if tr.get("traceId") not in have:
                        spans.setdefault("traces", []).append(tr)
            return t["instance"], sections

        targets = federation_targets(master)
        futures = [master.federation_pool.submit(fetch_node, t)
                   for t in targets]

        # the master's own rings, read in-process (no self-scrape)
        from ..telemetry import hotkeys as _hotkeys
        from ..util import profiler as _profiler

        self_sections: dict = {
            "type": "master",
            "metrics": REGISTRY.render(),
            "spans": json.loads(debug_traces_body(200)),
            "profile": _profiler.continuous_history(),
            "hot": _hotkeys.snapshot(),
        }
        nodes = {f"{master.ip}:{master.port}": self_sections}
        for fut in futures:
            instance, sections = fut.result()
            nodes.setdefault(instance, sections)

        bundle = {
            "name": name,
            "at": time.time(),
            "trigger": trigger,
            "cluster": {
                "leader": master.leader(),
                "isLeader": master.is_leader(),
                "lifecycle": master.lifecycle.status(),
                "sloStates": master.slo.status(evaluate_if_idle=False),
            },
            "nodes": nodes,
        }
        if alert is not None:
            bundle["alert"] = alert
            if exemplar_ids:
                # the cluster-wide stitched timeline of the paged
                # request — the "what exactly was slow, where" answer
                bundle["exemplarTrace"] = cluster_traces(
                    master, exemplar_ids[0], 200)
        raft = getattr(master, "raft", None)
        if raft is not None:
            with raft.lock:
                bundle["cluster"]["raft"] = {
                    "term": raft.term, "role": raft.role,
                    "leaderId": raft.leader_id,
                    "commitIndex": raft.commit_index,
                }
        return bundle

    # -- retention / listing ----------------------------------------------

    def _paths(self) -> list[str]:
        if not self.debug_dir:
            return []
        try:
            names = os.listdir(self.debug_dir)
        except OSError:
            return []
        return sorted(
            os.path.join(self.debug_dir, n) for n in names
            if n.startswith("bundle-") and n.endswith(".json"))

    def _prune(self) -> None:
        paths = self._paths()
        for path in paths[:-self.retain]:
            try:
                os.unlink(path)
            except OSError:
                pass

    def list_bundles(self) -> list[dict]:
        """Newest first: [{name, sizeBytes, ageS}]."""
        out = []
        now = time.time()
        if self.debug_dir:
            for path in self._paths():
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                out.append({
                    "name": os.path.basename(path)[:-len(".json")],
                    "sizeBytes": st.st_size,
                    "ageS": round(max(0.0, now - st.st_mtime), 1),
                })
        else:
            for name, doc in self._mem:
                out.append({
                    "name": name,
                    "sizeBytes": len(json.dumps(doc)),
                    "ageS": round(max(0.0, now - doc["at"]), 1),
                })
        out.sort(key=lambda b: b["ageS"])
        return out

    def bundle(self, name: str) -> dict | None:
        if not name.startswith("bundle-") or "/" in name or ".." in name:
            return None
        if self.debug_dir:
            path = os.path.join(self.debug_dir, name + ".json")
            try:
                with open(path, "rb") as f:
                    return json.loads(f.read())
            except (OSError, ValueError):
                return None
        for mem_name, doc in self._mem:
            if mem_name == name:
                return doc
        return None
