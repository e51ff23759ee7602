"""Master-side cluster observability plane: federated /cluster/metrics,
stitched /cluster/traces, /cluster/hot, and the /cluster/status JSON — the
port's copy of seaweedfs_tpu/master/observability.py.

The master is the only process that knows every node (volume servers
heartbeat it, filers register over KeepConnected), so it is the natural
single pane: scrape fan-out runs here over the shared keep-alive pool
with a hard per-node deadline, and nodes that do not answer are served
from the stats snapshot their last heartbeat carried instead of
disappearing from dashboards mid-incident — exactly when they matter.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import time

from ..stats.metrics import REGISTRY
from ..telemetry import trace
from ..telemetry.federation import FederatedExposition
from ..telemetry.stitch import estimate_skew, stitch_trace
from ..util import connpool, glog

# per-node scrape deadline: one wedged node must cost the whole
# federation render at most this, and the fan-out is concurrent so the
# total is ~max, not sum
FEDERATION_TIMEOUT_S = float(
    os.environ.get("SEAWEEDFS_TPU_FEDERATION_TIMEOUT_S", "1.0"))

# heartbeat snapshots older than this stop being served for nodes that
# left the topology — a node gone for 15 minutes is an outage, not a
# scrape blip, and its last counters would only mislead
SNAPSHOT_RETENTION_S = 900.0


def _self_target(master) -> dict:
    return {"instance": f"{master.ip}:{master.port}", "type": "master"}


def federation_targets(master) -> list[dict]:
    """Every scrapeable node the master knows: volume servers from the
    topology, filers from KeepConnected registrations, plus recently
    departed nodes that still have a fresh heartbeat snapshot (so a node
    the liveness sweep just dropped shows up stale, not vanished)."""
    targets: list[dict] = []
    seen: set[str] = set()
    with master.topo.lock:
        for n in master.topo.nodes.values():
            targets.append({"instance": n.id, "type": "volume",
                            "http_address": n.id})
            seen.add(n.id)
    for name, info in master.clients_snapshot().items():
        addr = info.get("http_address")
        if addr and addr not in seen:
            targets.append({"instance": addr, "type": info["type"],
                            "http_address": addr, "client_name": name})
            seen.add(addr)
    now = time.monotonic()
    for instance, snap in master.stats_snapshots_snapshot().items():
        if instance in seen:
            continue
        if now - snap["received"] <= SNAPSHOT_RETENTION_S:
            targets.append({"instance": instance, "type": snap["type"],
                            "http_address": instance})
            seen.add(instance)
    targets.sort(key=lambda t: (t["type"], t["instance"]))
    return targets


def _scrape(url: str, timeout: float) -> str:
    """GET with a WALL-CLOCK bound, not just a per-recv timeout: a node
    dripping one byte per recv-window would reset a socket timeout on
    every byte and wedge the fan-out worker forever."""
    deadline = time.monotonic() + timeout
    with connpool.request("GET", url, timeout=timeout) as r:
        chunks: list[bytes] = []
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError(f"scrape of {url} exceeded {timeout}s")
            chunk = r.read(1 << 16)
            if not chunk:
                break
            chunks.append(chunk)
    return b"".join(chunks).decode("utf-8", errors="replace")


def cluster_metrics(master, family_prefixes: "list[str] | None" = None) -> str:
    """Prometheus exposition federated across every known node.

    `family_prefixes` (the validated ?family= filter) restricts the
    merge to matching families AND rides the per-node scrape URL, so an
    SLO evaluation tick moves a few families' worth of text per node
    instead of the full exposition."""
    fed = FederatedExposition(family_prefixes)
    t0 = time.perf_counter()
    fed.add_live(_self_target(master), REGISTRY.render(family_prefixes),
                 time.perf_counter() - t0)
    targets = federation_targets(master)
    family_q = ("?family=" + ",".join(family_prefixes)
                if family_prefixes else "")

    def scrape_one(t: dict):
        t1 = time.perf_counter()
        try:
            text = _scrape(f"http://{t['http_address']}/metrics{family_q}",
                           FEDERATION_TIMEOUT_S)
            return ("live", text, time.perf_counter() - t1)
        except Exception as e:  # noqa: BLE001 — any failure -> snapshot
            return ("down", str(e), time.perf_counter() - t1)

    futures = [(t, master.federation_pool.submit(scrape_one, t))
               for t in targets]
    snapshots = master.stats_snapshots_snapshot()
    now = time.monotonic()
    # total wall bound: scrapes run concurrently but the pool is finite
    # (and shared with /cluster/traces), so targets past the width queue
    # — the render is bounded by ~deadline x ceil(targets/width) + slack,
    # and any straggler past that is served from its snapshot like an
    # unreachable node.  Width comes from the pool itself, doubled as
    # slack for a concurrent /cluster/traces occupying slots (its
    # fetches are _scrape-wall-bounded, so slots free within ~deadline).
    width = max(1, master.federation_pool._max_workers)
    rounds = 1 + (len(targets) - 1) // width if targets else 1
    budget = FEDERATION_TIMEOUT_S * rounds * 2 + 2.0
    render_deadline = now + budget
    for t, fut in futures:
        try:
            kind, payload, dt = fut.result(
                timeout=max(0.0, render_deadline - time.monotonic()))
        except concurrent.futures.TimeoutError:
            # (not builtin TimeoutError until py3.11)
            kind, payload, dt = "down", "render budget exhausted", 0.0
        if kind == "live":
            fed.add_live(t, payload, dt)
            continue
        snap = snapshots.get(t["instance"])
        if snap is not None:
            fed.add_snapshot(t, snap["samples"], now - snap["received"])
        else:
            fed.add_down(t)
        if glog.V(1):
            glog.info("federation: %s unreachable (%s), %s",
                      t["instance"], payload,
                      "served snapshot" if snap else "no snapshot")
    return fed.render()


def cluster_traces(master, trace_id: str, limit: int) -> dict:
    """Fan /debug/traces?trace=<id> out to every node and stitch the
    per-node span lists into one parent-linked, skew-annotated timeline."""
    results = [{
        "instance": f"{master.ip}:{master.port}", "type": "master",
        "spans": _own_spans(trace_id, limit), "skew_s": 0.0, "rtt_s": 0.0,
    }]

    def fetch_one(t: dict):
        url = (f"http://{t['http_address']}/debug/traces"
               f"?trace={trace_id}&limit={limit}")
        sent_at = time.time()
        t1 = time.perf_counter()
        try:
            doc = json.loads(_scrape(url, FEDERATION_TIMEOUT_S))
        except Exception:  # noqa: BLE001 — absent node: no spans
            return None
        rtt = time.perf_counter() - t1
        spans = []
        for tr in doc.get("traces", ()):
            if tr.get("traceId") == trace_id:
                spans.extend(tr.get("spans", ()))
        skew = 0.0
        if isinstance(doc.get("now"), (int, float)):
            skew = estimate_skew(doc["now"], sent_at, rtt)
        return {"instance": t["instance"], "type": t["type"],
                "spans": spans, "skew_s": skew, "rtt_s": rtt}

    targets = federation_targets(master)
    futures = [master.federation_pool.submit(fetch_one, t) for t in targets]
    for fut in futures:
        res = fut.result()
        if res is not None:
            results.append(res)
    return stitch_trace(trace_id, results)


def cluster_hot(master, n: int = 32) -> dict:
    """Fan /debug/hot out to every node and merge the per-dimension
    sketch tables into cluster-wide ones.

    Space-saving sketches merge by summing per-key counts (and error
    bounds), so the cluster table keeps the sketch's guarantee: a key
    hot anywhere is present, with its worst-case overestimate stated."""
    from ..telemetry import hotkeys as _hotkeys

    per_node: dict[str, dict] = {
        f"{master.ip}:{master.port}": _hotkeys.snapshot(n)}

    def fetch_one(t: dict):
        try:
            return t["instance"], json.loads(_scrape(
                f"http://{t['http_address']}/debug/hot?n={n}",
                FEDERATION_TIMEOUT_S))
        except Exception as e:  # noqa: BLE001 — a dead node still lists
            return t["instance"], {"error": str(e)}

    targets = federation_targets(master)
    futures = [master.federation_pool.submit(fetch_one, t) for t in targets]
    for fut in futures:
        instance, doc = fut.result()
        per_node.setdefault(instance, doc)

    def merge(which: str) -> dict:
        tables: dict[str, dict[str, dict]] = {}
        for instance, doc in per_node.items():
            for dim, windows in (doc.get("dims") or {}).items():
                table = tables.setdefault(dim, {})
                for e in windows.get(which) or ():
                    slot = table.setdefault(e["key"], {
                        "key": e["key"], "count": 0, "error": 0,
                        "nodes": []})
                    slot["count"] += e.get("count", 0)
                    slot["error"] += e.get("error", 0)
                    slot["nodes"].append(instance)
        return {
            dim: sorted(t.values(),
                        key=lambda s: (-s["count"], s["key"]))[:n]
            for dim, t in tables.items()
        }

    current, previous = merge("current"), merge("previous")
    return {
        "nodes": {
            instance: ({"error": doc["error"]} if "error" in doc
                       else {"windowAgeS": doc.get("windowAgeS"),
                             "enabled": doc.get("enabled", True)})
            for instance, doc in sorted(per_node.items())
        },
        "dims": {
            dim: {"current": current.get(dim, []),
                  "previous": previous.get(dim, [])}
            for dim in sorted(set(current) | set(previous))
        },
    }


def _own_spans(trace_id: str, limit: int) -> list[dict]:
    for tr in trace.TRACER.recent_traces(limit, trace_id=trace_id):
        if tr["traceId"] == trace_id:
            return tr["spans"]
    return []


def cluster_status(master) -> dict:
    """The /cluster/status JSON the shell and UI consume: topology plus
    per-node liveness and federation/snapshot state."""
    now_mono = time.monotonic()
    with master.topo.lock:
        data_nodes = {
            n.id: {
                "publicUrl": n.public_url,
                "volumes": sorted(n.volumes),
                "ecShards": {
                    str(vid): bits.shard_ids()
                    for vid, bits in n.ec_shards.items()
                },
                "dataCenter": n.data_center,
                "rack": n.rack,
                "secondsSinceLastBeat": round(now_mono - n.last_seen, 1),
                # disk-fault plane: per-dir watermark state + free bytes
                # from the node's heartbeat (empty = legacy/unknown)
                "disks": {
                    d: {"state": info.get("state", "healthy"),
                        "freeBytes": info.get("free_bytes", 0),
                        "totalBytes": info.get("total_bytes", 0)}
                    for d, info in n.disk_health.items()
                },
                "diskState": n.worst_disk_state(),
            }
            for n in master.topo.nodes.values()
        }
        out = {
            "IsLeader": master.is_leader(),
            "Leader": master.leader(),
            "MaxVolumeId": master.topo.max_volume_id,
            "DataNodes": data_nodes,
        }
    out["Filers"] = {
        name: {
            "httpAddress": info.get("http_address", ""),
            "secondsSinceLastSeen": round(
                now_mono - info["last_seen"], 1),
        }
        for name, info in master.clients_snapshot().items()
    }
    out["StatsSnapshots"] = {
        instance: {
            "type": snap["type"],
            "samples": len(snap["samples"]),
            "ageSeconds": round(now_mono - snap["received"], 1),
        }
        for instance, snap in master.stats_snapshots_snapshot().items()
    }
    # self-healing plane: per-volume health (under-replication + open
    # scrub findings) so `cluster.status -json` answers "is anything
    # silently rotten and is repair keeping up"
    master.update_replication_health()
    out["VolumeHealth"] = master.volume_health_snapshot()
    out["ScrubFindings"] = len(master.scrub_findings_snapshot())
    # lifecycle plane: one-line controller summary (the full journal is
    # at /cluster/lifecycle); answers "is background maintenance alive
    # and is anything parked waiting for an operator"
    lc = master.lifecycle
    out["Lifecycle"] = {
        "enabled": lc.interval_s > 0,
        "rateMBps": lc.rate_mbps,
        "jobStates": lc.journal.counts(),
    }
    # judgment plane: is the cluster meeting its SLOs right
    # now, and are the black-box canaries proving end-to-end service —
    # the one-line health verdict cluster.status renders first
    health: dict = {}
    slo = getattr(master, "slo", None)
    if slo is not None:
        health["slo"] = slo.health_summary()
    canary = getattr(master, "canary", None)
    if canary is not None:
        cs = canary.status()
        health["canary"] = {
            "running": cs["running"],
            "tick": cs["tick"],
            "byteMismatches": cs["byteMismatches"],
            "probes": {
                name: ("skipped" if p.get("skipped") else (
                    "error" if any(t["result"] == "error"
                                   for t in p.get("targets", {}).values())
                    else "ok"))
                for name, p in cs["probes"].items()
            },
        }
    out["Health"] = health
    # HA control plane: raft state + fencing epoch — the
    # operator's answer to "who is the leader, how stable is it, and is
    # the control plane warmed up after the last failover"
    raft = getattr(master, "raft", None)
    if raft is not None:
        with raft.lock:
            out["Raft"] = {
                "term": raft.term,
                "role": raft.role,
                "leaderId": raft.leader_id,
                "commitIndex": raft.commit_index,
                "lastApplied": raft.last_applied,
                "logEntries": len(raft.log),
                "peers": list(raft.peers),
            }
        out["Raft"]["leaderEpoch"] = master.leader_epoch()
        out["Raft"]["warmedUp"] = master.control_warmed()
    return out
