"""Cluster observability shell commands — the port's copy of
seaweedfs_tpu/shell/cluster_commands.py: `cluster.status`,
`cluster.alerts`, `cluster.hot` and `cluster.debug`.

Left out for a later slice (ROADMAP A-7): `filer.ring` and `cluster.geo`,
which read the filer fleet's hash ring and the geo registry, and the
`cluster.status` line that renders the filer ring (the filer fleet comes
with A-7; the status lists registered filers all the same).

`cluster.status` renders the master's /cluster/status JSON — topology,
filer registrations, heartbeat/snapshot ages — as the operator-facing
one-screen answer to "what does the master think the cluster looks like".
"""

from __future__ import annotations

import json

from ..util import connpool
from .commands import CommandEnv, register


def _master_http(env: CommandEnv) -> str:
    """The master's HTTP address, derived from the gRPC one (port-10000
    convention, the inverse of CommandEnv's construction)."""
    host, _, port = env.master_grpc.partition(":")
    return f"{host}:{int(port) - 10000}"


@register("cluster.status")
def cluster_status(env: CommandEnv, args: list[str]) -> str:
    """cluster.status [-json]  — nodes, filers, liveness, snapshot ages."""
    addr = _master_http(env)
    with connpool.request(
            "GET", f"http://{addr}/cluster/status", timeout=10) as r:
        doc = json.loads(r.read())
    if "-json" in args:
        return json.dumps(doc, indent=2, sort_keys=True)
    lines = [
        f"master {addr} leader={doc.get('Leader', '?')} "
        f"isLeader={doc.get('IsLeader')} "
        f"maxVolumeId={doc.get('MaxVolumeId')}",
    ]
    raft = doc.get("Raft")
    if raft:
        warm = "warmed" if raft.get("warmedUp") else "WARMING UP"
        lines.append(
            f"raft: term={raft.get('term')} role={raft.get('role')} "
            f"leader={raft.get('leaderId')} "
            f"commit={raft.get('commitIndex')}/"
            f"{raft.get('logEntries')} entries "
            f"epoch={raft.get('leaderEpoch')} "
            f"quorum={len(raft.get('peers', ())) + 1} {warm}")
    nodes = doc.get("DataNodes", {})
    lines.append(f"volume servers ({len(nodes)}):")
    for nid in sorted(nodes):
        n = nodes[nid]
        disk_state = n.get("diskState", "healthy")
        disks = n.get("disks") or {}
        free_mb = sum(d.get("freeBytes", 0) for d in disks.values()) >> 20
        disk_note = ""
        if disks:
            disk_note = f" disk={disk_state} free={free_mb}MB"
            if disk_state not in ("healthy", "low_space"):
                disk_note = disk_note.upper()  # full/failing must pop
        lines.append(
            f"  {nid} dc={n.get('dataCenter')} rack={n.get('rack')} "
            f"volumes={len(n.get('volumes', ()))} "
            f"ecVolumes={len(n.get('ecShards', {}))} "
            f"lastBeat={n.get('secondsSinceLastBeat', '?')}s ago"
            + disk_note)
    filers = doc.get("Filers", {})
    lines.append(f"filers ({len(filers)}):")
    for name in sorted(filers):
        f = filers[name]
        lines.append(
            f"  {name} http={f.get('httpAddress')} "
            f"lastSeen={f.get('secondsSinceLastSeen', '?')}s ago")
    health = doc.get("Health") or {}
    slo = health.get("slo") or {}
    canary = health.get("canary") or {}
    if slo or canary:
        firing = slo.get("firing") or []
        pending = slo.get("pending") or []
        verdict = ("FIRING: " + ", ".join(firing) if firing
                   else "pending: " + ", ".join(pending) if pending
                   else "ok")
        lines.append(
            f"health: {verdict} ({slo.get('specs', 0)} SLOs, "
            f"engine {'on' if slo.get('evaluating') else 'on-demand'}; "
            "details: cluster.alerts)")
        if canary:
            probes = canary.get("probes") or {}
            rendered = " ".join(
                f"{name}={state}" for name, state in sorted(probes.items()))
            lines.append(
                f"canary: {'running' if canary.get('running') else 'off'} "
                f"tick={canary.get('tick', 0)} "
                f"byteMismatches={canary.get('byteMismatches', 0)}"
                + (f" {rendered}" if rendered else ""))
    snaps = doc.get("StatsSnapshots", {})
    if snaps:
        lines.append(f"stats snapshots ({len(snaps)}):")
        for inst in sorted(snaps):
            s = snaps[inst]
            lines.append(
                f"  {inst} type={s.get('type')} "
                f"samples={s.get('samples')} "
                f"age={s.get('ageSeconds', '?')}s")
    lines.append(
        f"federated scrape: http://{addr}/cluster/metrics ; "
        f"stitched traces: http://{addr}/cluster/traces?trace=<id>")
    return "\n".join(lines)


@register("cluster.alerts")
def cluster_alerts(env: CommandEnv, args: list[str]) -> str:
    """cluster.alerts [-json]  — SLO states, active alerts (with
    exemplar trace ids), recent transitions, canary probe results from
    the master's /cluster/alerts."""
    addr = _master_http(env)
    with connpool.request(
            "GET", f"http://{addr}/cluster/alerts", timeout=10) as r:
        doc = json.loads(r.read())
    if "-json" in args:
        return json.dumps(doc, indent=2, sort_keys=True)
    lines = []
    states = doc.get("states", {})
    active = doc.get("alerts", [])
    lines.append(f"SLOs ({len(states)}):")
    for name in sorted(states):
        st = states[name]
        lines.append(
            f"  {name} [{st.get('severity')}] {st.get('state')} "
            f"for {st.get('sinceS', 0):.0f}s")
    if active:
        lines.append(f"active alerts ({len(active)}):")
        for a in active:
            lines.append(
                f"  {a['slo']} [{a['severity']}] {a['state']} "
                f"burn={a.get('burnShort', 0):.2f}/"
                f"{a.get('burnLong', 0):.2f}"
                + (f" value={a['value']}" if "value" in a else ""))
            for ex in a.get("exemplars", ()):
                lines.append(
                    f"    exemplar trace {ex['traceId']} "
                    f"({ex['seconds'] * 1e3:.1f}ms, le={ex['le']}) -> "
                    f"http://{addr}{ex['traceQuery']}")
    else:
        lines.append("active alerts: none")
    hist = doc.get("history", [])
    if hist:
        lines.append(f"recent transitions ({len(hist)}):")
        for h in hist[-8:]:
            lines.append(
                f"  {h['slo']} {h.get('from', '?')} -> {h['state']}")
    canary = doc.get("canary", {})
    lines.append(
        f"canary: {'running' if canary.get('running') else 'off'} "
        f"interval={canary.get('interval_s', 0)}s "
        f"tick={canary.get('tick', 0)} "
        f"byteMismatches={canary.get('byteMismatches', 0)}")
    for name in sorted(canary.get("probes", {})):
        p = canary["probes"][name]
        if p.get("skipped"):
            lines.append(f"  {name}: skipped ({p['skipped']})")
            continue
        for target in sorted(p.get("targets", {})):
            t = p["targets"][target]
            lines.append(
                f"  {name} {target}: {t['result']}"
                + (f" ({t['error']})" if t.get("error") else ""))
    return "\n".join(lines)


@register("cluster.hot")
def cluster_hot(env: CommandEnv, args: list[str]) -> str:
    """cluster.hot [-json] [-n N]  — federated heavy-hitter tables:
    the hottest needles, buckets, tenants and peer IPs cluster-wide,
    from the master's /cluster/hot."""
    addr = _master_http(env)
    n = 32
    if "-n" in args:
        try:
            n = int(args[args.index("-n") + 1])
        except (IndexError, ValueError):
            return "usage: cluster.hot [-json] [-n N]"
    with connpool.request(
            "GET", f"http://{addr}/cluster/hot?n={n}", timeout=10) as r:
        doc = json.loads(r.read())
    if "-json" in args:
        return json.dumps(doc, indent=2, sort_keys=True)
    lines = []
    nodes = doc.get("nodes", {})
    down = sorted(i for i, s in nodes.items() if "error" in s)
    lines.append(f"hot keys across {len(nodes)} node(s)"
                 + (f" ({len(down)} unreachable)" if down else ""))
    for dim, windows in sorted(doc.get("dims", {}).items()):
        rows = windows.get("current") or windows.get("previous") or []
        which = "current" if windows.get("current") else "previous"
        if not rows:
            lines.append(f"  {dim}: (no traffic this window)")
            continue
        lines.append(f"  {dim} ({which} window):")
        for e in rows[:10]:
            lines.append(
                f"    {e['key']}  ~{e['count']} hits"
                + (f" (+/-{e['error']})" if e.get("error") else "")
                + f" on {len(set(e.get('nodes', ())))} node(s)")
    for inst in down:
        lines.append(f"  {inst} UNREACHABLE ({nodes[inst]['error']})")
    return "\n".join(lines)


@register("cluster.debug")
def cluster_debug(env: CommandEnv, args: list[str]) -> str:
    """cluster.debug [-json] [-capture] [-bundle NAME]  — list flight-
    recorder debug bundles; -capture snapshots a new one across every
    live node; -bundle prints one bundle's JSON."""
    addr = _master_http(env)
    if "-bundle" in args:
        try:
            name = args[args.index("-bundle") + 1]
        except IndexError:
            return "usage: cluster.debug -bundle NAME"
        with connpool.request(
                "GET", f"http://{addr}/cluster/debug?bundle="
                f"{name}", timeout=30) as r:
            return json.dumps(json.loads(r.read()), indent=2,
                              sort_keys=True)
    if "-capture" in args:
        with connpool.request(
                "GET", f"http://{addr}/cluster/debug/capture",
                timeout=60) as r:
            meta = json.loads(r.read())
        if "-json" in args:
            return json.dumps(meta, indent=2, sort_keys=True)
        if "error" in meta:
            return f"capture failed: {meta['error']}"
        return (f"captured {meta['name']}: {len(meta.get('nodes', ()))} "
                f"node(s), {meta.get('sizeBytes', 0)} bytes")
    with connpool.request(
            "GET", f"http://{addr}/cluster/debug", timeout=10) as r:
        doc = json.loads(r.read())
    if "-json" in args:
        return json.dumps(doc, indent=2, sort_keys=True)
    bundles = doc.get("bundles", [])
    lines = [f"debug bundles ({len(bundles)}), "
             f"dir={doc.get('debugDir') or '(in-memory)'} "
             f"retain={doc.get('retain')}"]
    for b in bundles:
        lines.append(f"  {b['name']}  {b['sizeBytes']}B  "
                     f"{b['ageS']:.0f}s ago")
    if not bundles:
        lines.append("  (none captured yet; cluster.debug -capture, or "
                     "wait for an alert to fire)")
    return "\n".join(lines)
