"""Cross-process trace stitching — the port's copy of
seaweedfs_tpu/telemetry/stitch.py.

Every process keeps its own span ring; before this module, following one
request across the cluster meant querying each server's /debug/traces
and joining on traceId by hand (METRICS.md used to say exactly that).
The master's /cluster/traces fans the per-trace query out to every
registered node and this module merges the per-node span lists into one
parent-linked timeline.

Clock skew: span `start` values are wall-clock stamps from different
machines.  Each node's /debug/traces response carries `now` (its wall
clock at render time); comparing that against the master's clock midway
through the scrape (send time + RTT/2, the classic NTP estimate) yields
a per-node skew that is annotated on the result AND applied to a
`startAdjusted` field per span, so the merged timeline sorts sanely even
across machines that disagree by more than a span duration.  The
estimate is RTT-bounded, not exact — it is labeled, never silently
folded into `start`.
"""

from __future__ import annotations


def stitch_trace(trace_id: str, node_results: list[dict]) -> dict:
    """Merge per-node span lists for one trace id.

    `node_results` items: {
        "instance": "ip:port", "type": "volume" | "filer" | "master",
        "spans": [span dicts from /debug/traces],
        "skew_s": estimated node_clock - master_clock (0.0 for self),
        "rtt_s": scrape round trip (0.0 for self),
    }

    -> {"traceId", "spans": [...], "nodes": {...}, "startS", "durationMs"}
    with spans sorted by skew-adjusted start, each span annotated with
    `instance` and `startAdjusted`, and parent links marked `orphan` when
    the parent span id was not found anywhere in the merged set (its
    process died, or the ring evicted it).
    """
    spans: list[dict] = []
    nodes: dict[str, dict] = {}
    for res in node_results:
        instance = res["instance"]
        node_spans = res.get("spans", [])
        nodes[instance] = {
            "type": res.get("type", ""),
            "spanCount": len(node_spans),
            "clockSkewMs": round(res.get("skew_s", 0.0) * 1e3, 3),
            "scrapeRttMs": round(res.get("rtt_s", 0.0) * 1e3, 3),
        }
        for s in node_spans:
            s = dict(s)
            s["instance"] = instance
            s["startAdjusted"] = s["start"] - res.get("skew_s", 0.0)
            spans.append(s)
    known_ids = {s["spanId"] for s in spans}
    for s in spans:
        s["orphan"] = bool(s["parentId"]) and s["parentId"] not in known_ids
    spans.sort(key=lambda s: s["startAdjusted"])
    out = {"traceId": trace_id, "nodes": nodes, "spans": spans}
    if spans:
        t0 = spans[0]["startAdjusted"]
        t1 = max(s["startAdjusted"] + s["durationMs"] / 1e3 for s in spans)
        out["startS"] = round(t0, 6)
        out["durationMs"] = round((t1 - t0) * 1e3, 3)
    return out


def estimate_skew(node_now: float, sent_at: float, rtt_s: float) -> float:
    """node_clock - local_clock, assuming a symmetric network path."""
    return node_now - (sent_at + rtt_s / 2.0)
