"""The /cluster/status document — the port's copy of the part of
seaweedfs_tpu/master/observability.py that the master's status pages and
the shell read: `cluster_status`.

The rest of the reference module (the federated /cluster/metrics,
/cluster/traces and /cluster/hot scrapes) comes with the federation slice
(ROADMAP A-5), and so do the blocks of the status document that report
planes this master does not have: `Health` (SLOs and canaries) and
`Raft`.
"""

from __future__ import annotations

import time


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
    return out
