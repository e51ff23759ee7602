"""Replica placement as pure functions over node snapshots.

Reference: weed/topology/volume_growth.go (pick main rack/DC then replicas)
and node_list.go.  Pure and deterministic given the candidate list and a
seed — the SURVEY.md §4 tier-3 test pattern.

The port's copy of seaweedfs_tpu/topology/placement.py.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..storage.replica_placement import ReplicaPlacement


@dataclass(frozen=True)
class Candidate:
    node_id: str
    data_center: str
    rack: str
    free_slots: int


def pick_nodes_for_write(
    candidates: list[Candidate],
    rp: ReplicaPlacement,
    data_center: str = "",
    rack: str = "",
    rng: random.Random | None = None,
) -> list[Candidate]:
    """Choose copy_count() nodes satisfying the XYZ placement policy.

    Raises ValueError when the topology can't satisfy the policy.
    """
    rng = rng or random.Random(0)
    usable = [c for c in candidates if c.free_slots > 0]
    if data_center:
        main_pool = [c for c in usable if c.data_center == data_center]
    else:
        main_pool = usable
    if rack:
        main_pool = [c for c in main_pool if c.rack == rack]
    if not main_pool:
        raise ValueError("no writable node in requested dc/rack")

    # group by dc -> rack
    by_dc: dict[str, dict[str, list[Candidate]]] = {}
    for c in usable:
        by_dc.setdefault(c.data_center, {}).setdefault(c.rack, []).append(c)

    # main dc must supply 1 + same_rack + diff_rack nodes
    def dc_ok(dc: str) -> bool:
        racks = by_dc[dc]
        sizes = sorted((len(v) for v in racks.values()), reverse=True)
        return (
            len(racks) >= 1 + rp.diff_rack
            and sum(sizes) >= 1 + rp.same_rack + rp.diff_rack
            and sizes[0] >= 1 + rp.same_rack
        )

    main_dcs = [c.data_center for c in main_pool]
    viable_dcs = [dc for dc in dict.fromkeys(main_dcs) if dc_ok(dc)]
    other_dcs = [dc for dc in by_dc if dc not in viable_dcs]
    if not viable_dcs:
        raise ValueError("replica placement unsatisfiable: no viable main dc")
    if len(by_dc) < 1 + rp.diff_dc:
        raise ValueError("replica placement unsatisfiable: not enough dcs")

    main_dc = rng.choice(viable_dcs)
    racks = by_dc[main_dc]
    viable_racks = [r for r, nodes in racks.items() if len(nodes) >= 1 + rp.same_rack]
    if rack and rack in viable_racks:
        viable_racks = [rack]
    if not viable_racks:
        raise ValueError("replica placement unsatisfiable: no rack with room")
    main_rack = rng.choice(viable_racks)

    picked: list[Candidate] = []
    # main node + same-rack copies
    rack_nodes = list(racks[main_rack])
    rng.shuffle(rack_nodes)
    need = 1 + rp.same_rack
    picked.extend(rack_nodes[:need])
    if len(picked) < need:
        raise ValueError("not enough nodes in main rack")
    # different racks in the same dc
    other_racks = [r for r in racks if r != main_rack]
    rng.shuffle(other_racks)
    if len(other_racks) < rp.diff_rack:
        raise ValueError("not enough racks for diff-rack copies")
    for r in other_racks[: rp.diff_rack]:
        picked.append(rng.choice(racks[r]))
    # different data centers
    dcs = [dc for dc in by_dc if dc != main_dc]
    rng.shuffle(dcs)
    if len(dcs) < rp.diff_dc:
        raise ValueError("not enough data centers for diff-dc copies")
    for dc in dcs[: rp.diff_dc]:
        all_nodes = [c for nodes in by_dc[dc].values() for c in nodes]
        picked.append(rng.choice(all_nodes))
    return picked


def ec_source_locality(rack: str, data_center: str,
                       my_rack: str, my_dc: str) -> str:
    """Locality label of a remote EC repair source relative to the
    rebuilder: `rack` = same rack (and DC), `dc` = anything beyond the
    rack boundary.  `local` (same node) never reaches here — local
    shards are read from disk, not fetched."""
    if rack and rack == my_rack and (not my_dc or data_center == my_dc):
        return "rack"
    return "dc"


def best_ec_holder(
    candidates: "list[tuple[str, str, str]]",
    my_rack: str = "",
    my_dc: str = "",
) -> "tuple[str, str, str]":
    """Best holder of one shard from its (address, rack, dc) candidate
    list: same-rack wins, address as tiebreak — the ONE rule shared by
    the rebuilder's client and the shell's `ec.rebuild -plan`, so the
    dry run can never diverge from what the rebuilder actually does."""
    return min(candidates, key=lambda h: (
        0 if ec_source_locality(h[1], h[2], my_rack, my_dc) == "rack"
        else 1, h[0]))


def order_ec_sources(
    holders: "dict[int, tuple[str, str, str]]",
    my_rack: str = "",
    my_dc: str = "",
) -> list[int]:
    """Rack/DC-aware remote source selection: order candidate source
    shard ids so same-rack holders are drawn first, then same-DC, then
    the rest — repair traffic prefers the cheap links (arXiv:1309.0186).
    `holders` maps shard id -> (address, rack, dc) of its best holder.
    Shard id breaks ties so the order is deterministic."""
    def rank(sid: int) -> tuple:
        _addr, rack, dc = holders[sid]
        same_rack = rack == my_rack and (not my_dc or dc == my_dc)
        same_dc = dc == my_dc
        return (0 if same_rack else 1 if same_dc else 2, sid)

    return sorted(holders, key=rank)


def group_partial_sources(
    holders: "dict[int, tuple[str, str, str]]",
) -> list[dict]:
    """Group chosen remote sources into one partial-sum request per
    rack: every member server computes its local coefficient-weighted
    sum, the group's aggregator folds them, and exactly ONE combined
    partial crosses the rack boundary per group.

    The aggregator is the member holding the most source shards (fewest
    delegate hops for the bulk of the bytes), address as tiebreak.
    Returns [{"rack", "dc", "aggregator", "members": {addr: [sids]}}]
    sorted by (dc, rack) for determinism."""
    by_rack: dict[tuple[str, str], dict[str, list[int]]] = {}
    for sid, (addr, rack, dc) in sorted(holders.items()):
        by_rack.setdefault((dc, rack), {}).setdefault(addr, []).append(sid)
    groups = []
    for (dc, rack), members in sorted(by_rack.items()):
        aggregator = max(members, key=lambda a: (len(members[a]), a))
        groups.append({
            "rack": rack,
            "dc": dc,
            "aggregator": aggregator,
            "members": members,
        })
    return groups


def spread_rebuild_targets(
    volumes: "list[dict]",
    candidates: "dict[str, int]",
) -> "dict[int, str]":
    """Assign one rebuild-target node per volume of a mass-repair batch
    so no single node becomes the write bottleneck: a hard cap of
    ceil(N / alive_nodes) + 1 assignments per node.

    ``volumes`` come pre-ranked (exposure order — the assignment keeps
    that order so the most exposed volumes get first pick of targets);
    each entry carries ``volume_id`` and ``holders`` (node -> count of
    surviving shards it holds).  ``candidates`` maps alive node ids to
    free EC slots.  Within the cap the node already holding the most
    surviving shards of the volume wins (its plan columns apply locally,
    off the wire), then most free slots, id as tiebreak."""
    import math

    if not candidates:
        return {}
    cap = math.ceil(len(volumes) / len(candidates)) + 1
    load = {n: 0 for n in candidates}
    out: dict[int, str] = {}
    for v in volumes:
        under_cap = [n for n in candidates if load[n] < cap]
        # a full node (no free EC slots left after its assignments so
        # far) cannot STORE the rebuilt shards — preferring it for its
        # local sources would park the job on no-space retries while
        # capacity sits idle elsewhere; only when EVERY node is full is
        # it allowed back in (the rebuild itself surfaces the no-space)
        eligible = [n for n in under_cap if candidates[n] - load[n] > 0]
        if not eligible:
            eligible = under_cap
        holders = v.get("holders", {})
        best = max(eligible, key=lambda n: (
            holders.get(n, 0), candidates[n] - load[n], n))
        out[v["volume_id"]] = best
        load[best] += 1
    return out


def balanced_ec_distribution(
    free_slots_by_node: dict[str, int], total_shards: int = 14
) -> dict[str, list[int]]:
    """Spread shard ids across nodes, most-free-first, round-robin.

    Mirrors balancedEcDistribution (command_ec_encode.go:248-264): each
    allocation goes to the node with the most remaining free EC slots.
    """
    remaining = dict(free_slots_by_node)
    out: dict[str, list[int]] = {n: [] for n in free_slots_by_node}
    for sid in range(total_shards):
        best = max(remaining, key=lambda n: (remaining[n], -len(out[n])))
        if remaining[best] <= 0:
            raise ValueError("not enough free EC slots for all shards")
        out[best].append(sid)
        remaining[best] -= 1
    return {n: sids for n, sids in out.items() if sids}
