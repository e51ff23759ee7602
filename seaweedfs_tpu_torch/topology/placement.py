"""EC repair-source placement as pure functions over holder maps — the
port's copy of the part of seaweedfs_tpu/topology/placement.py that the
partial-sum repair protocol (storage/ec/partial.py) and the volume server's
shard fetcher use: source locality, the best holder of a shard, the source
order and the grouping of sources per rack.  Replica placement for writes
and rebuild-target spreading come with the master's slice.
"""

from __future__ import annotations


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
