"""EC admin commands: ec.encode / ec.rebuild / ec.balance / ec.decode.

Client-side orchestration over gRPC, mirroring the reference's protocol
(command_ec_encode.go:24-35 documents the 6 steps):
  1. mark the volume readonly on every replica
  2. VolumeEcShardsGenerate on one holder (this is where `-codec=tpu` lands)
  3. spread shards: balanced allocation by free EC slots, targets PULL via
     VolumeEcShardsCopy, then VolumeEcShardsMount
  4. unmount + delete moved shards on the source
  5. delete the original volume from all replicas
Shard bookkeeping flows back to the master via heartbeat deltas.

The port's copy of seaweedfs_tpu/shell/ec_commands.py.
"""

from __future__ import annotations

import time

import grpc

from ..pb import master_pb2
from ..pb import volume_server_pb2 as vs
from ..storage.ec.constants import TOTAL_SHARDS
from ..storage.ec.shard_bits import ShardBits
from ..topology.placement import balanced_ec_distribution
from .commands import CommandEnv, register


def _parse_flags(args: list[str]) -> dict[str, str]:
    out = {}
    for a in args:
        if a.startswith("-"):
            k, _, v = a.lstrip("-").partition("=")
            out[k] = v if v else "true"
    return out


def _parse_duration(s: str) -> float:
    """"24h" / "90m" / "1.5h" / "300s" -> seconds (the port's copy of
    the reference's shell/fs_commands.py::_parse_duration)."""
    units = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
    total, num = 0.0, ""
    for ch in s:
        if ch.isdigit() or ch == ".":
            num += ch
        elif ch in units and num:
            total += float(num) * units[ch]
            num = ""
        else:
            raise ValueError(f"bad duration {s!r}")
    if num:
        total += float(num)
    return total


def _iter_nodes(topo: master_pb2.TopologyInfo):
    for dc in topo.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                yield dc.id, rack.id, dn


def _node_grpc(dn_id: str) -> str:
    host, port = dn_id.rsplit(":", 1)
    return f"{host}:{int(port) + 10000}"


def _volume_locations(topo, vid: int) -> list[str]:
    out = []
    for _dc, _rack, dn in _iter_nodes(topo):
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                if v.id == vid:
                    out.append(dn.id)
    return out


def _free_ec_slots(dn) -> int:
    free = 0
    for disk in dn.disk_infos.values():
        used_shards = sum(
            ShardBits(e.ec_index_bits).count() for e in disk.ec_shard_infos
        )
        free += max(
            (disk.max_volume_count - disk.volume_count) * 10 - used_shards, 0
        )
    return free


def collect_volume_ids_for_ec_encode(
    topo: master_pb2.TopologyInfo,
    volume_size_limit: int,
    full_percent: float,
    collection: str = "",
    quiet_for_seconds: float = 0,
    now: float | None = None,
) -> list[int]:
    """Pure selection logic (tier-3 testable): volumes full enough to
    freeze AND quiet for the requested window — encoding a volume under
    an active write burst would readonly it mid-stream
    (command_ec_encode.go collectVolumeIdsForEcEncode)."""
    if now is None:
        now = time.time()
    vids = set()
    for _dc, _rack, dn in _iter_nodes(topo):
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                if collection and v.collection != collection:
                    continue
                if v.size < volume_size_limit * full_percent / 100.0:
                    continue
                if (quiet_for_seconds > 0 and v.modified_at_second
                        and now - v.modified_at_second < quiet_for_seconds):
                    continue
                vids.add(v.id)
    return sorted(vids)


@register("ec.encode")
def ec_encode(env: CommandEnv, args: list[str]) -> str:
    flags = _parse_flags(args)
    collection = flags.get("collection", "")
    full_percent = float(flags.get("fullPercent", "95"))
    quiet_for = _parse_duration(flags.get("quietFor", "0"))
    codec = flags.get("codec", "")
    explicit_vid = int(flags["volumeId"]) if "volumeId" in flags else None

    topo = env.topology()
    limit = env.volume_size_limit()
    if explicit_vid is not None:
        vids = [explicit_vid]
    else:
        vids = collect_volume_ids_for_ec_encode(
            topo, limit, full_percent, collection,
            quiet_for_seconds=quiet_for,
        )
    # every volume encodes under its OWN collection — the flag only
    # FILTERS the selection; passing it through verbatim would generate
    # shards under one name and try to mount them under another
    vid_collection: dict[int, str] = {}
    for _dc, _rack, dn in _iter_nodes(topo):
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                vid_collection[v.id] = v.collection
    out = []
    for vid in vids:
        out.append(do_ec_encode(
            env, topo, vid, vid_collection.get(vid, collection), codec))
    return "\n".join(out) if out else "ec.encode: no volumes selected"


def do_ec_encode(env: CommandEnv, topo, vid: int, collection: str,
                 codec: str = "", delete_source: bool = True,
                 leader_epoch: int = 0) -> str:
    """Encode one volume to EC shards and spread them.

    `delete_source=False` (the lifecycle controller's tier pipeline)
    keeps the sealed source volume mounted read-only after the shards
    mount, so its .dat can still move to a remote tier — the reference
    flow (and the default) deletes the original from every replica."""
    locations = _volume_locations(topo, vid)
    if not locations:
        # freshly grown volumes may not be in the heartbeat snapshot yet;
        # the master's layout-backed lookup has them immediately
        resp = env.master().LookupVolume(
            master_pb2.LookupVolumeRequest(volume_or_file_ids=[str(vid)])
        )
        for entry in resp.volume_id_locations:
            locations = [loc.url for loc in entry.locations]
    if not locations:
        return f"ec.encode {vid}: no locations"
    if not collection:
        # a volume outside the heartbeat snapshot (LookupVolume fallback)
        # must still encode under its OWN collection — ask its holder
        try:
            st = env.volume_server(_node_grpc(locations[0])) \
                .ReadVolumeFileStatus(
                    vs.ReadVolumeFileStatusRequest(volume_id=vid))
            collection = st.collection
        except grpc.RpcError:
            pass
    # 1. freeze writes on every replica (`leader_epoch` fences the
    # lifecycle-driven path; 0 = an operator at the shell, unfenced)
    for loc in locations:
        env.volume_server(_node_grpc(loc)).VolumeMarkReadonly(
            vs.VolumeMarkReadonlyRequest(
                volume_id=vid, leader_epoch=leader_epoch)
        )
    source = locations[0]
    # 2. generate shards on the source (the TPU codec dispatch point)
    env.volume_server(_node_grpc(source)).VolumeEcShardsGenerate(
        vs.VolumeEcShardsGenerateRequest(
            volume_id=vid, collection=collection, codec=codec,
            leader_epoch=leader_epoch,
        )
    )
    # 3. spread shards by free EC slots
    nodes = {dn.id: dn for _dc, _rack, dn in _iter_nodes(topo)}
    free = {nid: _free_ec_slots(dn) for nid, dn in nodes.items()}
    free[source] = max(free.get(source, 0), 1)  # source can keep shards
    plan = balanced_ec_distribution(free, TOTAL_SHARDS)
    moved_from_source = []
    for target, sids in plan.items():
        if target == source:
            env.volume_server(_node_grpc(source)).VolumeEcShardsMount(
                vs.VolumeEcShardsMountRequest(
                    volume_id=vid, collection=collection, shard_ids=sids
                )
            )
            continue
        env.volume_server(_node_grpc(target)).VolumeEcShardsCopy(
            vs.VolumeEcShardsCopyRequest(
                volume_id=vid,
                collection=collection,
                shard_ids=sids,
                copy_ecx_file=True,
                copy_ecj_file=True,
                copy_vif_file=True,
                copy_from_data_node=_node_grpc(source),
                leader_epoch=leader_epoch,
            )
        )
        env.volume_server(_node_grpc(target)).VolumeEcShardsMount(
            vs.VolumeEcShardsMountRequest(
                volume_id=vid, collection=collection, shard_ids=sids
            )
        )
        moved_from_source.extend(sids)
    # 4. drop moved shard files from the source
    if moved_from_source:
        env.volume_server(_node_grpc(source)).VolumeEcShardsDelete(
            vs.VolumeEcShardsDeleteRequest(
                volume_id=vid, collection=collection,
                shard_ids=moved_from_source,
            )
        )
    # 5. delete the original volume everywhere (unless the caller keeps
    # the sealed source for a later tier move)
    if delete_source:
        for loc in locations:
            env.volume_server(_node_grpc(loc)).VolumeDelete(
                vs.VolumeDeleteRequest(
                    volume_id=vid, leader_epoch=leader_epoch)
            )
    return f"ec.encode {vid}: spread {dict((k, v) for k, v in plan.items())}"


@register("ec.rebuild")
def ec_rebuild(env: CommandEnv, args: list[str]) -> str:
    """ec.rebuild [-plan] [-gather] [-codec=NAME]

    Default: the rebuilder regenerates missing shards IN PLACE, sourcing
    remote intervals through the partial-sum protocol (or full interval
    streams when partials are unavailable) — no shard files are staged.
    `-gather` restores the legacy copy-everything-first flow.  `-plan`
    is a DRY RUN: print the chosen sources per lost shard with rack/DC
    and the expected bytes over each hop, touch nothing."""
    flags = _parse_flags(args)
    codec = flags.get("codec", "")
    plan_only = "plan" in flags
    gather = "gather" in flags
    topo = env.topology()
    node_locality: dict[str, tuple[str, str]] = {}
    # vid -> {node_id: bits}
    holdings: dict[int, dict[str, ShardBits]] = {}
    collections: dict[int, str] = {}
    for dc, rack, dn in _iter_nodes(topo):
        node_locality[dn.id] = (rack, dc)
        for disk in dn.disk_infos.values():
            for e in disk.ec_shard_infos:
                holdings.setdefault(e.id, {})[dn.id] = ShardBits(e.ec_index_bits)
                collections[e.id] = e.collection
    out = []
    for vid, by_node in sorted(holdings.items()):
        have = ShardBits(0)
        for bits in by_node.values():
            have = have.plus(bits)
        count = have.count()
        if count == TOTAL_SHARDS:
            continue
        if count < 10:
            out.append(f"ec.rebuild {vid}: unrepairable ({count} shards)")
            continue
        if plan_only:
            out.append(_plan_one(
                env, vid, by_node, have, node_locality))
        else:
            out.append(_rebuild_one(
                env, vid, collections.get(vid, ""), by_node, have, codec,
                gather=gather))
    return "\n".join(out) if out else "ec.rebuild: nothing to do"


def _rebuild_plan(vid: int, by_node: dict[str, ShardBits], have: ShardBits,
                  node_locality: dict[str, tuple[str, str]]) -> dict:
    """Pure planning for one volume's partial-sum rebuild (tier-3
    testable): rebuilder, lost shards, locality-ordered sources, and the
    per-rack aggregation groups the protocol will form."""
    from ..topology.placement import (
        best_ec_holder,
        group_partial_sources,
        order_ec_sources,
    )

    rebuilder = max(by_node, key=lambda n: by_node[n].count())
    my_rack, my_dc = node_locality.get(rebuilder, ("", ""))
    local = sorted(by_node[rebuilder].shard_ids())
    lost = [s for s in range(TOTAL_SHARDS) if not have.has(s)]
    # best holder per non-local shard: same-rack holders win
    candidates: dict[int, list[tuple[str, str, str]]] = {}
    for node, bits in by_node.items():
        if node == rebuilder:
            continue
        rack, dc = node_locality.get(node, ("", ""))
        for sid in bits.shard_ids():
            if sid not in local:
                candidates.setdefault(sid, []).append((node, rack, dc))
    holders = {sid: best_ec_holder(cands, my_rack, my_dc)
               for sid, cands in candidates.items()}
    sources = local[:10]
    chosen: dict[int, tuple[str, str, str]] = {}
    for sid in order_ec_sources(holders, my_rack, my_dc):
        if len(sources) >= 10:
            break
        sources.append(sid)
        chosen[sid] = holders[sid]
    return {
        "rebuilder": rebuilder,
        "rebuilder_rack": my_rack,
        "rebuilder_dc": my_dc,
        "lost": lost,
        "local_sources": sources[: len(sources) - len(chosen)],
        "remote_sources": chosen,
        "groups": group_partial_sources(chosen),
    }


def _plan_one(env: CommandEnv, vid: int, by_node: dict[str, ShardBits],
              have: ShardBits,
              node_locality: dict[str, tuple[str, str]]) -> str:
    from ..storage.ec.partial import probe_shard_size
    from ..topology.placement import ec_source_locality

    plan = _rebuild_plan(vid, by_node, have, node_locality)
    rebuilder = plan["rebuilder"]
    m = len(plan["lost"])
    try:
        shard_size = probe_shard_size(
            env.volume_server(_node_grpc(rebuilder)), vid)
    except grpc.RpcError:
        shard_size = 0

    def mb(n: int) -> str:
        return f"{n / 1e6:.1f} MB" if shard_size else f"{n}x shard"

    unit = shard_size if shard_size else 1
    lines = [
        f"ec.rebuild {vid} (plan): lost {plan['lost']} -> rebuilder "
        f"{rebuilder} ({plan['rebuilder_dc']}/{plan['rebuilder_rack']})"
        + (f", shard {mb(unit)}" if shard_size else ""),
        f"  local sources {plan['local_sources']}: 0 B over the wire",
    ]
    ingress = 0
    for g in plan["groups"]:
        label = ec_source_locality(
            g["rack"], g["dc"], plan["rebuilder_rack"], plan["rebuilder_dc"])
        member_s = " + ".join(
            f"{addr}{sids}" for addr, sids in sorted(g["members"].items()))
        intra = sum(len(s) for a, s in g["members"].items()
                    if a != g["aggregator"])
        lines.append(
            f"  {label:4s} {g['dc']}/{g['rack']}: {member_s} -> agg "
            f"{g['aggregator']}, {mb(m * unit)} to rebuilder"
            + (f" (+{mb(m * unit * intra)} intra-rack)" if intra else ""))
        ingress += m * unit
    full = len(plan["remote_sources"]) * unit
    if plan["remote_sources"]:
        ratio = full / ingress if ingress else 0.0
        lines.append(
            f"  partial ingress {mb(ingress)} vs full fetch {mb(full)} "
            f"({ratio:.1f}x)"
            + ("" if ratio >= 1.0 else
               " — full fetch preferred (rebuilder chooses it)"))
    return "\n".join(lines)


def _rebuild_one(env: CommandEnv, vid: int, collection: str,
                 by_node: dict[str, ShardBits], have: ShardBits,
                 codec: str = "", gather: bool = False) -> str:
    # rebuilder = node already holding the most shards
    rebuilder = max(by_node, key=lambda n: by_node[n].count())
    stub = env.volume_server(_node_grpc(rebuilder))
    local = by_node[rebuilder]
    if gather:
        # legacy flow: pull every shard the rebuilder lacks before the
        # local rebuild (moves full shard widths; kept for operators on
        # clusters with partial-apply disabled)
        for node, bits in by_node.items():
            if node == rebuilder:
                continue
            need = [s for s in bits.shard_ids() if not local.has(s)]
            if not need:
                continue
            stub.VolumeEcShardsCopy(
                vs.VolumeEcShardsCopyRequest(
                    volume_id=vid, collection=collection, shard_ids=need,
                    copy_from_data_node=_node_grpc(node),
                )
            )
            for s in need:
                local = local.add(s)
    resp = stub.VolumeEcShardsRebuild(
        vs.VolumeEcShardsRebuildRequest(
            volume_id=vid, collection=collection, codec=codec)
    )
    rebuilt = list(resp.rebuilt_shard_ids)
    if rebuilt:
        stub.VolumeEcShardsMount(
            vs.VolumeEcShardsMountRequest(
                volume_id=vid, collection=collection, shard_ids=rebuilt
            )
        )
    # drop the staging copies that are mounted elsewhere
    staged = [
        s for s in local.shard_ids()
        if s not in rebuilt and not by_node[rebuilder].has(s)
    ]
    if staged:
        stub.VolumeEcShardsDelete(
            vs.VolumeEcShardsDeleteRequest(
                volume_id=vid, collection=collection, shard_ids=staged
            )
        )
    return f"ec.rebuild {vid}: rebuilt {rebuilt} on {rebuilder}"


def plan_ec_balance_moves(topo, collection: str = "") -> list[dict]:
    """Pure shard-move planning from one topology snapshot (tier-3
    testable; -collection scopes both the counting and the moves,
    command_ec_balance.go)."""
    nodes = {dn.id: dn for _dc, _rack, dn in _iter_nodes(topo)}
    free = {nid: _free_ec_slots(dn) for nid, dn in nodes.items()}
    on_node: dict[str, list[tuple[int, int, str]]] = {n: [] for n in nodes}
    for _dc, _rack, dn in _iter_nodes(topo):
        for disk in dn.disk_infos.values():
            for e in disk.ec_shard_infos:
                if collection and e.collection != collection:
                    continue
                for sid in ShardBits(e.ec_index_bits).shard_ids():
                    on_node[dn.id].append((e.id, sid, e.collection))
    shard_count = {nid: len(s) for nid, s in on_node.items()}
    if not any(shard_count.values()):
        return []
    moves: list[dict] = []
    avg = sum(shard_count.values()) / max(len(shard_count), 1)
    for nid in list(nodes):
        while shard_count[nid] > avg + 1:
            target = max(
                free, key=lambda n: (free[n] - shard_count[n], n != nid))
            if target == nid or free[target] <= 0 or not on_node[nid]:
                break
            vid, sid, coll = on_node[nid].pop(0)
            moves.append({"volumeId": vid, "shardId": sid,
                          "collection": coll,
                          "source": nid, "target": target})
            shard_count[nid] -= 1
            shard_count[target] = shard_count.get(target, 0) + 1
            free[target] -= 1
    return moves


def apply_ec_move(env: CommandEnv, move: dict) -> str:
    """Execute one planned shard move: copy+mount on the target, then
    unmount+delete on the source (the two-phase order keeps the shard
    readable throughout)."""
    vid, sid = move["volumeId"], move["shardId"]
    coll = move.get("collection", "")
    source, target = move["source"], move["target"]
    tgt = env.volume_server(_node_grpc(target))
    tgt.VolumeEcShardsCopy(
        vs.VolumeEcShardsCopyRequest(
            volume_id=vid, collection=coll, shard_ids=[sid],
            copy_ecx_file=True, copy_ecj_file=True, copy_vif_file=True,
            copy_from_data_node=_node_grpc(source),
        )
    )
    tgt.VolumeEcShardsMount(
        vs.VolumeEcShardsMountRequest(
            volume_id=vid, collection=coll, shard_ids=[sid])
    )
    src = env.volume_server(_node_grpc(source))
    src.VolumeEcShardsUnmount(
        vs.VolumeEcShardsUnmountRequest(volume_id=vid, shard_ids=[sid])
    )
    src.VolumeEcShardsDelete(
        vs.VolumeEcShardsDeleteRequest(
            volume_id=vid, collection=coll, shard_ids=[sid])
    )
    return f"{vid}.{sid} {source} -> {target}"


@register("ec.balance")
def ec_balance(env: CommandEnv, args: list[str]) -> str:
    """Move shards from loaded nodes to nodes with more free EC slots.

    ec.balance [-apply] [-collection=NAME]  — default is a DRY RUN that
    prints the planned moves; -apply (or the legacy -force) executes
    them (command_ec_balance.go)."""
    flags = _parse_flags(args)
    apply_changes = "apply" in flags or "force" in flags
    collection = flags.get("collection", "")
    moves = plan_ec_balance_moves(env.topology(), collection)
    if not moves:
        return "ec.balance: balanced"
    lines = [f"ec.balance: {len(moves)} move(s) planned"]
    for mv in moves:
        lines.append(
            f"  {mv['volumeId']}.{mv['shardId']} {mv['source']} -> "
            f"{mv['target']}"
            + ("" if apply_changes else " (dry run, -apply to move)"))
    if not apply_changes:
        return "\n".join(lines)
    for mv in moves:
        try:
            lines.append(apply_ec_move(env, mv))
        except grpc.RpcError as e:
            lines.append(f"  {mv['volumeId']}.{mv['shardId']} FAILED: "
                         f"{e.code()}")
            break
    return "\n".join(lines)


@register("ec.decode")
def ec_decode(env: CommandEnv, args: list[str]) -> str:
    flags = _parse_flags(args)
    vid = int(flags["volumeId"]) if "volumeId" in flags else None
    collection = flags.get("collection", "")
    topo = env.topology()
    holdings: dict[int, dict[str, ShardBits]] = {}
    collections: dict[int, str] = {}
    for _dc, _rack, dn in _iter_nodes(topo):
        for disk in dn.disk_infos.values():
            for e in disk.ec_shard_infos:
                holdings.setdefault(e.id, {})[dn.id] = ShardBits(e.ec_index_bits)
                collections[e.id] = e.collection
    targets = [vid] if vid is not None else sorted(holdings)
    out = []
    for v in targets:
        by_node = holdings.get(v)
        if not by_node:
            out.append(f"ec.decode {v}: no shards")
            continue
        coll = collection or collections.get(v, "")
        # gather all shards onto the node with the most
        gather = max(by_node, key=lambda n: by_node[n].count())
        stub = env.volume_server(_node_grpc(gather))
        local = by_node[gather]
        for node, bits in by_node.items():
            if node == gather:
                continue
            need = [s for s in bits.shard_ids() if not local.has(s)]
            if need:
                stub.VolumeEcShardsCopy(
                    vs.VolumeEcShardsCopyRequest(
                        volume_id=v, collection=coll, shard_ids=need,
                        copy_ecx_file=True, copy_ecj_file=True,
                        copy_from_data_node=_node_grpc(node),
                    )
                )
                for s in need:
                    local = local.add(s)
        stub.VolumeEcShardsToVolume(
            vs.VolumeEcShardsToVolumeRequest(volume_id=v, collection=coll)
        )
        # drop EC remnants cluster-wide
        for node in by_node:
            env.volume_server(_node_grpc(node)).VolumeEcShardsDelete(
                vs.VolumeEcShardsDeleteRequest(
                    volume_id=v, collection=coll,
                    shard_ids=list(range(TOTAL_SHARDS)),
                )
            )
        out.append(f"ec.decode {v}: restored on {gather}")
    return "\n".join(out)
