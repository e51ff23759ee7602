"""Volume admin commands: volume.list / volume.vacuum / volume.fix.replication
/ volume.balance / volume.move / volume.mount / volume.unmount / volume.delete
/ volume.lifecycle / volume.repair.

Reference: weed/shell/command_volume_*.go.  Placement decisions are pure
functions over the TopologyInfo snapshot (tier-3 test pattern).

The port's copy of seaweedfs_tpu/shell/volume_commands.py, with
`volume.tier.upload` / `volume.tier.download` (a volume's `.dat` to and
from a remote tier) and `volume.tier.move` (between disk types).
"""

from __future__ import annotations

import grpc

from ..pb import master_pb2
from ..pb import volume_server_pb2 as vs
from ..storage.replica_placement import ReplicaPlacement
from .commands import CommandEnv, register
from .ec_commands import _iter_nodes, _node_grpc, _parse_flags  # noqa: F401


@register("volume.list")
def volume_list(env: CommandEnv, args: list[str]) -> str:
    topo = env.topology()
    lines = []
    for dc, rack, dn in _iter_nodes(topo):
        for disk in dn.disk_infos.values():
            vols = [
                f"v{v.id}(size={v.size} files={v.file_count}"
                f"{' ro' if v.read_only else ''})"
                for v in disk.volume_infos
            ]
            ecs = [
                f"ec{e.id}[{bin(e.ec_index_bits)}]" for e in disk.ec_shard_infos
            ]
            lines.append(
                f"{dc}/{rack}/{dn.id}: {' '.join(vols + ecs) or '(empty)'}"
            )
    return "\n".join(lines)


@register("volume.vacuum")
def volume_vacuum(env: CommandEnv, args: list[str]) -> str:
    flags = _parse_flags(args)
    threshold = float(flags.get("garbageThreshold", "0.3"))
    env.master().VacuumVolume(
        master_pb2.VacuumVolumeRequest(garbage_threshold=threshold)
    )
    return "vacuum triggered"


@register("volume.scrub")
def volume_scrub(env: CommandEnv, args: list[str]) -> str:
    """On-demand integrity scan: verify needle CRCs / EC parity on disk.

    volume.scrub [-node ip:port] [-volumeId N] [-rate MBps]
    Without -node, every node is scrubbed (restricted to holders when
    -volumeId is given); findings are also queued for the master's
    repair pass via the next heartbeat."""
    flags = _parse_flags(args)
    vid = int(flags.get("volumeId", "0") or 0)
    rate = float(flags.get("rate", "0") or 0)
    if "node" in flags:
        nodes = [flags["node"]]
    else:
        nodes = []
        for _dc, _rack, dn in _iter_nodes(env.topology()):
            if vid:
                holds = any(
                    v.id == vid
                    for disk in dn.disk_infos.values()
                    for v in disk.volume_infos
                ) or any(
                    e.id == vid
                    for disk in dn.disk_infos.values()
                    for e in disk.ec_shard_infos
                )
                if not holds:
                    continue
            nodes.append(dn.id)
    if not nodes:
        return f"no node holds volume {vid}" if vid else "no nodes"
    lines = []
    for node in nodes:
        try:
            resp = env.volume_server(_node_grpc(node)).VolumeScrub(
                vs.VolumeScrubRequest(volume_id=vid, rate_mbps=rate)
            )
        except grpc.RpcError as e:
            lines.append(f"{node}: error: {e}")
            continue
        lines.append(
            f"{node}: scanned={resp.scanned} bytes={resp.scanned_bytes}"
            f" corruptNeedles={resp.corrupt_needles}"
            f" corruptShards={resp.corrupt_shards}"
            f" indexRepairs={resp.index_repairs}"
        )
        for line in resp.findings:
            lines.append(f"  finding: {line}")
    return "\n".join(lines)


@register("volume.mount")
def volume_mount(env: CommandEnv, args: list[str]) -> str:
    flags = _parse_flags(args)
    env.volume_server(_node_grpc(flags["node"])).VolumeMount(
        vs.VolumeMountRequest(volume_id=int(flags["volumeId"]))
    )
    return "mounted"


@register("volume.unmount")
def volume_unmount(env: CommandEnv, args: list[str]) -> str:
    flags = _parse_flags(args)
    env.volume_server(_node_grpc(flags["node"])).VolumeUnmount(
        vs.VolumeUnmountRequest(volume_id=int(flags["volumeId"]))
    )
    return "unmounted"


@register("volume.delete")
def volume_delete(env: CommandEnv, args: list[str]) -> str:
    flags = _parse_flags(args)
    env.volume_server(_node_grpc(flags["node"])).VolumeDelete(
        vs.VolumeDeleteRequest(volume_id=int(flags["volumeId"]))
    )
    return "deleted"


@register("volume.move")
def volume_move(env: CommandEnv, args: list[str]) -> str:
    """Copy a volume to a target node, then delete from the source.
    -source/-target are public node ids (ip:port as volume.list prints),
    the same convention as every other node-taking command."""
    flags = _parse_flags(args)
    vid = int(flags["volumeId"])
    source, target = flags["source"], flags["target"]
    _require_distinct_copy(env, vid, source, target)
    _node, collection = _locate_volume(env, vid)
    env.volume_server(_node_grpc(target)).VolumeCopy(
        vs.VolumeCopyRequest(
            volume_id=vid, collection=collection,
            source_data_node=_node_grpc(source),
        )
    )
    env.volume_server(_node_grpc(source)).VolumeDelete(
        vs.VolumeDeleteRequest(volume_id=vid))
    return f"moved {vid} {source} -> {target}"


def _require_distinct_copy(env: CommandEnv, vid: int, source: str,
                           target: str) -> None:
    """Refuse a copy that would truncate the .dat being streamed: the
    target must be a different node that does not already hold vid."""
    if source == target:
        raise RuntimeError(f"source and target are both {source}")
    for _dc, _rack, dn in _iter_nodes(env.topology()):
        if dn.id != target:
            continue
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                if v.id == vid:
                    raise RuntimeError(
                        f"{target} already holds volume {vid}")


@register("volume.copy")
def volume_copy(env: CommandEnv, args: list[str]) -> str:
    """Copy a volume to a target node, keeping the source
    (command_volume_copy.go)."""
    flags = _parse_flags(args)
    vid = int(flags["volumeId"])
    source, target = flags["source"], flags["target"]
    _require_distinct_copy(env, vid, source, target)
    _node, collection = _locate_volume(env, vid)
    env.volume_server(_node_grpc(target)).VolumeCopy(
        vs.VolumeCopyRequest(
            volume_id=vid, collection=collection,
            source_data_node=_node_grpc(source),
        )
    )
    return f"copied {vid} {source} -> {target}"


@register("volume.mark")
def volume_mark(env: CommandEnv, args: list[str]) -> str:
    """Mark a volume readonly or writable on a node
    (command_volume_mark.go)."""
    flags = _parse_flags(args)
    vid = int(flags["volumeId"])
    node = flags.get("node") or _locate_volume(env, vid)[0]
    stub = env.volume_server(_node_grpc(node))
    if flags.get("writable") == "true":
        stub.VolumeMarkWritable(vs.VolumeMarkWritableRequest(volume_id=vid))
        return f"volume {vid} marked writable on {node}"
    stub.VolumeMarkReadonly(vs.VolumeMarkReadonlyRequest(volume_id=vid))
    return f"volume {vid} marked readonly on {node}"


@register("volume.configure.replication")
def volume_configure_replication(env: CommandEnv, args: list[str]) -> str:
    """Change a volume's replica placement in its super block on every
    holder (command_volume_configure_replication.go)."""
    flags = _parse_flags(args)
    vid = int(flags["volumeId"])
    replication = flags["replication"]
    ReplicaPlacement.parse(replication)  # validate before touching servers
    changed = []
    for _dc, _rack, dn in _iter_nodes(env.topology()):
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                if v.id != vid:
                    continue
                resp = env.volume_server(_node_grpc(dn.id)).VolumeConfigure(
                    vs.VolumeConfigureRequest(
                        volume_id=vid, replication=replication
                    )
                )
                if resp.error:
                    raise RuntimeError(resp.error)
                changed.append(dn.id)
    if not changed:
        raise RuntimeError(f"volume {vid} not found in topology")
    return f"volume {vid} replication={replication} on {sorted(set(changed))}"


@register("volume.server.leave")
def volume_server_leave(env: CommandEnv, args: list[str]) -> str:
    """Ask one volume server to stop heartbeating and leave the cluster
    (command_volume_server_leave.go)."""
    flags = _parse_flags(args)
    node = flags["node"]
    env.volume_server(_node_grpc(node)).VolumeServerLeave(
        vs.VolumeServerLeaveRequest())
    return f"{node} asked to leave"


def _locate_volume(env: CommandEnv, vid: int) -> tuple[str, str]:
    """-> (node_url, collection) of the first holder of vid."""
    for _dc, _rack, dn in _iter_nodes(env.topology()):
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                if v.id == vid:
                    return dn.id, v.collection
    raise RuntimeError(f"volume {vid} not found in topology")


@register("volume.tier.upload")
def volume_tier_upload(env: CommandEnv, args: list[str]) -> str:
    """Move a volume's .dat to a remote tier backend; the index stays
    local and reads keep working through ranged requests.
    Reference: weed/shell/command_volume_tier_upload.go."""
    flags = _parse_flags(args)
    vid = int(flags["volumeId"])
    dest = flags.get("dest", "s3.default")
    keep = flags.get("keepLocalDatFile", "false") == "true"
    node = _node_grpc(flags.get("node") or _locate_volume(env, vid)[0])
    env.volume_server(node).VolumeMarkReadonly(
        vs.VolumeMarkReadonlyRequest(volume_id=vid))
    processed = 0
    for resp in env.volume_server(node).VolumeTierMoveDatToRemote(
            vs.VolumeTierMoveDatToRemoteRequest(
                volume_id=vid, destination_backend_name=dest,
                keep_local_dat_file=keep)):
        processed = resp.processed
    return f"volume {vid} .dat -> {dest} ({processed} bytes)"


@register("volume.tier.download")
def volume_tier_download(env: CommandEnv, args: list[str]) -> str:
    """Bring a tiered volume's .dat back to local disk and make it
    writable again (weed/shell/command_volume_tier_download.go)."""
    flags = _parse_flags(args)
    vid = int(flags["volumeId"])
    node = _node_grpc(flags.get("node") or _locate_volume(env, vid)[0])
    processed = 0
    for resp in env.volume_server(node).VolumeTierMoveDatFromRemote(
            vs.VolumeTierMoveDatFromRemoteRequest(volume_id=vid)):
        processed = resp.processed
    env.volume_server(node).VolumeMarkWritable(
        vs.VolumeMarkWritableRequest(volume_id=vid))
    return f"volume {vid} .dat downloaded ({processed} bytes)"


def find_misplaced_volumes(topo: master_pb2.TopologyInfo) -> dict[int, dict]:
    """Pure analysis: vid -> {want, have, locations} for under/over-replication."""
    placements: dict[int, dict] = {}
    for dc, rack, dn in _iter_nodes(topo):
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                p = placements.setdefault(
                    v.id,
                    {"want": ReplicaPlacement.from_byte(v.replica_placement)
                     .copy_count(), "locations": [], "collection": v.collection},
                )
                p["locations"].append((dc, rack, dn.id))
    return {
        vid: {**p, "have": len(p["locations"])}
        for vid, p in placements.items()
        if len(p["locations"]) != p["want"]
    }


@register("volume.fix.replication")
def volume_fix_replication(env: CommandEnv, args: list[str]) -> str:
    topo = env.topology()
    issues = find_misplaced_volumes(topo)
    if not issues:
        return "volume.fix.replication: all volumes healthy"
    nodes = {dn.id: dn for _dc, _rack, dn in _iter_nodes(topo)}
    fixed = []
    for vid, info in sorted(issues.items()):
        have, want = info["have"], info["want"]
        locs = [n for _dc, _rack, n in info["locations"]]
        if have < want:
            candidates = [
                nid for nid, dn in nodes.items()
                if nid not in locs and _free_slots(dn) > 0
            ]
            if not candidates:
                fixed.append(f"{vid}: under-replicated, no target")
                continue
            target = candidates[0]
            try:
                env.volume_server(_node_grpc(target)).VolumeCopy(
                    vs.VolumeCopyRequest(
                        volume_id=vid, collection=info["collection"],
                        source_data_node=_node_grpc(locs[0]),
                    )
                )
                fixed.append(f"{vid}: copied to {target}")
            except grpc.RpcError as e:
                fixed.append(f"{vid}: copy failed: {e.code()}")
        elif have > want:
            victim = locs[-1]
            try:
                env.volume_server(_node_grpc(victim)).VolumeDelete(
                    vs.VolumeDeleteRequest(volume_id=vid)
                )
                fixed.append(f"{vid}: removed extra replica on {victim}")
            except grpc.RpcError as e:
                fixed.append(f"{vid}: delete failed: {e.code()}")
    return "\n".join(fixed)


def _free_slots(dn) -> int:
    free = 0
    for disk in dn.disk_infos.values():
        free += max(disk.max_volume_count - disk.volume_count, 0)
    return free


def plan_volume_balance_moves(topo) -> list[dict]:
    """Pure move planning (tier-3 testable, shared with the lifecycle
    controller's rebalance jobs): greedy donor->recipient moves that even
    out per-node volume counts, computed from ONE topology snapshot.
    A target already holding a replica of the volume is never picked —
    the copy would overwrite it and the source delete would silently
    drop the cluster one replica short — and among a donor's movable
    volumes, one whose REMAINING replicas sit outside the target's rack
    is preferred, so rebalance restores rack diversity instead of
    quietly collapsing a volume's replicas into one rack."""
    nodes = {dn.id: dn for _dc, _rack, dn in _iter_nodes(topo)}
    racks = {dn.id: (dc, rack) for dc, rack, dn in _iter_nodes(topo)}
    counts = {
        nid: sum(d.volume_count for d in dn.disk_infos.values())
        for nid, dn in nodes.items()
    }
    if not counts:
        return []
    holders: dict[int, set[str]] = {}
    on_node: dict[str, list[int]] = {nid: [] for nid in nodes}
    for _dc, _rack, dn in _iter_nodes(topo):
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                holders.setdefault(v.id, set()).add(dn.id)
                on_node[dn.id].append(v.id)

    def pick_vid(donor: str, target: str):
        fallback = None
        for v in on_node[donor]:
            if target in holders.get(v, set()):
                continue
            sibling_racks = {racks[h] for h in holders.get(v, set())
                             if h != donor and h in racks}
            if racks.get(target) not in sibling_racks:
                return v  # rack-diverse move: take it
            if fallback is None:
                fallback = v
        return fallback

    moves: list[dict] = []
    avg = sum(counts.values()) / len(counts)
    for nid in sorted(counts, key=counts.get, reverse=True):
        while counts[nid] > avg + 1:
            target = min(counts, key=counts.get)
            if counts[target] >= avg:
                break
            vid = pick_vid(nid, target)
            if vid is None:
                break
            moves.append({"volumeId": vid, "source": nid,
                          "target": target})
            on_node[nid].remove(vid)
            on_node[target].append(vid)
            holders[vid].discard(nid)
            holders[vid].add(target)
            counts[nid] -= 1
            counts[target] += 1
    return moves


def apply_volume_move(env: CommandEnv, move: dict) -> str:
    """Execute one planned move (copy to target, delete from source)."""
    return volume_move(env, [
        f"-volumeId={move['volumeId']}",
        f"-source={move['source']}",
        f"-target={move['target']}",
    ])


@register("volume.balance")
def volume_balance(env: CommandEnv, args: list[str]) -> str:
    """Even out volume counts across nodes (greedy, like the reference).

    volume.balance [-apply]  — default is a DRY RUN that prints the
    planned moves; -apply (or the legacy -force) executes them.  The
    lifecycle controller's rebalance jobs reuse the same planner."""
    flags = _parse_flags(args)
    apply_changes = "apply" in flags or "force" in flags
    moves = plan_volume_balance_moves(env.topology())
    if not moves:
        return "volume.balance: balanced"
    lines = [f"volume.balance: {len(moves)} move(s) planned"]
    for mv in moves:
        lines.append(f"  v{mv['volumeId']} {mv['source']} -> {mv['target']}"
                     + ("" if apply_changes
                        else " (dry run, -apply to move)"))
    if not apply_changes:
        return "\n".join(lines)
    for mv in moves:
        try:
            lines.append(apply_volume_move(env, mv))
        except (grpc.RpcError, RuntimeError) as e:
            lines.append(f"  v{mv['volumeId']} FAILED: {e}")
            break
    return "\n".join(lines)


@register("volume.evacuate")
def volume_evacuate(env: CommandEnv, args: list[str]) -> str:
    """Move every volume and EC shard off a node, then tell it to leave
    (command_volume_server_evacuate.go)."""
    flags = _parse_flags(args)
    node = flags["node"]  # ip:port (http)
    topo = env.topology()
    nodes = {dn.id: dn for _dc, _rack, dn in _iter_nodes(topo)}
    if node not in nodes:
        return f"volume.evacuate: node {node} not found"
    targets = [
        nid for nid in nodes
        if nid != node and _free_slots(nodes[nid]) > 0
    ]
    if not targets:
        return "volume.evacuate: no target nodes with free slots"
    # a node already holding a replica of vid must not be picked as its
    # target — VolumeCopy would overwrite it and the delete on the source
    # would silently drop the cluster one replica short
    holders: dict[int, set[str]] = {}
    for _dc, _rack, dn in _iter_nodes(topo):
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                holders.setdefault(v.id, set()).add(dn.id)
    moved, i = [], 0
    for disk in nodes[node].disk_infos.values():
        for v in disk.volume_infos:
            eligible = [
                t_ for t_ in targets if t_ not in holders.get(v.id, set())
            ]
            if not eligible:
                moved.append(f"v{v.id} SKIPPED: every target holds a replica")
                continue
            target = eligible[i % len(eligible)]
            i += 1
            try:
                volume_move(
                    env,
                    [f"-volumeId={v.id}", f"-source={node}",
                     f"-target={target}"],
                )
                moved.append(f"v{v.id}->{target}")
            except grpc.RpcError as e:
                moved.append(f"v{v.id} FAILED: {e.code()}")
        for ec in disk.ec_shard_infos:
            target = targets[i % len(targets)]
            i += 1
            shard_ids = _bits_to_ids(ec.ec_index_bits)
            try:
                env.volume_server(_node_grpc(target)).VolumeEcShardsCopy(
                    vs.VolumeEcShardsCopyRequest(
                        volume_id=ec.id, collection=ec.collection,
                        shard_ids=shard_ids, copy_ecx_file=True,
                        copy_ecj_file=True, copy_vif_file=True,
                        copy_from_data_node=_node_grpc(node),
                    )
                )
                env.volume_server(_node_grpc(target)).VolumeEcShardsMount(
                    vs.VolumeEcShardsMountRequest(
                        volume_id=ec.id, collection=ec.collection,
                        shard_ids=shard_ids,
                    )
                )
                env.volume_server(_node_grpc(node)).VolumeEcShardsUnmount(
                    vs.VolumeEcShardsUnmountRequest(
                        volume_id=ec.id, shard_ids=shard_ids
                    )
                )
                env.volume_server(_node_grpc(node)).VolumeEcShardsDelete(
                    vs.VolumeEcShardsDeleteRequest(
                        volume_id=ec.id, collection=ec.collection,
                        shard_ids=shard_ids,
                    )
                )
                moved.append(f"ec{ec.id}{shard_ids}->{target}")
            except grpc.RpcError as e:
                moved.append(f"ec{ec.id} FAILED: {e.code()}")
    if flags.get("leave", "true") != "false":
        try:
            env.volume_server(_node_grpc(node)).VolumeServerLeave(
                vs.VolumeServerLeaveRequest()
            )
        except grpc.RpcError:
            pass
    return f"volume.evacuate {node}: " + (", ".join(moved) or "nothing to move")


def _bits_to_ids(bits: int) -> list[int]:
    return [i for i in range(14) if bits & (1 << i)]


def find_replica_divergence(statuses: dict[int, list[tuple[str, object]]]):
    """Pure analysis: vid -> list of (node, file_count, dat_size) when
    replicas disagree (command_volume_check_disk.go's comparison)."""
    out = {}
    for vid, pairs in statuses.items():
        if len(pairs) < 2:
            continue
        counts = {(st.file_count, st.dat_file_size) for _n, st in pairs}
        if len(counts) > 1:
            out[vid] = [
                (n, st.file_count, st.dat_file_size) for n, st in pairs
            ]
    return out


def _collect_volume_statuses(env: CommandEnv, topo) -> dict:
    statuses: dict[int, list] = {}
    for _dc, _rack, dn in _iter_nodes(topo):
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                try:
                    st = env.volume_server(_node_grpc(dn.id)).ReadVolumeFileStatus(
                        vs.ReadVolumeFileStatusRequest(volume_id=v.id)
                    )
                    statuses.setdefault(v.id, []).append((dn.id, st))
                except grpc.RpcError:
                    continue
    return statuses


@register("volume.fsck")
def volume_fsck(env: CommandEnv, args: list[str]) -> str:
    """Report replicas whose file counts / sizes disagree
    (command_volume_fsck.go's consistency sweep, metadata level)."""
    topo = env.topology()
    diverged = find_replica_divergence(_collect_volume_statuses(env, topo))
    if not diverged:
        return "volume.fsck: all replicas consistent"
    lines = []
    for vid, infos in sorted(diverged.items()):
        detail = ", ".join(f"{n}: {fc} files/{sz}B" for n, fc, sz in infos)
        lines.append(f"volume {vid} diverged: {detail}")
    return "\n".join(lines)


@register("volume.check.disk")
def volume_check_disk(env: CommandEnv, args: list[str]) -> str:
    """Repair diverged replicas by tail-syncing the smaller from the
    larger (command_volume_check_disk.go)."""
    flags = _parse_flags(args)
    apply_changes = flags.get("force", "false") != "false"
    topo = env.topology()
    diverged = find_replica_divergence(_collect_volume_statuses(env, topo))
    if not diverged:
        return "volume.check.disk: all replicas consistent"
    lines = []
    for vid, infos in sorted(diverged.items()):
        best = max(infos, key=lambda x: (x[1], x[2]))
        for node, fc, sz in infos:
            if node == best[0]:
                continue
            if not apply_changes:
                lines.append(
                    f"volume {vid}: {node} ({fc} files) behind "
                    f"{best[0]} ({best[1]} files) — rerun with -force to sync"
                )
                continue
            try:
                env.volume_server(_node_grpc(node)).VolumeTailReceiver(
                    vs.VolumeTailReceiverRequest(
                        volume_id=vid,
                        since_ns=0,
                        idle_timeout_seconds=1,
                        source_volume_server=best[0],
                    )
                )
                lines.append(f"volume {vid}: synced {node} from {best[0]}")
            except grpc.RpcError as e:
                lines.append(f"volume {vid}: sync failed: {e.code()}")
    return "\n".join(lines)


def collect_volume_ids_for_tier_change(
        topo, volume_size_limit: int, from_disk_type: str,
        collection: str = "", full_percent: float = 95.0,
        quiet_for_seconds: float = 0, now: "float | None" = None,
) -> list[int]:
    """Pure selection: quiet, full volumes currently on the source tier
    (collectVolumeIdsForTierChange, command_volume_tier_move.go:153-180)."""
    import time as _time

    from ..storage.disk_location import normalize_disk_type

    if now is None:
        now = _time.time()
    want = normalize_disk_type(from_disk_type)
    vids = set()
    for _dc, _rack, dn in _iter_nodes(topo):
        for disk in dn.disk_infos.values():
            for v in disk.volume_infos:
                if normalize_disk_type(v.disk_type) != want:
                    continue
                if collection and v.collection != collection:
                    continue
                if v.size < volume_size_limit * full_percent / 100.0:
                    continue
                if (quiet_for_seconds > 0 and v.modified_at_second
                        and now - v.modified_at_second < quiet_for_seconds):
                    continue
                vids.add(v.id)
    return sorted(vids)


def pick_tier_move_target(topo, vid: int, to_disk_type: str
                          ) -> "tuple[str, str] | None":
    """Pure placement: -> (source_node, target_node) or None.  Target =
    node with the most free slots on the target tier that does not
    already hold the volume (doVolumeTierMove,
    command_volume_tier_move.go:93-150)."""
    from ..storage.disk_location import normalize_disk_type

    want = normalize_disk_type(to_disk_type)
    holders = []
    candidates = []
    for _dc, _rack, dn in _iter_nodes(topo):
        holds = False
        free = 0
        for dt, disk in dn.disk_infos.items():
            for v in disk.volume_infos:
                if v.id == vid:
                    holds = True
            if normalize_disk_type(dt) == want:
                free = max(free, disk.max_volume_count - disk.volume_count)
        if holds:
            holders.append(dn.id)
        elif free > 0:
            candidates.append((free, dn.id))
    if not holders or not candidates:
        return None
    candidates.sort(reverse=True)
    return holders[0], candidates[0][1]


@register("volume.tier.move")
def volume_tier_move(env: CommandEnv, args: list[str]) -> str:
    """Move quiet, full volumes from one disk tier to another
    (command_volume_tier_move.go).  Only one replica moves; the rest are
    dropped — follow with volume.fix.replication / volume.balance, as
    SeaweedFS documents."""
    from ..storage.disk_location import normalize_disk_type, \
        readable_disk_type
    from .ec_commands import _parse_duration

    flags = _parse_flags(args)
    from_dt = flags.get("fromDiskType", "")
    to_dt = flags.get("toDiskType", "")
    if readable_disk_type(from_dt) == readable_disk_type(to_dt):
        raise RuntimeError(
            f"source tier {readable_disk_type(from_dt)} is the same as "
            f"target tier {readable_disk_type(to_dt)}")
    collection = flags.get("collection", "")
    full_percent = float(flags.get("fullPercent", "95"))
    quiet_for = _parse_duration(flags.get("quietFor", "0"))
    apply_changes = "force" in flags
    if "volumeId" in flags:
        vids = [int(flags["volumeId"])]
    else:
        topo = env.topology()
        vids = collect_volume_ids_for_tier_change(
            topo, env.volume_size_limit(), from_dt, collection,
            full_percent, quiet_for)
    lines = [f"tier move volumes: {vids}"]
    for vid in vids:
        topo = env.topology()
        picked = pick_tier_move_target(topo, vid, to_dt)
        if picked is None:
            lines.append(
                f"volume {vid}: no node with free "
                f"{readable_disk_type(to_dt)} capacity")
            continue
        source, target = picked
        lines.append(
            f"moving volume {vid} from {source} to {target} with disk "
            f"type {readable_disk_type(to_dt)}"
            + ("" if apply_changes else " (dry run, -force to apply)"))
        if not apply_changes:
            continue
        # reuse the in-hand snapshot for the replica scan AND the
        # collection lookup — no extra VolumeList round trips per volume
        replicas = []
        collection_of = ""
        for _dc, _rack, dn in _iter_nodes(topo):
            for d in dn.disk_infos.values():
                for v in d.volume_infos:
                    if v.id == vid:
                        collection_of = v.collection
                        if dn.id not in replicas:
                            replicas.append(dn.id)
        for node in replicas:
            env.volume_server(_node_grpc(node)).VolumeMarkReadonly(
                vs.VolumeMarkReadonlyRequest(volume_id=vid))
        env.volume_server(_node_grpc(target)).VolumeCopy(
            vs.VolumeCopyRequest(
                volume_id=vid, collection=collection_of,
                source_data_node=_node_grpc(source),
                disk_type=normalize_disk_type(to_dt) or "hdd"))
        for node in replicas:
            env.volume_server(_node_grpc(node)).VolumeDelete(
                vs.VolumeDeleteRequest(volume_id=vid))
        env.volume_server(_node_grpc(target)).VolumeMarkWritable(
            vs.VolumeMarkWritableRequest(volume_id=vid))
        lines.append(f"moved volume {vid} -> {target}")
    return "\n".join(lines)


@register("volume.lifecycle")
def volume_lifecycle(env: CommandEnv, args: list[str]) -> str:
    """Operate the master's lifecycle controller.

    volume.lifecycle                      — controller status + job list
    volume.lifecycle -dry-run [...]       — evaluate policies, print plan
    volume.lifecycle -apply [...]         — evaluate AND execute now
    volume.lifecycle -policy='<json>'     — install a policy set
    Filters for -dry-run/-apply: -volumeId=N -transition=NAME."""
    import json as _json

    flags = _parse_flags(args)
    if "policy" in flags:
        resp = env.master().Lifecycle(master_pb2.LifecycleRequest(
            action="policy", policy_json=flags["policy"]))
        return "lifecycle policy updated:\n" + resp.report
    if "apply" in flags or "dry-run" in flags or "run" in flags:
        resp = env.master().Lifecycle(master_pb2.LifecycleRequest(
            action="run",
            apply="apply" in flags,
            volume_id=int(flags.get("volumeId", "0") or 0),
            transition=flags.get("transition", ""),
        ))
        doc = _json.loads(resp.report)
        lines = []
        planned = doc.get("planned", [])
        lines.append(f"planned: {len(planned)} transition(s)"
                     + ("" if "apply" in flags
                        else " (dry run, -apply to execute)"))
        for p in planned:
            lines.append(
                f"  v{p['volume_id']} {p['transition']}"
                f" on {p.get('node', '?')} ({p.get('bytes', 0)} bytes)")
        for r in doc.get("results", []):
            lines.append(f"  {r.get('key')}: {r.get('state')}"
                         + (f" — {r['detail']}" if r.get("detail") else "")
                         + (f" — {r['error']}" if r.get("error") else ""))
        return "\n".join(lines)
    resp = env.master().Lifecycle(
        master_pb2.LifecycleRequest(action="status"))
    doc = _json.loads(resp.report)
    lines = [
        f"lifecycle: enabled={doc['enabled']} running={doc['running']}"
        f" interval={doc['intervalSeconds']}s rate={doc['rateMBps']}MB/s",
        f"journal: {doc['journalPath'] or '(memory only)'}"
        f" states={doc['jobStates']}",
        f"counts: {doc['counts']}",
    ]
    for j in doc.get("jobs", [])[-16:]:
        lines.append(
            f"  {j['key']}: {j['state']} attempts={j.get('attempts', 0)}"
            + (f" — {j['detail']}" if j.get("detail") else "")
            + (f" — {j['error']}" if j.get("error") else ""))
    return "\n".join(lines)


@register("volume.repair")
def volume_repair(env: CommandEnv, args: list[str]) -> str:
    """Operate the master's dead-node mass-repair orchestrator.

    volume.repair                — orchestrator status + recent jobs
    volume.repair -plan          — rank affected volumes by exposure,
                                   print targets; touches nothing
    volume.repair -apply         — plan, journal and execute the batch
    -node=ip:port tags the plan with the dead node it answers for."""
    import json as _json

    flags = _parse_flags(args)
    node = flags.get("node", "")
    if "plan" in flags or "apply" in flags:
        resp = env.master().Lifecycle(master_pb2.LifecycleRequest(
            action=("mass_repair_run" if "apply" in flags
                    else "mass_repair_plan"),
            node=node))
        doc = _json.loads(resp.report)
        planned = doc.get("planned", [])
        lines = [f"mass repair: {len(planned)} volume(s) planned"
                 + ("" if "apply" in flags
                    else " (dry run, -apply to execute)")]
        for p in planned:
            lines.append(
                f"  v{p['volume_id']} surviving={p['surviving']}"
                f" -> {p['node']} ({p.get('bytes', 0)} bytes)")
        for r in doc.get("results", []):
            lines.append(f"  {r.get('key')}: {r.get('state')}"
                         + (f" — {r['error']}" if r.get("error") else ""))
        return "\n".join(lines)
    resp = env.master().Lifecycle(
        master_pb2.LifecycleRequest(action="mass_repair_status"))
    doc = _json.loads(resp.report)
    lines = [
        f"mass repair: enabled={doc['enabled']} pending={doc['pending']}"
        f" deadline={doc['deadlineSeconds']}s"
        f" rateFloor={doc['rateFloorMBps']}MB/s",
        f"counts: {doc['counts']}",
    ]
    for j in doc.get("jobs", [])[-16:]:
        lines.append(
            f"  {j['key']}: {j['state']} attempts={j.get('attempts', 0)}"
            + (f" — {j['detail']}" if j.get("detail") else "")
            + (f" — {j['error']}" if j.get("error") else ""))
    return "\n".join(lines)


@register("lock")
def lock_cmd(env: CommandEnv, args: list[str]) -> str:
    return "locked" if env.acquire_lock() else "lock busy"


@register("unlock")
def unlock_cmd(env: CommandEnv, args: list[str]) -> str:
    env.release_lock()
    return "unlocked"
