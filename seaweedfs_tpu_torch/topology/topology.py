"""Cluster topology: DC -> rack -> data node tree with volume/EC bookkeeping.

Reference: weed/topology/ (node tree, topology.go, topology_ec.go).  The
tree is kept as flat dicts keyed by node id ("ip:port") with dc/rack
attributes — placement logic consumes snapshots, not the tree itself, so
the Go pointer-tree shape isn't load-bearing and is not reproduced.

The port's copy of seaweedfs_tpu/topology/topology.py.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..pb import master_pb2
from ..storage.ec.shard_bits import ShardBits


@dataclass
class VolumeInfo:
    volume_id: int
    size: int = 0
    collection: str = ""
    file_count: int = 0
    delete_count: int = 0
    deleted_byte_count: int = 0
    read_only: bool = False
    replica_placement: int = 0
    version: int = 3
    ttl: int = 0
    compact_revision: int = 0
    modified_at_second: int = 0
    disk_type: str = ""  # normalized: "" == hdd

    @classmethod
    def from_pb(cls, m: master_pb2.VolumeInformationMessage) -> "VolumeInfo":
        return cls(
            volume_id=m.id,
            size=m.size,
            collection=m.collection,
            file_count=m.file_count,
            modified_at_second=m.modified_at_second,
            delete_count=m.delete_count,
            deleted_byte_count=m.deleted_byte_count,
            read_only=m.read_only,
            replica_placement=m.replica_placement,
            version=m.version,
            ttl=m.ttl,
            compact_revision=m.compact_revision,
            disk_type=m.disk_type,
        )


@dataclass
class DataNode:
    id: str  # "ip:port" (HTTP url)
    public_url: str
    grpc_address: str
    data_center: str = "DefaultDataCenter"
    rack: str = "DefaultRack"
    max_volumes: int = 7
    volumes: dict = field(default_factory=dict)  # vid -> VolumeInfo
    ec_shards: dict = field(default_factory=dict)  # vid -> ShardBits
    ec_collections: dict = field(default_factory=dict)  # vid -> collection
    ec_shard_sizes: dict = field(default_factory=dict)  # vid -> bytes/shard
    last_seen: float = field(default_factory=time.monotonic)
    # per-disk-type capacity from the heartbeat's max_volume_counts map
    # (reference: Disk nodes under DataNode); empty -> one default tier
    max_volume_counts: dict = field(default_factory=dict)
    # disk-fault plane: dir -> {"state", "free_bytes", "total_bytes"}
    # from the heartbeat's DiskHealthMessage list; empty = unknown
    # (legacy node), treated as healthy
    disk_health: dict = field(default_factory=dict)

    def worst_disk_state(self) -> str:
        """The most degraded state across this node's data dirs
        ("healthy" when the node reports nothing)."""
        order = {"healthy": 0, "low_space": 1, "full": 2, "failing": 3}
        worst = "healthy"
        for d in self.disk_health.values():
            s = d.get("state", "healthy")
            if order.get(s, 0) > order[worst]:
                worst = s
        return worst

    def has_writable_disk(self) -> bool:
        """False when EVERY reported disk is full or failing: growth and
        rebuild placement must not target this node."""
        if not self.disk_health:
            return True
        return any(d.get("state") in ("healthy", "low_space", None)
                   for d in self.disk_health.values())

    def free_slots(self) -> int:
        if not self.has_writable_disk():
            return 0
        return self.max_volumes - len(self.volumes) - (len(self.ec_shards) + 9) // 10

    def disk_types(self) -> list[str]:
        return sorted(self.max_volume_counts) if self.max_volume_counts \
            else [""]

    def free_slots_for(self, disk_type: str) -> int:
        """Free volume slots on one disk tier (capacityByFreeVolumeCount,
        command_ec_common.go / command_volume_tier_move.go).  A node
        whose disks are all full/failing has no free slots on ANY tier —
        the watermark gates placement before ENOSPC can."""
        if not self.has_writable_disk():
            return 0
        cap = self.max_volume_counts.get(disk_type)
        if cap is None:
            if disk_type == "" and not self.max_volume_counts:
                cap = self.max_volumes  # legacy node: one default tier
            else:
                return 0
        used = sum(1 for v in self.volumes.values()
                   if v.disk_type == disk_type)
        return cap - used

    def free_ec_slots(self) -> int:
        if not self.has_writable_disk():
            return 0
        used = sum(ShardBits(b).count() for b in self.ec_shards.values())
        return (self.max_volumes - len(self.volumes)) * 10 - used


class Topology:
    def __init__(self, volume_size_limit: int = 30 * 1024**3,
                 pulse_seconds: float = 5.0):
        self.nodes: dict[str, DataNode] = {}
        self.volume_size_limit = volume_size_limit
        self.pulse_seconds = pulse_seconds
        self.lock = threading.RLock()
        self.max_volume_id = 0

    # -- membership -------------------------------------------------------

    def register_node(self, node: DataNode) -> "tuple[DataNode, bool]":
        """-> (node, was_new).  `was_new` is decided under the SAME lock
        acquisition that registers, so two concurrent streams for one
        node id can never both observe a join."""
        with self.lock:
            existing = self.nodes.get(node.id)
            if existing is None:
                self.nodes[node.id] = node
                return node, True
            existing.last_seen = time.monotonic()
            existing.public_url = node.public_url
            existing.grpc_address = node.grpc_address
            if node.data_center:
                existing.data_center = node.data_center
            if node.rack:
                existing.rack = node.rack
            if node.max_volumes:
                existing.max_volumes = node.max_volumes
            if node.max_volume_counts:
                existing.max_volume_counts = dict(node.max_volume_counts)
            return existing, False

    def unregister_node(self, node_id: str) -> list[int]:
        """Remove a node; returns vids whose locations changed."""
        with self.lock:
            node = self.nodes.pop(node_id, None)
            if node is None:
                return []
            return list(node.volumes) + list(node.ec_shards)

    def collect_dead_nodes(self) -> list[str]:
        """Nodes silent for 3 missed pulses (topology_event_handling.go:17)."""
        cutoff = time.monotonic() - 3 * self.pulse_seconds
        with self.lock:
            return [nid for nid, n in self.nodes.items() if n.last_seen < cutoff]

    # -- volume bookkeeping ----------------------------------------------

    def sync_volumes(self, node: DataNode,
                     volumes: list[master_pb2.VolumeInformationMessage]) -> None:
        with self.lock:
            node.volumes = {m.id: VolumeInfo.from_pb(m) for m in volumes}
            for m in volumes:
                self.max_volume_id = max(self.max_volume_id, m.id)
            node.last_seen = time.monotonic()

    def sync_ec_shards(self, node: DataNode,
                       shards: list[master_pb2.VolumeEcShardInformationMessage]) -> None:
        with self.lock:
            node.ec_shards = {m.id: ShardBits(m.ec_index_bits) for m in shards}
            node.ec_collections = {m.id: m.collection for m in shards}
            node.ec_shard_sizes = {m.id: m.shard_size for m in shards
                                   if m.shard_size}
            node.last_seen = time.monotonic()

    def apply_incremental(self, node: DataNode, hb: master_pb2.Heartbeat) -> None:
        with self.lock:
            for m in hb.new_volumes:
                node.volumes[m.id] = VolumeInfo(
                    volume_id=m.id, collection=m.collection,
                    replica_placement=m.replica_placement, version=m.version,
                    ttl=m.ttl,
                )
                self.max_volume_id = max(self.max_volume_id, m.id)
            for m in hb.deleted_volumes:
                node.volumes.pop(m.id, None)
            for m in hb.new_ec_shards:
                bits = node.ec_shards.get(m.id, ShardBits(0))
                node.ec_shards[m.id] = bits.plus(m.ec_index_bits)
                node.ec_collections[m.id] = m.collection
                if m.shard_size:
                    node.ec_shard_sizes[m.id] = m.shard_size
            for m in hb.deleted_ec_shards:
                bits = node.ec_shards.get(m.id, ShardBits(0))
                left = bits.minus(m.ec_index_bits)
                if left:
                    node.ec_shards[m.id] = left
                else:
                    node.ec_shards.pop(m.id, None)
            node.last_seen = time.monotonic()

    # -- lookups ----------------------------------------------------------

    def lookup_volume(self, vid: int) -> list[DataNode]:
        with self.lock:
            return [n for n in self.nodes.values() if vid in n.volumes]

    def lookup_ec_shards(self, vid: int) -> dict[int, list[DataNode]]:
        """shard id -> nodes holding it."""
        out: dict[int, list[DataNode]] = {}
        with self.lock:
            for n in self.nodes.values():
                bits = n.ec_shards.get(vid)
                if bits is None:
                    continue
                for sid in ShardBits(bits).shard_ids():
                    out.setdefault(sid, []).append(n)
        return out

    def next_volume_id(self) -> int:
        with self.lock:
            self.max_volume_id += 1
            return self.max_volume_id

    def collections(self) -> set[str]:
        with self.lock:
            names = set()
            for n in self.nodes.values():
                for v in n.volumes.values():
                    names.add(v.collection)
                for c in n.ec_collections.values():
                    names.add(c)
            return names

    def to_topology_info(self) -> master_pb2.TopologyInfo:
        """Snapshot for VolumeList / shell placement logic."""
        info = master_pb2.TopologyInfo(id="topo")
        with self.lock:
            dcs: dict[str, master_pb2.DataCenterInfo] = {}
            racks: dict[tuple[str, str], master_pb2.RackInfo] = {}
            for n in self.nodes.values():
                dc = dcs.get(n.data_center)
                if dc is None:
                    dc = info.data_center_infos.add(id=n.data_center)
                    dcs[n.data_center] = dc
                rack_key = (n.data_center, n.rack)
                rack = racks.get(rack_key)
                if rack is None:
                    rack = dc.rack_infos.add(id=n.rack)
                    racks[rack_key] = rack
                dn = rack.data_node_infos.add(id=n.id)
                # one DiskInfo per disk type (reference DataNodeInfo
                # diskInfos map; "" == hdd default tier); the union with
                # volume-reported types keeps a volume visible even if the
                # node's capacity map doesn't advertise its tier
                types = sorted(set(n.disk_types())
                               | {v.disk_type for v in n.volumes.values()})
                for dt in types:
                    disk = dn.disk_infos[dt]
                    vols = [v for v in n.volumes.values()
                            if v.disk_type == dt]
                    disk.volume_count = len(vols)
                    disk.max_volume_count = (
                        n.max_volume_counts.get(dt, n.max_volumes))
                    disk.free_volume_count = n.free_slots_for(dt)
                    disk.active_volume_count = len(vols)
                    for v in vols:
                        disk.volume_infos.add(
                            id=v.volume_id,
                            size=v.size,
                            collection=v.collection,
                            file_count=v.file_count,
                            delete_count=v.delete_count,
                            deleted_byte_count=v.deleted_byte_count,
                            read_only=v.read_only,
                            replica_placement=v.replica_placement,
                            version=v.version,
                            ttl=v.ttl,
                            modified_at_second=v.modified_at_second,
                            disk_type=v.disk_type,
                        )
                # EC shards stay on the default tier's DiskInfo
                disk = dn.disk_infos[n.disk_types()[0]]
                for vid, bits in n.ec_shards.items():
                    disk.ec_shard_infos.add(
                        id=vid,
                        collection=n.ec_collections.get(vid, ""),
                        ec_index_bits=int(bits),
                    )
        return info
