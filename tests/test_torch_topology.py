"""The port's topology, volume layouts and placement held against the
reference's on the same seeded heartbeats: the same node tree, writable
sets, EC shard maps, dead-node sweeps and placement plans.  Random picks
run with both packages' generators seeded the same way, each through its
own module (never the global `random`)."""

import random

import numpy as np
import pytest

from seaweedfs_tpu.pb import master_pb2 as ref_pb
from seaweedfs_tpu.storage.replica_placement import \
    ReplicaPlacement as RefRP
from seaweedfs_tpu.topology import placement as ref_place
from seaweedfs_tpu.topology import topology as ref_topo
from seaweedfs_tpu.topology import volume_layout as ref_layout
from seaweedfs_tpu_torch.pb import master_pb2 as port_pb
from seaweedfs_tpu_torch.storage.replica_placement import \
    ReplicaPlacement as PortRP
from seaweedfs_tpu_torch.topology import placement as port_place
from seaweedfs_tpu_torch.topology import topology as port_topo
from seaweedfs_tpu_torch.topology import volume_layout as port_layout

PKGS = {
    "ref": (ref_pb, ref_topo, ref_layout, ref_place, RefRP),
    "port": (port_pb, port_topo, port_layout, port_place, PortRP),
}


def _beats(seed: int, nodes: int = 6) -> list[dict]:
    """Seeded heartbeat streams as plain dicts: a full beat per node, then
    incremental beats adding and dropping volumes and EC shards."""
    rng = np.random.default_rng(seed)
    out = []
    vid = 0
    for i in range(nodes):
        vols = []
        for _ in range(int(rng.integers(0, 5))):
            vid += 1
            vols.append({"id": vid, "size": int(rng.integers(0, 1 << 30)),
                         "collection": ["", "pics", "logs"][vid % 3],
                         "file_count": int(rng.integers(0, 1000)),
                         "read_only": bool(rng.integers(0, 4) == 0),
                         "replica_placement": [0, 1, 16][vid % 3],
                         "modified_at_second": 1_700_000_000 + vid})
        ec = [{"id": 100 + j, "collection": "ec",
               "ec_index_bits": int(rng.integers(1, 1 << 14)),
               "shard_size": 1 << 20} for j in range(int(rng.integers(0, 3)))]
        out.append({"ip": "10.0.0.%d" % (i + 1), "port": 8080 + i,
                    "data_center": f"dc{i % 2}", "rack": f"r{i % 3}",
                    "max_volume_counts": {"": 7 + i},
                    "volumes": vols, "has_no_volumes": not vols,
                    "ec_shards": ec, "has_no_ec_shards": not ec})
    for i in range(nodes):
        vid += 1
        out.append({"ip": "10.0.0.%d" % (i + 1), "port": 8080 + i,
                    "new_volumes": [{"id": vid, "collection": "",
                                     "replica_placement": 1}],
                    "new_ec_shards": [{"id": 100, "collection": "ec",
                                       "ec_index_bits": 1 << (i % 14)}],
                    "deleted_ec_shards": [{"id": 101, "collection": "ec",
                                           "ec_index_bits": 0b11}]})
    return out


def _ingest(pkg: str, beats: list[dict]):
    """The master's heartbeat ingest (master/grpc_handlers.py's
    SendHeartbeat) on one package's Topology, without the server."""
    pb, topo_mod, *_ = PKGS[pkg]
    topo = topo_mod.Topology(volume_size_limit=1 << 30, pulse_seconds=1.0)
    for b in beats:
        hb = pb.Heartbeat(**b)
        node = topo_mod.DataNode(
            id=f"{hb.ip}:{hb.port}", public_url=f"{hb.ip}:{hb.port}",
            grpc_address=f"{hb.ip}:{hb.port + 10000}",
            data_center=hb.data_center or "DefaultDataCenter",
            rack=hb.rack or "DefaultRack",
            max_volumes=sum(hb.max_volume_counts.values()) or 7,
            max_volume_counts=dict(hb.max_volume_counts))
        node, _new = topo.register_node(node)
        if hb.volumes or hb.has_no_volumes:
            topo.sync_volumes(node, list(hb.volumes))
        if hb.ec_shards or hb.has_no_ec_shards:
            topo.sync_ec_shards(node, list(hb.ec_shards))
        if hb.new_volumes or hb.deleted_volumes or hb.new_ec_shards \
                or hb.deleted_ec_shards:
            topo.apply_incremental(node, hb)
    return topo


def _ec_map(topo) -> dict:
    out = {}
    for vid in sorted({v for n in topo.nodes.values() for v in n.ec_shards}):
        out[vid] = {sid: [n.id for n in ns]
                    for sid, ns in topo.lookup_ec_shards(vid).items()}
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_heartbeats_build_the_same_topology(seed):
    beats = _beats(seed)
    ref, port = _ingest("ref", beats), _ingest("port", beats)
    # the node tree and every volume, byte for byte on the wire
    assert port.to_topology_info().SerializeToString() \
        == ref.to_topology_info().SerializeToString()
    assert port.max_volume_id == ref.max_volume_id
    assert _ec_map(port) == _ec_map(ref)
    assert port.collections() == ref.collections()
    for nid, rn in ref.nodes.items():
        pn = port.nodes[nid]
        assert (pn.free_slots(), pn.free_ec_slots(), pn.free_slots_for(""),
                pn.worst_disk_state()) == (
            rn.free_slots(), rn.free_ec_slots(), rn.free_slots_for(""),
            rn.worst_disk_state())
        for vid in rn.volumes:
            assert [n.id for n in port.lookup_volume(vid)] \
                == [n.id for n in ref.lookup_volume(vid)]
    # a node leaves: the same vids change location, the rest stays equal
    victim = sorted(ref.nodes)[seed % len(ref.nodes)]
    assert port.unregister_node(victim) == ref.unregister_node(victim)
    assert port.to_topology_info().SerializeToString() \
        == ref.to_topology_info().SerializeToString()


def test_dead_node_sweep_matches():
    """collect_dead_nodes: the nodes silent for 3 pulses, the same on both
    packages for the same last-seen instants (set relative to the clock
    both read, so no clock is patched)."""
    import time

    beats = _beats(7)
    ref, port = _ingest("ref", beats), _ingest("port", beats)
    now = time.monotonic()
    for topo in (ref, port):
        for i, nid in enumerate(sorted(topo.nodes)):
            # pulse 1 s: silent 10 s is dead, 0.5 s is alive
            topo.nodes[nid].last_seen = now - (10.0 if i % 2 else 0.5)
    dead = ref.collect_dead_nodes()
    assert dead and len(dead) < len(ref.nodes)
    assert port.collect_dead_nodes() == dead


@pytest.mark.parametrize("rp", ["000", "001", "010", "100"])
def test_volume_layouts_keep_the_same_writable_sets(rp):
    layouts = {}
    rng = np.random.default_rng(int(rp, 2))
    ops = [(int(rng.integers(1, 12)), f"n{int(rng.integers(0, 4))}",
            int(rng.integers(0, 2 << 20)), bool(rng.integers(0, 5) == 0),
            bool(rng.integers(0, 6) == 0)) for _ in range(80)]
    for pkg, (_pb, _t, layout_mod, _p, RP) in PKGS.items():
        lay = layout_mod.VolumeLayout(RP.parse(rp), "", 1 << 20)
        picks = []
        for vid, node, size, ro, drop in ops:
            if drop:
                lay.unregister(vid, node)
            else:
                lay.register(vid, node, size, ro)
                lay.set_oversized(vid, size)
            try:
                picks.append(lay.pick_for_write())
            except LookupError:
                picks.append(None)
        layouts[pkg] = (sorted(lay.writable), sorted(lay.readonly),
                        sorted(lay.oversized), dict(lay.locations),
                        lay.active_writable_count(), picks)
    assert layouts["port"] == layouts["ref"]


def _candidates(pkg: str, seed: int):
    place = PKGS[pkg][3]
    rng = np.random.default_rng(seed)
    return [place.Candidate(f"n{i}", f"dc{int(rng.integers(0, 2))}",
                            f"r{int(rng.integers(0, 3))}",
                            int(rng.integers(0, 4)))
            for i in range(10)]


@pytest.mark.parametrize("rp", ["000", "001", "010", "100", "011", "200"])
@pytest.mark.parametrize("seed", [0, 5])
def test_pick_nodes_for_write_with_seeded_generators(rp, seed):
    """The same candidates and policy, each package's generator seeded
    alike: the same picks, or the same refusal."""
    out = {}
    for pkg in PKGS:
        place, RP = PKGS[pkg][3], PKGS[pkg][4]
        try:
            got = [c.node_id for c in place.pick_nodes_for_write(
                _candidates(pkg, seed), RP.parse(rp),
                rng=random.Random(seed))]
        except ValueError as e:
            got = f"ValueError: {e}"
        out[pkg] = got
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("free", [
    {"a": 390, "b": 390, "c": 390},
    {"b": 400, "c": 390, "a": 380},
    {"a": 1, "b": 50, "c": 3, "d": 0},
    {"x": 5, "y": 5},
])
def test_balanced_ec_distribution_plans_alike(free):
    plans = []
    for pkg in PKGS:
        try:
            plans.append(PKGS[pkg][3].balanced_ec_distribution(dict(free), 14))
        except ValueError as e:
            plans.append(str(e))
    assert plans[0] == plans[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spread_rebuild_targets_plans_alike(seed):
    rng = np.random.default_rng(seed)
    nodes = [f"n{i}" for i in range(5)]
    volumes = [{"volume_id": v, "holders": {
        n: int(rng.integers(0, 6)) for n in nodes if rng.integers(0, 2)}}
        for v in range(1, 13)]
    candidates = {n: int(rng.integers(0, 8)) for n in nodes}
    assert port_place.spread_rebuild_targets(volumes, dict(candidates)) \
        == ref_place.spread_rebuild_targets(volumes, dict(candidates))
