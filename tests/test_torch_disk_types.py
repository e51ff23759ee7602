"""volume.tier.move in the port, held against the reference's
tests/test_disk_types.py case for case.

The two pure functions (`collect_volume_ids_for_tier_change`,
`pick_tier_move_target`) get the same topologies in both packages, the
reference's two hand-built ones and seeded random ones, and must give the
same answers.  Then the shell command runs through the port's shell on a
port cluster (a master, two ssd volume servers and one hdd volume
server): a dry run moves nothing and prints what the reference's shell
prints for the same cluster; `-force` moves a volume ssd -> hdd with its
.dat equal by sha256 and its blob readable; a volume held by two ssd
replicas lands once on the hdd node and leaves neither replica behind;
a same-tier move is refused.
"""

import hashlib
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from helpers import free_port
from torch_threads import one_torch_thread  # noqa: F401

from seaweedfs_tpu.pb import master_pb2 as ref_master_pb
from seaweedfs_tpu.shell import commands as ref_shell
from seaweedfs_tpu.shell.volume_commands import (
    collect_volume_ids_for_tier_change as ref_collect,
)
from seaweedfs_tpu.shell.volume_commands import (
    pick_tier_move_target as ref_pick,
)
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.pb import master_pb2 as port_master_pb
from seaweedfs_tpu_torch.pb import rpc as rpclib
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.shell import commands as port_shell
from seaweedfs_tpu_torch.shell.volume_commands import (
    collect_volume_ids_for_tier_change as port_collect,
)
from seaweedfs_tpu_torch.shell.volume_commands import (
    pick_tier_move_target as port_pick,
)
from seaweedfs_tpu_torch.volume.server import VolumeServer

PBS = (ref_master_pb, port_master_pb)


def _http(method, url, data=None):
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# -- pure placement over pb snapshots, both packages ------------------------


def _topo(pb, nodes):
    """nodes: {id: {disk_type: (max, [(vid, size, mtime[, collection])])}}"""
    info = pb.TopologyInfo(id="topo")
    dc = info.data_center_infos.add(id="dc1")
    rack = dc.rack_infos.add(id="r1")
    for node_id, disks in nodes.items():
        dn = rack.data_node_infos.add(id=node_id)
        for dt, (maxv, vols) in disks.items():
            disk = dn.disk_infos[dt]
            disk.max_volume_count = maxv
            disk.volume_count = len(vols)
            for vid, size, mtime, *coll in vols:
                disk.volume_infos.add(
                    id=vid, size=size, modified_at_second=mtime,
                    disk_type=dt, collection=coll[0] if coll else "")
    return info


def _both(nodes):
    return [_topo(pb, nodes) for pb in PBS]


def test_collect_tier_change_selects_full_quiet_source_tier():
    now = 1_000_000
    limit = 100
    nodes = {
        "n1:8080": {"ssd": (5, [
            (1, 96, now - 7200),   # full + quiet on ssd -> selected
            (2, 50, now - 7200),   # not full
            (3, 96, now - 10),     # not quiet
        ])},
        "n2:8080": {"": (5, [
            (4, 96, now - 7200),   # hdd, wrong source tier
        ])},
    }
    for collect, topo in zip((ref_collect, port_collect), _both(nodes)):
        assert collect(topo, limit, "ssd", full_percent=95,
                       quiet_for_seconds=3600, now=now) == [1]
        # hdd source: both spellings select the default tier
        for spelling in ("hdd", ""):
            assert collect(topo, limit, spelling, full_percent=95,
                           quiet_for_seconds=3600, now=now) == [4]


def test_pick_tier_move_target_prefers_free_capacity():
    cases = [
        ({"src:8080": {"ssd": (5, [(7, 96, 0)])},
          "small:8080": {"": (2, [(9, 10, 0)])},
          "big:8080": {"": (10, [])},
          "ssdonly:8080": {"ssd": (10, [])}},
         ("src:8080", "big:8080")),
        # no capacity on the target tier -> None
        ({"src:8080": {"ssd": (5, [(7, 96, 0)])},
          "ssdonly:8080": {"ssd": (10, [])}},
         None),
        # a node already holding the volume is never the target
        ({"src:8080": {"ssd": (5, [(7, 96, 0)]), "": (10, [])}},
         None),
    ]
    for nodes, want in cases:
        ref_topo, port_topo = _both(nodes)
        assert ref_pick(ref_topo, 7, "hdd") == want
        assert port_pick(port_topo, 7, "hdd") == want


def _seeded_nodes(seed: int):
    """A random cluster: 3-8 nodes, each with an hdd and/or ssd disk
    (hdd spelled "" as SeaweedFS's heartbeats do), volumes that may sit on
    several nodes (replicas), sizes around the 100-byte limit, mtimes
    around `now`, two collections."""
    rng = np.random.default_rng(seed)
    now = 1_000_000
    nodes = {}
    for i in range(int(rng.integers(3, 9))):
        disks = {}
        for dt in ("", "ssd"):
            if rng.random() < 0.3 and disks:
                continue
            vols = []
            for _ in range(int(rng.integers(0, 6))):
                vid = int(rng.integers(1, 16))
                if any(v[0] == vid for d in disks.values() for v in d[1]) \
                        or any(v[0] == vid for v in vols):
                    continue
                vols.append((vid, int(rng.integers(40, 110)),
                             now - int(rng.integers(0, 7200)),
                             ("", "pics")[int(rng.integers(0, 2))]))
            disks[dt] = (len(vols) + int(rng.integers(0, 4)), vols)
        nodes[f"10.0.0.{i}:8080"] = disks
    return nodes, now


@pytest.mark.parametrize("seed", range(6))
def test_tier_change_selection_equal_on_seeded_topologies(seed):
    nodes, now = _seeded_nodes(seed)
    ref_topo, port_topo = _both(nodes)
    picked_any = False
    for from_dt in ("ssd", "hdd", ""):
        for collection in ("", "pics"):
            for full_percent in (0, 50, 95):
                for quiet in (0, 1800):
                    args = (100, from_dt, collection, full_percent, quiet,
                            now)
                    want = ref_collect(ref_topo, *args)
                    assert port_collect(port_topo, *args) == want, args
                    picked_any |= bool(want)
    assert picked_any


@pytest.mark.parametrize("seed", range(6))
def test_pick_tier_move_target_equal_on_seeded_topologies(seed):
    nodes, _ = _seeded_nodes(seed)
    ref_topo, port_topo = _both(nodes)
    answers = set()
    for vid in range(0, 17):
        for to_dt in ("hdd", "", "ssd"):
            want = ref_pick(ref_topo, vid, to_dt)
            assert port_pick(port_topo, vid, to_dt) == want, (vid, to_dt)
            answers.add(want is None)
    assert answers == {True, False}


# -- live moves through the port's shell ------------------------------------


@pytest.fixture(scope="module")
def tier_cluster(tmp_path_factory):
    master = MasterServer(ip="127.0.0.1", port=free_port(),
                          volume_size_limit_mb=64)
    master.start()
    servers = {}
    for name, dt in (("ssd1", "ssd"), ("ssd2", "ssd"), ("hdd", None)):
        vs = VolumeServer(
            directories=[str(tmp_path_factory.mktemp(f"{name}vol"))],
            disk_types=[dt] if dt else None,
            master_addresses=[f"127.0.0.1:{master.grpc_port}"],
            ip="127.0.0.1", port=free_port(), pulse_seconds=0.5,
            codec_name="cpu",
        )
        vs.start()
        servers[name] = vs
    deadline = time.time() + 15
    while time.time() < deadline and len(master.topo.nodes) < 3:
        time.sleep(0.1)
    assert len(master.topo.nodes) == 3
    yield master, servers
    for vs in servers.values():
        vs.stop()
    master.stop()


def _put(vs, vid: int, fid: str, body: bytes) -> None:
    rpclib.volume_server_stub(f"127.0.0.1:{vs.grpc_port}").AllocateVolume(
        vs_pb.AllocateVolumeRequest(volume_id=vid, collection="",
                                    replication="000", disk_type="ssd"))
    code, _ = _http("POST", f"http://127.0.0.1:{vs.port}/{fid}", body)
    assert code == 201


def _wait_in_topology(master, vs, vid: int, dt: str) -> None:
    """Until the master's snapshot lists `vid` on `vs`'s `dt` disk."""
    node = f"127.0.0.1:{vs.port}"
    deadline = time.time() + 10
    while time.time() < deadline:
        snapshot = master.topo.to_topology_info()
        for dc in snapshot.data_center_infos:
            for r in dc.rack_infos:
                for d in r.data_node_infos:
                    if d.id == node and dt in d.disk_infos and vid in [
                            v.id for v in d.disk_infos[dt].volume_infos]:
                        return
        time.sleep(0.1)
    raise AssertionError(f"volume {vid} not on {node}'s {dt!r} disk")


def _gone_from_topology(master, vid: int, node: str) -> bool:
    snapshot = master.topo.to_topology_info()
    return all(vid not in [v.id for v in disk.volume_infos]
               for dc in snapshot.data_center_infos
               for r in dc.rack_infos for d in r.data_node_infos
               if d.id == node for disk in d.disk_infos.values())


def test_volume_tier_move_dry_run_moves_nothing(tier_cluster):
    master, servers = tier_cluster
    ssd1, hdd = servers["ssd1"], servers["hdd"]
    _put(ssd1, 76, "76,1cafe0001", b"stays on ssd")
    _wait_in_topology(master, ssd1, 76, "ssd")
    grpc_addr = f"127.0.0.1:{master.grpc_port}"
    for line in ("volume.tier.move -volumeId=76 -fromDiskType=ssd "
                 "-toDiskType=hdd",
                 # the selection route: every ssd volume is "full" at 0 %
                 "volume.tier.move -fromDiskType=ssd -toDiskType=hdd "
                 "-fullPercent=0"):
        out = port_shell.run_command(
            port_shell.CommandEnv(master_grpc=grpc_addr), line)
        assert "moving volume 76 from" in out, out
        assert f"to 127.0.0.1:{hdd.port}" in out, out
        assert "(dry run, -force to apply)" in out, out
        assert "moved volume" not in out, out
        # the reference's shell reads the same cluster the same way
        assert ref_shell.run_command(
            ref_shell.CommandEnv(master_grpc=grpc_addr), line) == out
    assert ssd1.store.find_volume(76) is not None
    assert not ssd1.store.find_volume(76).read_only
    assert hdd.store.find_volume(76) is None
    code, body = _http("GET", f"http://127.0.0.1:{ssd1.port}/76,1cafe0001")
    assert (code, body) == (200, b"stays on ssd")


def test_volume_tier_move_ssd_to_hdd(tier_cluster):
    master, servers = tier_cluster
    ssd1, hdd = servers["ssd1"], servers["hdd"]
    fid = "77,1deadbeef"
    _put(ssd1, 77, fid, b"tiered!")
    _wait_in_topology(master, ssd1, 77, "ssd")
    with master.topo.lock:
        assert master.topo.nodes[f"127.0.0.1:{ssd1.port}"] \
            .max_volume_counts.get("ssd")
    src = ssd1.store.find_volume(77)
    src.sync()
    want_sha = _sha(src.file_name() + ".dat")

    env = port_shell.CommandEnv(master_grpc=f"127.0.0.1:{master.grpc_port}")
    out = port_shell.run_command(
        env, "volume.tier.move -volumeId=77 -fromDiskType=ssd "
             "-toDiskType=hdd -force")
    assert f"moved volume 77 -> 127.0.0.1:{hdd.port}" in out, out

    assert ssd1.store.find_volume(77) is None
    moved = hdd.store.find_volume(77)
    assert moved is not None and moved.disk_type == ""
    assert not moved.read_only
    assert _sha(moved.file_name() + ".dat") == want_sha
    code, body = _http("GET", f"http://127.0.0.1:{hdd.port}/{fid}")
    assert (code, body) == (200, b"tiered!")
    _wait_in_topology(master, hdd, 77, "")

    # same-tier move refuses loudly
    with pytest.raises(RuntimeError, match="same as target"):
        port_shell.run_command(
            env, "volume.tier.move -fromDiskType=hdd -toDiskType=hdd")


def test_volume_tier_move_drops_every_replica(tier_cluster):
    """Both ssd replicas are marked read-only, one is copied to the hdd
    node, and both are deleted: the volume ends on the hdd node alone."""
    master, servers = tier_cluster
    ssd1, ssd2, hdd = servers["ssd1"], servers["ssd2"], servers["hdd"]
    fid = "78,2feedface"
    for vs in (ssd1, ssd2):
        _put(vs, 78, fid, b"two replicas")
        _wait_in_topology(master, vs, 78, "ssd")
    env = port_shell.CommandEnv(master_grpc=f"127.0.0.1:{master.grpc_port}")
    out = port_shell.run_command(
        env, "volume.tier.move -volumeId=78 -fromDiskType=ssd "
             "-toDiskType=hdd -force")
    assert f"moved volume 78 -> 127.0.0.1:{hdd.port}" in out, out
    assert ssd1.store.find_volume(78) is None
    assert ssd2.store.find_volume(78) is None
    assert hdd.store.find_volume(78) is not None
    code, body = _http("GET", f"http://127.0.0.1:{hdd.port}/{fid}")
    assert (code, body) == (200, b"two replicas")
    deadline = time.time() + 10
    while time.time() < deadline and not all(
            _gone_from_topology(master, 78, f"127.0.0.1:{vs.port}")
            for vs in (ssd1, ssd2)):
        time.sleep(0.1)
    for vs in (ssd1, ssd2):
        assert _gone_from_topology(master, 78, f"127.0.0.1:{vs.port}")
