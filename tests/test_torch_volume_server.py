"""The port's volume server, gRPC side (seaweedfs_tpu_torch/volume/) against
the reference's, on the same volume and the same requests.

Each flow is a small cluster: a master servicer (chip_smoke.MiniMaster,
built from the port's rpc declarations, which the reference's servers
speak to over the same wire), a volume server S holding a sealed volume
and a peer B of the same package.  The flow drives S the way the shell
and the master do — generate, mount, interval reads, degraded needle
reads, rebuild, partial-sum repair through B, scrub, decode — and records
every response's serialized bytes and every shard file's sha256.  A port
server on `cpu` and one on `torch_cpu` must record exactly what a
reference VolumeServer records.  Each port server is driven through the
reference's stub and the reference server through the port's, so both
stubs meet both servers.  A reference MasterServer hears a port server's
heartbeat and names its shards; the tier moves answer a missing volume
as the reference's do; a `cuda` server refuses to start without a card.
Servers bind test-band ports and are stopped in the fixtures; waits are on
gates (the master's condition, an Event set by the reference master's
topology), never on sleeps.
"""

import hashlib
import os
import shutil
import sys
import threading

import grpc
import pytest

from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vs
from seaweedfs_tpu.volume.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs
from seaweedfs_tpu_torch.stats.metrics import EC_PARTIAL_BYTES
from seaweedfs_tpu_torch.volume.server import VolumeServer

from helpers import free_port, make_volume
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

N_NEEDLES = 40
MOVED = [0, 1, 2, 3, 4]  # to the peer, for the partial-sum repair
GONE = [10, 11, 12, 13]  # lost everywhere, rebuilt from partials
LOST = [0, 1, 2, 3]  # dropped for degraded reads, then rebuilt
INTERVALS = [(0, 0, 100), (3, 5000, 7000), (9, 0, 1 << 20),
             (13, 1234, 999), (6, (1 << 20) - 10, 10)]
FLIP = (11, 300_000)  # shard, byte: one 256 KiB scrub interval


@pytest.fixture(scope="module")
def sealed(tmp_path_factory):
    """One reference volume (vid 1), copied byte for byte into each flow."""
    d = tmp_path_factory.mktemp("sealed")
    vol = make_volume(str(d), n_needles=N_NEEDLES, seed=21, max_size=40_000)
    vol.close()
    return str(d)


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _shards(base: str, sids) -> dict:
    return {s: _sha(base + f".ec{s:02d}") for s in sids}


class _Cluster:
    """MiniMaster + server S over a copy of the sealed volume + peer B."""

    def __init__(self, kind: str, sealed: str, tmp):
        self.kind = kind
        self.master = chip_smoke.MiniMaster(rpc, master_pb2,
                                            free_port() + 10000)
        self.dirs = [str(tmp / "s"), str(tmp / "b")]
        for d in self.dirs:
            os.makedirs(d)
        for ext in (".dat", ".idx"):
            shutil.copy(os.path.join(sealed, "1" + ext), self.dirs[0])
        self.servers = []
        try:
            for d in self.dirs:
                if kind == "reference":
                    srv = RefVolumeServer([d], [self.master.address],
                                          ip="127.0.0.1", port=free_port(),
                                          pulse_seconds=1.0)
                else:
                    srv = VolumeServer([d], [self.master.address],
                                       ip="127.0.0.1", port=free_port(),
                                       codec_name=kind, pulse_seconds=1.0)
                srv.start()
                self.servers.append(srv)
        except BaseException:
            self.stop()
            raise
        # each package's servers are driven through the OTHER's stub
        self.pb, make_stub = ((vs, rpc.volume_server_stub)
                              if kind == "reference" else
                              (ref_vs, ref_rpc.volume_server_stub))
        self.stub = make_stub(self.grpc(0), timeout=120)
        self.peer_stub = make_stub(self.grpc(1), timeout=120)

    def grpc(self, i: int) -> str:
        return f"127.0.0.1:{self.servers[i].grpc_port}"

    def url(self, i: int) -> str:
        return f"127.0.0.1:{self.servers[i].port}"

    def stop(self) -> None:
        for srv in self.servers:
            srv.stop()
        self.master.stop()


def _flow(c: _Cluster) -> dict:
    """The operator's EC lifecycle on S, over the wire; -> what each step
    answered (serialized responses) and wrote (sha256 of files)."""
    pb, stub, peer = c.pb, c.stub, c.peer_stub
    base = os.path.join(c.dirs[0], "1")
    dat_sha = _sha(base + ".dat")
    obs = {}

    def ok(resp) -> str:
        return resp.SerializeToString().hex()

    stub.VolumeMarkReadonly(pb.VolumeMarkReadonlyRequest(volume_id=1))
    obs["generate"] = ok(stub.VolumeEcShardsGenerate(
        pb.VolumeEcShardsGenerateRequest(volume_id=1)))
    obs["generated"] = {**_shards(base, range(14)),
                        "ecx": _sha(base + ".ecx")}
    stub.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
        volume_id=1, shard_ids=list(range(14))))
    c.master.wait_for(lambda m: m.bits(c.url(0), 1) == 0x3FFF,
                      "S's 14 shards")
    stub.VolumeDelete(pb.VolumeDeleteRequest(volume_id=1))
    obs["reads"] = [
        b"".join(r.SerializeToString() for r in stub.VolumeEcShardRead(
            pb.VolumeEcShardReadRequest(volume_id=1, shard_id=sid,
                                        offset=off, size=n))).hex()
        for sid, off, n in INTERVALS]

    # degraded: needles read whole while 4 shards are gone
    stub.VolumeEcShardsUnmount(pb.VolumeEcShardsUnmountRequest(
        volume_id=1, shard_ids=LOST))
    stub.VolumeEcShardsDelete(pb.VolumeEcShardsDeleteRequest(
        volume_id=1, shard_ids=LOST))
    obs["needles"] = [ok(stub.VolumeNeedleStatus(
        pb.VolumeNeedleStatusRequest(volume_id=1, needle_id=i)))
        for i in range(1, N_NEEDLES + 1)]
    obs["rebuild"] = ok(stub.VolumeEcShardsRebuild(
        pb.VolumeEcShardsRebuildRequest(volume_id=1)))
    obs["rebuilt"] = _shards(base, LOST)
    stub.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
        volume_id=1, shard_ids=LOST))

    # partial-sum repair: 5 shards on B, 4 lost everywhere
    peer.VolumeEcShardsCopy(pb.VolumeEcShardsCopyRequest(
        volume_id=1, shard_ids=MOVED, copy_ecx_file=True, copy_vif_file=True,
        copy_from_data_node=c.grpc(0)))
    peer.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
        volume_id=1, shard_ids=MOVED))
    stub.VolumeEcShardsUnmount(pb.VolumeEcShardsUnmountRequest(
        volume_id=1, shard_ids=MOVED + GONE))
    stub.VolumeEcShardsDelete(pb.VolumeEcShardsDeleteRequest(
        volume_id=1, shard_ids=MOVED + GONE))
    c.master.wait_for(
        lambda m: m.bits(c.url(1), 1) == sum(1 << s for s in MOVED)
        and m.bits(c.url(0), 1) == sum(1 << s for s in range(5, 10)),
        "shards 0-4 on B, 5-9 on S")
    if c.kind == "reference":
        # the reference's rebuild probes sources through a fetcher whose
        # holder map the degraded reads above negative-cached (for 11 s)
        # and fails "only 5 of 14 shards reachable"; drop it as a
        # dead-node notice would.  The port's rebuild drops it itself.
        c.servers[0].invalidate_location_caches()
    recv = EC_PARTIAL_BYTES.labels("recv").value
    obs["partial"] = ok(stub.VolumeEcShardsRebuild(
        pb.VolumeEcShardsRebuildRequest(volume_id=1)))
    obs["partial_recv"] = EC_PARTIAL_BYTES.labels("recv").value - recv
    obs["partially_rebuilt"] = _shards(base, GONE)
    stub.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
        volume_id=1, shard_ids=GONE))
    stub.VolumeEcShardsCopy(pb.VolumeEcShardsCopyRequest(
        volume_id=1, shard_ids=MOVED, copy_from_data_node=c.grpc(1)))
    peer.VolumeEcShardsDelete(pb.VolumeEcShardsDeleteRequest(
        volume_id=1, shard_ids=MOVED))
    stub.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
        volume_id=1, shard_ids=MOVED))

    # scrub: clean, then one flipped byte
    scrub = pb.VolumeScrubRequest(volume_id=1, rate_mbps=1000)
    obs["scrub_clean"] = ok(stub.VolumeScrub(scrub))
    sid, pos = FLIP
    with open(base + f".ec{sid:02d}", "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0xFF]))
    try:
        obs["scrub_flipped"] = ok(stub.VolumeScrub(scrub))
    finally:
        with open(base + f".ec{sid:02d}", "r+b") as f:
            f.seek(pos)
            f.write(byte)

    obs["to_volume"] = ok(stub.VolumeEcShardsToVolume(
        pb.VolumeEcShardsToVolumeRequest(volume_id=1)))
    obs["dat_equal"] = _sha(base + ".dat") == dat_sha
    obs["idx"] = _sha(base + ".idx")
    return obs


@pytest.fixture(scope="module")
def reference_flow(sealed, tmp_path_factory):
    c = _Cluster("reference", sealed, tmp_path_factory.mktemp("ref_flow"))
    try:
        return _flow(c)
    finally:
        c.stop()


@pytest.mark.parametrize("codec", ["cpu", "torch_cpu"])
def test_ec_rpcs_answer_as_the_reference(codec, sealed, reference_flow,
                                         tmp_path):
    c = _Cluster(codec, sealed, tmp_path)
    try:
        got = _flow(c)
    finally:
        c.stop()
    assert got["dat_equal"] and reference_flow["dat_equal"]
    shard_size = os.path.getsize(os.path.join(c.dirs[0], "1.ec00"))
    # 4 rows of partial sums in, not B's 5 raw shards
    assert got["partial_recv"] == len(GONE) * shard_size
    for key, want in reference_flow.items():
        if key != "partial_recv":
            assert got[key] == want, key


def test_tier_rpcs_answer_a_missing_volume_as_the_reference(tmp_path):
    """Every volume-server rpc has its handler: the tier moves answer
    NOT_FOUND for a volume the server lacks, as the reference's do."""
    master = chip_smoke.MiniMaster(rpc, master_pb2, free_port() + 10000)
    srv = VolumeServer([str(tmp_path)], [master.address], ip="127.0.0.1",
                       port=free_port(), codec_name="cpu")
    srv.start()
    try:
        stub = rpc.volume_server_stub(f"127.0.0.1:{srv.grpc_port}",
                                      timeout=30)
        for name, req in (
                ("VolumeTierMoveDatToRemote",
                 vs.VolumeTierMoveDatToRemoteRequest(volume_id=1)),
                ("VolumeTierMoveDatFromRemote",
                 vs.VolumeTierMoveDatFromRemoteRequest(volume_id=1))):
            with pytest.raises(grpc.RpcError) as e:
                list(getattr(stub, name)(req))
            assert e.value.code() == grpc.StatusCode.NOT_FOUND, name
        # Query is ported: a malformed fid is an error of its own, not
        # UNIMPLEMENTED (tests/test_torch_query.py holds its answers)
        with pytest.raises(grpc.RpcError) as e:
            list(stub.Query(vs.QueryRequest(from_file_ids=["1,01"])))
        assert e.value.code() != grpc.StatusCode.UNIMPLEMENTED
        # and an implemented one answers
        assert stub.VolumeServerStatus(
            vs.VolumeServerStatusRequest()).disk_statuses[0].dir == str(
                tmp_path)
    finally:
        srv.stop()
        master.stop()
    # stop() joined the heartbeat and dropped the channel to the server
    assert not srv._hb_thread.is_alive()
    assert f"127.0.0.1:{srv.grpc_port}" not in rpc._channels


def test_cuda_server_refuses_to_start_without_a_card(tmp_path):
    with pytest.raises(Exception, match="(?i)cuda|card|device"):
        VolumeServer([str(tmp_path)], ["127.0.0.1:1"], port=free_port())


def test_reference_master_hears_the_port_server(sealed, tmp_path,
                                                monkeypatch):
    """A port server heartbeats into a reference MasterServer: after its
    mount, the master's LookupEcVolume (asked through the port's stub)
    names the port server for all 14 shards."""
    from seaweedfs_tpu.master.server import MasterServer

    master = MasterServer(ip="127.0.0.1", port=free_port(),
                          pulse_seconds=1.0)
    heard = threading.Event()
    for name in ("apply_incremental", "sync_ec_shards"):
        real = getattr(master.topo, name)

        def gate(*a, _real=real, **kw):
            out = _real(*a, **kw)
            heard.set()
            return out

        monkeypatch.setattr(master.topo, name, gate)
    master.start()
    for ext in (".dat", ".idx"):
        shutil.copy(os.path.join(sealed, "1" + ext), tmp_path)
    srv = VolumeServer([str(tmp_path)], [f"127.0.0.1:{master.grpc_port}"],
                       ip="127.0.0.1", port=free_port(), codec_name="cpu",
                       pulse_seconds=1.0)
    srv.start()
    try:
        stub = rpc.volume_server_stub(f"127.0.0.1:{srv.grpc_port}",
                                      timeout=60)
        stub.VolumeEcShardsGenerate(vs.VolumeEcShardsGenerateRequest(
            volume_id=1))
        stub.VolumeEcShardsMount(vs.VolumeEcShardsMountRequest(
            volume_id=1, shard_ids=list(range(14))))
        me = f"127.0.0.1:{srv.port}"
        ask = rpc.master_stub(f"127.0.0.1:{master.grpc_port}", timeout=10)

        def named() -> bool:
            try:
                resp = ask.LookupEcVolume(
                    master_pb2.LookupEcVolumeRequest(volume_id=1))
            except grpc.RpcError:
                return False
            return sorted(e.shard_id for e in resp.shard_id_locations
                          if [loc.url for loc in e.locations] == [me]) \
                == list(range(14))

        while not named():
            assert heard.wait(30), "the master heard no EC shards"
            heard.clear()
    finally:
        srv.stop()
        master.stop()
