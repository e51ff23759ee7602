"""The admin shell's flows on a port cluster held against the same flows
on a reference cluster.  Each cluster is a master and three volume
servers, A (rack1), B and C (rack0), started in that order, on the `cpu`
codec; A holds the same seeded volumes, written with the reference's
writer.  `ec.encode`, `ec.rebuild` and `ec.decode` run through each
package's own shell: shard files must be byte-equal by shard id, the
spreads equal by node name, the rebuilt shards and the decoded .dat equal
by sha256.  A reference shell drives the port cluster too (with
`-codec=torch_cpu`, which the port's servers honour).  Then the
reference's tests/test_cluster.py flows run on the port cluster.
"""

import hashlib
import json
import os
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from helpers import free_port, make_volume
from torch_threads import one_torch_thread  # noqa: F401

from seaweedfs_tpu.master.server import MasterServer as RefMaster
from seaweedfs_tpu.shell import commands as ref_shell
from seaweedfs_tpu.volume.server import VolumeServer as RefVS
from seaweedfs_tpu_torch.master.server import MasterServer as PortMaster
from seaweedfs_tpu_torch.shell import commands as port_shell
from seaweedfs_tpu_torch.volume.server import VolumeServer as PortVS

DEADLINE_S = 30.0
NODES = (("a", "rack1"), ("b", "rack0"), ("c", "rack0"))


def _http(method: str, url: str, data: bytes | None = None):
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait(cond, what: str, timeout: float = DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"{what}: not within {timeout} s")


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class _Cluster:
    def __init__(self, pkg: str, root, source_dir: str):
        Master, VS, self.shell = ((RefMaster, RefVS, ref_shell) if pkg == "ref"
                                  else (PortMaster, PortVS, port_shell))
        self.pkg = pkg
        self.master = Master(ip="127.0.0.1", port=free_port(),
                             volume_size_limit_mb=64)
        # the subject is the shell's ec.rebuild: both masters' dead-node
        # mass repair (on by default) stays off so it cannot race it
        self.master.mass_repair.enabled = False
        self.master.start()
        self.servers, self.dirs, self.names = {}, {}, {}
        for name, rack in NODES:
            d = os.path.join(root, f"{pkg}_{name}")
            if name == "a":
                shutil.copytree(source_dir, d)
            else:
                os.makedirs(d)
            s = VS([d], [f"127.0.0.1:{self.master.grpc_port}"],
                   ip="127.0.0.1", port=free_port(), pulse_seconds=0.5,
                   rack=rack, max_volume_count=40, codec_name="cpu")
            s.start()
            url = f"127.0.0.1:{s.port}"
            # registered before the next starts: the topology lists A, B, C
            _wait(lambda u=url: u in self.master.topo.nodes, f"{url} joined")
            self.servers[name], self.dirs[name], self.names[url] = s, d, name
        _wait(lambda: all(v in self.master.topo.nodes[
            f"127.0.0.1:{self.servers['a'].port}"].volumes for v in (1, 2)),
            "A's volumes at the master")
        self.env = self.shell.CommandEnv(f"127.0.0.1:{self.master.grpc_port}")

    def run(self, line: str, env=None) -> str:
        return self.shell.run_command(env or self.env, line)

    def named(self, text: str) -> str:
        for url, name in self.names.items():
            text = text.replace(url, name)
        return text

    def spread(self, vid: int) -> dict:
        """node name -> shard ids, from the master's shard map."""
        out: dict = {}
        for sid, nodes in self.master.topo.lookup_ec_shards(vid).items():
            for n in nodes:
                out.setdefault(self.names[n.id], []).append(sid)
        return {k: sorted(v) for k, v in sorted(out.items())}

    def wait_shards(self, vid: int, count: int = 14, without: str = ""):
        def ok():
            sm = self.master.topo.lookup_ec_shards(vid)
            return len(sm) == count and not any(
                self.names[n.id] == without for ns in sm.values() for n in ns)
        _wait(ok, f"{count} shards of volume {vid} at the master")

    def shard_digests(self, vid: int) -> dict:
        """shard id -> sha256 of its file, wherever it lives."""
        out = {}
        for name, d in self.dirs.items():
            for sid in range(14):
                p = os.path.join(d, f"{vid}.ec{sid:02d}")
                if os.path.exists(p):
                    out.setdefault(sid, set()).add(_sha(p))
        return out

    def stop(self):
        for s in self.servers.values():
            s.stop()
        self.master.stop()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """-> (ref cluster, port cluster, the source volumes' digests)."""
    root = tmp_path_factory.mktemp("shell")
    src = os.path.join(root, "source")
    os.makedirs(src)
    for vid, seed in ((1, 11), (2, 12)):
        make_volume(src, volume_id=vid, n_needles=120, seed=seed,
                    max_size=60_000).close()
    digests = {vid: _sha(os.path.join(src, f"{vid}.dat")) for vid in (1, 2)}
    ref = _Cluster("ref", root, src)
    port = _Cluster("port", root, src)
    yield ref, port, digests, src
    ref.stop()
    port.stop()


def _needles(src: str, vid: int) -> dict:
    """key -> (cookie, data) of the source volume, by the reference's
    own reader."""
    from seaweedfs_tpu.storage.volume import Volume

    idx = np.fromfile(os.path.join(src, f"{vid}.idx"),
                      dtype=[("k", ">u8"), ("o", ">u4"), ("s", ">u4")])
    v = Volume(src, "", vid)
    try:
        return {int(k): (v.read_needle(int(k)).cookie,
                         v.read_needle(int(k)).data) for k in idx["k"]}
    finally:
        v.close()


def test_ec_encode_spreads_alike_with_byte_equal_shards(clusters):
    ref, port, _d, _src = clusters
    outs = {}
    for c in (ref, port):
        outs[c.pkg] = c.named(c.run("ec.encode -volumeId=1"))
        c.wait_shards(1)
    assert outs["port"] == outs["ref"]
    assert port.spread(1) == ref.spread(1)
    assert len(port.spread(1)) >= 2
    pd, rd = port.shard_digests(1), ref.shard_digests(1)
    assert sorted(pd) == list(range(14))
    assert pd == rd
    assert all(len(v) == 1 for v in pd.values())
    # the source volume is gone from every server, in both
    for c in (ref, port):
        assert not any(os.path.exists(os.path.join(d, "1.dat"))
                       for d in c.dirs.values())
    # .ecx on every holder equal to the reference's
    for name in port.spread(1):
        assert _sha(os.path.join(port.dirs[name], "1.ecx")) \
            == _sha(os.path.join(ref.dirs[name], "1.ecx"))


def test_needles_read_from_the_spread_shards(clusters):
    _ref, port, _d, src = clusters
    want = _needles(src, 1)
    assert want
    holder = next(s for s in port.servers.values()
                  if s.store.find_ec_volume(1) is not None)
    for key, (cookie, data) in list(want.items())[:12]:
        code, got = _http("GET", f"http://127.0.0.1:{holder.port}/"
                                 f"1,{key:x}{cookie:08x}")
        assert code == 200 and got == data


def test_ec_rebuild_restores_the_same_shards(clusters):
    """Up to 4 shards of the holder with the fewest lost in both
    clusters; `ec.rebuild -force` brings back files equal by sha256 to
    the originals, on the same node in both."""
    ref, port, _d, _src = clusters
    before = port.shard_digests(1)
    spread = port.spread(1)
    victim = min(spread, key=lambda n: (len(spread[n]), n))
    lost = spread[victim][:4]
    outs = {}
    for c in (ref, port):
        c.servers[victim].store.delete_ec_shards(1, "", lost)
        _wait(lambda c=c: len(c.master.topo.lookup_ec_shards(1)) == 14
              - len(lost), "the loss at the master")
        outs[c.pkg] = c.named(c.run("ec.rebuild -force"))
        c.wait_shards(1)
    assert outs["port"] == outs["ref"]
    assert "rebuilt" in outs["port"]
    assert port.spread(1) == ref.spread(1)
    assert port.shard_digests(1) == ref.shard_digests(1) == before


def test_ec_decode_restores_the_original_dat(clusters):
    ref, port, digests, _src = clusters
    outs = {}
    for c in (ref, port):
        outs[c.pkg] = c.named(c.run("ec.decode -volumeId=1"))
        _wait(lambda c=c: not c.master.topo.lookup_ec_shards(1),
              "the EC shards dropped")
    assert outs["port"] == outs["ref"]
    name = outs["port"].split("restored on ")[1].strip()
    for c in (ref, port):
        assert _sha(os.path.join(c.dirs[name], "1.dat")) == digests[1]


def test_reference_shell_drives_the_port_cluster(clusters):
    """A reference CommandEnv aimed at the port's master: ec.encode with
    `-codec=torch_cpu` (the port's servers honour the rpc's codec); the
    shards equal the reference cluster's own encode of the same volume."""
    ref, port, _d, _src = clusters
    ref_env_on_port = ref_shell.CommandEnv(
        f"127.0.0.1:{port.master.grpc_port}")
    out_port = port.named(ref_shell.run_command(
        ref_env_on_port, "ec.encode -volumeId=2 -codec=torch_cpu"))
    out_ref = ref.named(ref.run("ec.encode -volumeId=2"))
    for c in (ref, port):
        c.wait_shards(2)
    assert out_port == out_ref
    assert port.spread(2) == ref.spread(2)
    assert port.shard_digests(2) == ref.shard_digests(2)
    listing = port.named(ref_shell.run_command(ref_env_on_port,
                                               "volume.list"))
    assert "ec2" in listing and "rack0" in listing and "rack1" in listing


def test_volume_list_reads_alike(clusters):
    ref, port, _d, _src = clusters
    # the encodes' deletes of the source volumes reach both masters
    _wait(lambda: not any(2 in n.volumes for c in (ref, port)
                          for n in c.master.topo.nodes.values()),
          "volume 2 gone from both topologies")
    assert port.named(port.run("volume.list")) \
        == ref.named(ref.run("volume.list"))


def test_write_read_delete_through_assign(clusters):
    """tests/test_cluster.py::test_write_read_delete on the port."""
    _ref, port, _d, _src = clusters
    m = port.master
    code, body = _http("GET", f"http://127.0.0.1:{m.port}/dir/assign"
                              "?collection=rw")
    assert code == 200, body
    a = json.loads(body)
    payload = b"hello tpu blob store" * 50
    assert _http("POST", f"http://{a['url']}/{a['fid']}", payload)[0] == 201
    assert _http("GET", f"http://{a['publicUrl']}/{a['fid']}") \
        == (200, payload)
    vid = a["fid"].split(",")[0]
    code, body = _http("GET", f"http://127.0.0.1:{m.port}/dir/lookup"
                              f"?volumeId={vid}")
    assert code == 200 and json.loads(body)["locations"]
    assert _http("DELETE", f"http://{a['url']}/{a['fid']}")[0] == 202
    assert _http("GET", f"http://{a['url']}/{a['fid']}")[0] == 404


def test_replicated_write(clusters):
    """tests/test_cluster.py::test_replicated_write on the port: 001
    lands on B and C, the two nodes of rack0."""
    _ref, port, _d, _src = clusters
    m = port.master
    code, body = _http("GET", f"http://127.0.0.1:{m.port}/dir/assign"
                              "?replication=001&collection=rep")
    a = json.loads(body)
    payload = b"replicated payload"
    assert _http("POST", f"http://{a['url']}/{a['fid']}", payload)[0] == 201
    vid = int(a["fid"].split(",")[0])
    holders = [n for n, s in port.servers.items()
               if s.store.find_volume(vid) is not None]
    assert holders == ["b", "c"]
    for n in holders:
        assert _http("GET", f"http://127.0.0.1:{port.servers[n].port}/"
                            f"{a['fid']}") == (200, payload)


def test_ec_delete_fanout(clusters):
    """tests/test_cluster.py::test_ec_delete_fanout on the port: a DELETE
    at one holder of an EC needle answers 404 from every holder."""
    _ref, port, _d, _src = clusters
    m = port.master
    fids = []
    for i in range(8):
        code, body = _http("GET", f"http://127.0.0.1:{m.port}/dir/assign"
                                  "?collection=ecdel")
        a = json.loads(body)
        payload = (f"ecdel-{i}-".encode() * 100)[:900]
        assert _http("POST", f"http://{a['url']}/{a['fid']}", payload)[0] \
            == 201
        fids.append(a["fid"])
    vid = int(fids[0].split(",")[0])
    # the heartbeats carry the writes' sizes before the encode reads them
    _wait(lambda: any(vid in n.volumes and n.volumes[vid].file_count
                      for n in m.topo.nodes.values()), "the writes at the "
          "master")
    out = port.run(f"ec.encode -volumeId={vid} -collection=ecdel")
    assert f"ec.encode {vid}" in out
    port.wait_shards(vid)
    holders = [s for s in port.servers.values()
               if s.store.find_ec_volume(vid)]
    if len(holders) == 1:
        # the spread follows free slots, which the random growth of the
        # module's earlier writes left uneven: this test is about the
        # delete fan-out, so give a second node 7 of the shards with the
        # rpcs the balancer uses (as the reference's test does)
        from seaweedfs_tpu_torch.pb import rpc as rpclib
        from seaweedfs_tpu_torch.pb import volume_server_pb2 as vspb

        src = holders[0]
        dst = next(s for s in port.servers.values() if s is not src)
        sids = src.store.find_ec_volume(vid).shard_ids()[:7]
        stub = rpclib.volume_server_stub(f"127.0.0.1:{dst.grpc_port}",
                                         timeout=60)
        stub.VolumeEcShardsCopy(vspb.VolumeEcShardsCopyRequest(
            volume_id=vid, collection="ecdel", shard_ids=sids,
            copy_ecx_file=True, copy_ecj_file=True, copy_vif_file=True,
            copy_from_data_node=f"127.0.0.1:{src.grpc_port}"))
        stub.VolumeEcShardsMount(vspb.VolumeEcShardsMountRequest(
            volume_id=vid, collection="ecdel", shard_ids=sids))
        holders.append(dst)
    # the fan-out reaches the holders the master knows of
    _wait(lambda: {n.id for ns in m.topo.lookup_ec_shards(vid).values()
                   for n in ns} >= {f"127.0.0.1:{s.port}" for s in holders},
          "every holder at the master")
    assert _http("DELETE", f"http://127.0.0.1:{holders[0].port}/"
                           f"{fids[0]}")[0] == 202
    for s in holders:
        assert _http("GET", f"http://127.0.0.1:{s.port}/{fids[0]}")[0] == 404
    assert _http("GET", f"http://127.0.0.1:{holders[0].port}/"
                        f"{fids[1]}")[0] == 200


def test_unknown_and_left_out_commands_raise(clusters):
    _ref, port, _d, _src = clusters
    with pytest.raises(ValueError, match="unknown command 'nope'"):
        port.run("nope")
    for line, item in (("cluster.geo", "A-7"),
                       ("filer.ring", "A-7"),
                       ("fs.ls /", "A-7"),
                       ("collection.list", "A-7")):
        with pytest.raises(ValueError, match=f"not ported yet.*{item}"):
            port.run(line)
    # the cluster plane's commands are the port's own
    for name in ("cluster.status", "cluster.alerts", "cluster.hot",
                 "cluster.debug"):
        assert name in port_shell.COMMANDS
    # the remote tier's and disk-type moves' commands are the port's own
    for name in ("volume.tier.upload", "volume.tier.download",
                 "volume.tier.move"):
        assert name in port_shell.COMMANDS
    assert port.run("") == ""
    assert port.run("lock") == "locked"
    assert port.run("unlock") == "unlocked"


@pytest.mark.parametrize("line", ["cluster.status", "cluster.alerts",
                                  "cluster.hot", "cluster.debug"])
def test_cluster_commands_read_alike(clusters, line):
    """The cluster plane's commands print the same report from both
    clusters: every address replaced by its node's name, every number
    and hex key by a placeholder (ages, counts and keys differ between
    two clusters by construction), lines compared as a set (nodes are
    listed in address order); for cluster.hot its header and the names
    of its dimensions (which window still holds a dimension's traffic
    depends on when each cluster's window turned); of the SLO states
    only each SLO's name and severity (the engines judge gauges of
    each package's process-wide registry, which the module's other
    tests move)."""
    import re

    ref, port, _d, _src = clusters
    out = {}
    for c in (ref, port):
        text = c.named(c.run(line)).replace(
            f"127.0.0.1:{c.master.port}", "master")
        lines = re.sub(r"\d+(\.\d+)?", "N", re.sub(
            r"\b[0-9a-f]{8,}\b", "H", text)).splitlines()
        if line == "cluster.hot":
            lines = [lines[0]] + [x.split(":")[0].split(" (")[0]
                                  for x in lines[1:]
                                  if x.startswith("  ")
                                  and not x.startswith("    ")]
        if line == "cluster.alerts":
            states = lines[1:lines.index(next(
                x for x in lines[1:] if not x.startswith("  ")))]
            lines = [lines[0]] + [x.split("]")[0] + "]" for x in states] \
                + [x for x in lines if x.startswith("canary:")]
        if line == "cluster.status":
            lines = [x.split(":")[0] if x.startswith("health:") else x
                     for x in lines]
        out[c.pkg] = sorted(lines)
    assert out["port"] == out["ref"]
    if line == "cluster.status":
        assert "health" in out["port"]
        assert any(x.startswith("canary: ") for x in out["port"])


def test_volume_lifecycle_installs_a_tier_policy(clusters):
    """`volume.lifecycle -policy=` with a tier backend: both masters take
    it and report the same policy document; the default comes back the
    same way."""
    ref, port, _d, _src = clusters
    doc = ('{"tier":{"ec_cooldown_seconds":60,"tier_backend":"s3.cold",'
           '"tier_idle_seconds":30}}')
    try:
        outs = {c.pkg: c.run(f"volume.lifecycle -policy='{doc}'")
                for c in (ref, port)}
        assert outs["port"] == outs["ref"]
        pol = port.master.lifecycle.policies.for_collection("tier")
        assert (pol.tier_backend, pol.tier_idle_seconds) == ("s3.cold", 30)
    finally:
        for c in (ref, port):
            c.run("volume.lifecycle -policy={}")
    assert port.master.lifecycle.policies.for_collection("tier") \
        .tier_backend == ""


def test_maintenance_script_is_the_reference_default():
    assert port_shell.DEFAULT_MAINTENANCE_SCRIPT \
        == ref_shell.DEFAULT_MAINTENANCE_SCRIPT
    # every command of it is registered in the port's shell
    for line in port_shell.DEFAULT_MAINTENANCE_SCRIPT:
        assert line.split()[0] in port_shell.COMMANDS


def test_maintenance_loop_encodes_automatically(tmp_path):
    """tests/test_cluster.py::test_maintenance_loop_encodes_automatically
    on the port: the master's own loop runs the port's shell and encodes
    a volume past 50 % of a 1 MB limit, with no operator action."""
    master = PortMaster(ip="127.0.0.1", port=free_port(),
                        volume_size_limit_mb=1, maintenance_interval=0.5,
                        maintenance_script=[
                            "ec.encode -fullPercent=50 -quietFor=0"])
    master.start()
    vs_ = PortVS([str(tmp_path)], [f"127.0.0.1:{master.grpc_port}"],
                 ip="127.0.0.1", port=free_port(), pulse_seconds=0.5,
                 max_volume_count=40, codec_name="cpu")
    vs_.start()
    try:
        _wait(lambda: master.topo.nodes, "the node joined")
        code, body = _http("GET", f"http://127.0.0.1:{master.port}"
                                  "/dir/assign?collection=auto")
        a = json.loads(body)
        vid = int(a["fid"].split(",")[0])
        payload = b"m" * (700 << 10)
        assert _http("POST", f"http://{a['url']}/{a['fid']}", payload)[0] \
            == 201
        _wait(lambda: len(master.topo.lookup_ec_shards(vid)) == 14,
              "the maintenance loop's encode", timeout=60)
        assert _http("GET", f"http://{a['url']}/{a['fid']}") \
            == (200, payload)
    finally:
        vs_.stop()
        master.stop()
