"""The port's maintenance plane over a small in-process cluster: a port
master with a lifecycle loop and four port volume servers on `torch_cpu`
(A and B in rack0, C and D in rack1), each holding two volumes of real
needles written by the reference's writer before it starts.

  * the controller seals every volume and EC-encodes it on the servers'
    codec, with no shell command, and drops each source .dat;
  * D stopped: the master's mass repair brings every volume back to 14
    mounted shards with no command, the rebuilt shards equal D's by
    sha256, and GETs through the master's lookup while the repair runs
    return every needle equal to its record;
  * a master restarted mid-batch (its first rpcs done, the rest still
    journaled) resumes from its lifecycle_dir and finishes each volume
    exactly once.

The master runs 8 lifecycle workers (SEAWEEDFS_TPU_LIFECYCLE_WORKERS) and
its controller 2 jobs per node (`per_node`, 1 in a master's default
build), and every .dat's write time
is set to the master's start, so all 8 volumes cool down together
(`ec_cooldown_seconds` 4, against a 1 s cycle and 0.5 s pulses: every node
registered and every seal seen first) and their 8 encodes plan their
spreads from one topology snapshot: 4/4/3/3 shards per volume, every node
holding at most 4, so any one node's death is a repair and not a loss.
Waits poll the master's own state; no step sleeps for a fixed time.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from helpers import free_port, make_volume

from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.volume.server import VolumeServer
from torch_threads import one_torch_thread  # noqa: F401

NODES = (("a", "rack0"), ("b", "rack0"), ("c", "rack1"), ("d", "rack1"))
DEADLINE_S = 60.0
PLANE_ENV = {"SEAWEEDFS_TPU_LIFECYCLE_WORKERS": "8"}


def _wait(cond, what: str, timeout: float = DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"{what}: not within {timeout} s")


def _http(url: str):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _needles(directory: str, vid: int) -> dict:
    """key -> (cookie, data) of a volume, by the reference's reader."""
    from seaweedfs_tpu.storage.volume import Volume

    idx = np.fromfile(os.path.join(directory, f"{vid}.idx"),
                      dtype=[("k", ">u8"), ("o", ">u4"), ("s", ">u4")])
    v = Volume(directory, "", vid)
    try:
        out = {}
        for k in idx["k"]:
            n = v.read_needle(int(k))
            out[int(k)] = (n.cookie, n.data)
        return out
    finally:
        v.close()


class _Cluster:
    """A port master and 4 port volume servers in this process."""

    def __init__(self, root: str, lifecycle_dir: str = ""):
        self.root = root
        self.lifecycle_dir = lifecycle_dir
        self.master_port = free_port()
        self.dirs, self.servers, self.names = {}, {}, {}
        self.needles: dict[int, dict] = {}
        vid = 0
        for name, _rack in NODES:
            d = os.path.join(root, name)
            os.makedirs(d)
            self.dirs[name] = d
            for _ in range(2):
                vid += 1
                make_volume(d, volume_id=vid, n_needles=110, seed=vid,
                            max_size=20_000).close()
                self.needles[vid] = _needles(d, vid)
        # one cool-down clock for every volume: the quiet window runs from
        # the .dat's mtime, which each server reads when it loads it
        now = time.time()
        for name, d in self.dirs.items():
            for f in os.listdir(d):
                if f.endswith(".dat"):
                    os.utime(os.path.join(d, f), (now, now))
        # the servers first, retrying the master until it is up: every
        # node registers within a pulse of the master's start, before the
        # controller's first cycle
        for name, rack in NODES:
            s = VolumeServer([self.dirs[name]],
                             [f"127.0.0.1:{self.master_port + 10000}"],
                             ip="127.0.0.1", port=free_port(),
                             pulse_seconds=0.5, rack=rack,
                             max_volume_count=40, codec_name="torch_cpu")
            s.start()
            self.servers[name] = s
            self.names[f"127.0.0.1:{s.port}"] = name
        self.stopped: set[str] = set()
        self.master = self.make_master()
        self.master.start()

    def make_master(self) -> MasterServer:
        """A master on the cluster's port over its lifecycle_dir, not yet
        started."""
        saved = {k: os.environ.get(k) for k in PLANE_ENV}
        os.environ.update(PLANE_ENV)
        try:
            m = MasterServer(
                ip="127.0.0.1", port=self.master_port,
                volume_size_limit_mb=1, pulse_seconds=0.5,
                lifecycle_interval=1.0, lifecycle_dir=self.lifecycle_dir,
                lifecycle_policy={"*": {"ec_cooldown_seconds": 4}})
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        # both encodes of a node at once: the gates are made at first use
        m.lifecycle.per_node = 2
        self.master = m
        return m

    def kill(self, name: str) -> None:
        self.servers[name].stop()
        self.stopped.add(name)

    def url(self, name: str) -> str:
        return f"127.0.0.1:{self.servers[name].port}"

    def spread(self, vid: int) -> dict:
        """node name -> shard ids, from the master's shard map."""
        out: dict = {}
        for sid, nodes in self.master.topo.lookup_ec_shards(vid).items():
            for n in nodes:
                out.setdefault(self.names[n.id], []).append(sid)
        return {k: sorted(v) for k, v in sorted(out.items())}

    def all_fourteen(self, without: str = "") -> bool:
        for vid in self.needles:
            sm = self.master.topo.lookup_ec_shards(vid)
            if len(sm) != 14 or any(self.names[n.id] == without
                                    for ns in sm.values() for n in ns):
                return False
        return True

    def jobs(self, transition: str) -> dict:
        return {j["volume_id"]: j for j in self.master.lifecycle.journal.jobs()
                if j["transition"] == transition}

    def shard_digests(self, name: str) -> dict:
        """(vid, shard id) -> sha256 of each shard file in a node's dir."""
        out = {}
        for vid in self.needles:
            for sid in range(14):
                p = os.path.join(self.dirs[name], f"{vid}.ec{sid:02d}")
                if os.path.exists(p):
                    out[(vid, sid)] = _sha(p)
        return out

    def holder_digests(self, keys) -> dict:
        """(vid, sid) -> sha256 of the file on the node the master lists
        as its holder now."""
        out = {}
        for vid, sid in keys:
            holder = self.master.topo.lookup_ec_shards(vid)[sid][0]
            out[(vid, sid)] = _sha(os.path.join(
                self.dirs[self.names[holder.id]], f"{vid}.ec{sid:02d}"))
        return out

    def get_all(self, vids, started: threading.Event | None = None) -> int:
        """Every needle of `vids` by HTTP GET from the holders the master's
        /dir/lookup lists, 8 threads; each body equal to its record."""
        work = []
        for vid in vids:
            code, body = _http(f"http://127.0.0.1:{self.master_port}"
                               f"/dir/lookup?volumeId={vid}")
            assert code == 200, body
            locs = [loc["url"] for loc in json.loads(body)["locations"]]
            for i, (key, (cookie, data)) in enumerate(
                    sorted(self.needles[vid].items())):
                work.append((locs[i % len(locs)], vid, key, cookie, data))

        def get(item):
            url, vid, key, cookie, data = item
            code, body = _http(f"http://{url}/{vid},{key:x}{cookie:08x}")
            assert code == 200 and body == data, (url, vid, key, code)
            if started is not None:
                started.set()

        with ThreadPoolExecutor(8) as pool:
            list(pool.map(get, work))
        return len(work)

    def stop(self):
        for name, s in self.servers.items():
            if name not in self.stopped:
                s.stop()
        self.master.stop()


def _encoded(cl: _Cluster) -> None:
    """Wait for the controller to seal and encode all 8 volumes."""
    _wait(lambda: len(cl.jobs("ec_encode")) == 8 and all(
        j["state"] == "done" for j in cl.jobs("ec_encode").values()),
        "8 ec_encode jobs done")
    _wait(cl.all_fourteen, "14 shards of every volume at the master")
    for vid in cl.needles:
        # one topology snapshot for every encode: 4/4/3/3, none above 4
        assert sorted(len(v) for v in cl.spread(vid).values()) == [
            3, 3, 4, 4], (vid, cl.spread(vid))


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    cl = _Cluster(str(tmp_path_factory.mktemp("maint")))
    yield cl
    cl.stop()


def test_controller_seals_encodes_and_drops_sources(cluster):
    cl = cluster
    _encoded(cl)
    seals = cl.jobs("seal")
    assert sorted(seals) == sorted(cl.needles)
    assert all(j["state"] == "done" for j in seals.values())
    for vid in cl.needles:
        spread = cl.spread(vid)
        assert sorted(s for v in spread.values() for s in v) == list(
            range(14))
    _wait(lambda: not any(
        os.path.exists(os.path.join(d, f"{vid}.dat"))
        for d in cl.dirs.values() for vid in cl.needles),
        "every source .dat dropped")
    _wait(lambda: not any(vid in n.volumes
                          for n in cl.master.topo.nodes.values()
                          for vid in cl.needles),
          "the dropped volumes gone from the topology")
    st = cl.master.lifecycle.status()
    assert st["jobStates"] == {"done": 16}
    assert st["counts"]["errors"] == 0
    # the needles read back from the shards
    assert cl.get_all(sorted(cl.needles)) == sum(
        len(v) for v in cl.needles.values())


def test_dead_server_repaired_with_no_command(cluster):
    """D stopped: every volume back to 14 shards on A, B and C with no
    command, rebuilt files equal to D's by sha256; GETs through the
    master's lookup while the repair runs return every needle equal."""
    cl = cluster
    _encoded(cl)
    lost = cl.shard_digests("d")
    assert lost and {v for v, _s in lost} == set(cl.needles)
    d_url = cl.url("d")
    # the repair's rpcs wait for the GETs to be under way: the two
    # overlap whatever this host's speed
    gets_started = threading.Event()
    real_stub = cl.master.mass_repair._target_stub

    def gated_stub(node):
        assert gets_started.wait(timeout=DEADLINE_S)
        return real_stub(node)

    cl.master.mass_repair._target_stub = gated_stub
    try:
        cl.kill("d")
        _wait(lambda: d_url not in cl.master.topo.nodes,
              "the master drops D")
        done_gets = cl.get_all(sorted(cl.needles), started=gets_started)
        assert done_gets == sum(len(v) for v in cl.needles.values())
        _wait(lambda: cl.all_fourteen(without="d"),
              "14 shards of every volume without D")
    finally:
        cl.master.mass_repair._target_stub = real_stub
    assert cl.holder_digests(lost) == lost
    jobs = cl.jobs("mass_repair")
    assert sorted(jobs) == sorted(cl.needles)
    assert all(j["state"] == "done" and j["dead_node"] == d_url
               for j in jobs.values())
    st = cl.master.mass_repair.status()
    assert st["counts"]["repaired"] == 8 and st["pending"] == 0
    assert st["counts"]["failed"] == st["counts"]["parked"] == 0
    # the needles read back from the repaired cluster
    assert cl.get_all(sorted(cl.needles)) == done_gets


def test_master_restarted_mid_batch_resumes_from_its_journal(tmp_path):
    """The first master does the first rpc of the batch (one volume per
    rpc), is fenced before the rest and stopped with them journaled; a
    second master over the same lifecycle_dir resumes them.  Each volume
    is rebuilt exactly once, across both."""
    before = set(threading.enumerate())  # the module cluster's own
    lc_dir = tmp_path / "lifecycle"
    lc_dir.mkdir()
    cl = _Cluster(str(tmp_path / "nodes"), lifecycle_dir=str(lc_dir))
    try:
        _encoded(cl)
        lost = cl.shard_digests("d")
        rebuilt_by: dict[int, list[str]] = {}
        first = cl.master
        first.mass_repair.jobs_per_rpc = 1

        def recording(master, tag, fence_after=False):
            real = master.mass_repair._target_stub

            class Stub:
                def __init__(self, node):
                    self._stub = real(node)

                def VolumeEcShardsBatchRebuild(self, req):
                    resp = self._stub.VolumeEcShardsBatchRebuild(req)
                    for r in resp.results:
                        rebuilt_by.setdefault(r.volume_id, []).append(tag)
                    if fence_after:
                        master.mass_repair.fence(0)
                    return resp

            master.mass_repair._target_stub = Stub

        recording(first, "first", fence_after=True)
        cl.kill("d")
        _wait(lambda: first.mass_repair.status()["counts"]["repaired"] >= 1,
              "the first master's first rpc")
        journaled = {j["volume_id"]: j["state"]
                     for j in cl.jobs("mass_repair").values()}
        assert sorted(journaled) == sorted(cl.needles)
        assert "pending" in journaled.values()
        first.stop()
        second = cl.make_master()
        assert second.lifecycle.journal.path == str(
            lc_dir / "lifecycle.journal.jsonl")
        assert {j["volume_id"] for j in second.mass_repair.pending()} == {
            v for v, state in journaled.items() if state == "pending"}
        recording(second, "second")
        second.start()
        _wait(lambda: cl.all_fourteen(without="d"),
              "14 shards of every volume after the restart")
        _wait(lambda: not second.mass_repair.pending(), "the batch drained")
        assert sorted(rebuilt_by) == sorted(cl.needles)
        assert all(len(tags) == 1 for tags in rebuilt_by.values()), \
            rebuilt_by
        assert "first" in sum(rebuilt_by.values(), []) \
            and "second" in sum(rebuilt_by.values(), [])
        assert all(j["state"] == "done"
                   for j in cl.jobs("mass_repair").values())
        assert cl.holder_digests(lost) == lost
    finally:
        cl.stop()
    left = [t.name for t in set(threading.enumerate()) - before
            if t.name.startswith(("master-lifecycle", "master-mass-repair"))]
    assert left == []


@pytest.mark.parametrize("mounted", [5, 10])
def test_shell_encode_mid_mount_is_not_repaired(tmp_path, monkeypatch,
                                                mounted):
    """A shell `ec.encode` on a master with mass repair on (its default),
    held after `mounted` of 14 shards are mounted, while the master's
    tick() is forced: the volume's .dat is still mounted, so the master
    neither plans a rebuild of the shards still being copied (10-13
    mounted) nor counts the volume lost (below 10).  The encode then
    finishes with its own spread: 5/5/4 on B, C and D, mounted one node
    at a time."""
    from seaweedfs_tpu_torch.shell import commands as port_shell
    from seaweedfs_tpu_torch.stats.metrics import REPAIR_BATCH_VOLUMES
    from seaweedfs_tpu_torch.volume.grpc_handlers import VolumeGrpcService

    held, release = threading.Event(), threading.Event()
    done = {"shards": 0}
    real_mount = VolumeGrpcService.VolumeEcShardsMount

    def gated_mount(self, request, context):
        if done["shards"] == mounted:
            held.set()
            assert release.wait(timeout=DEADLINE_S)
        resp = real_mount(self, request, context)
        done["shards"] += len(request.shard_ids)
        return resp

    monkeypatch.setattr(VolumeGrpcService, "VolumeEcShardsMount",
                        gated_mount)
    master = MasterServer(ip="127.0.0.1", port=free_port(),
                          volume_size_limit_mb=64, pulse_seconds=0.5)
    assert master.mass_repair.enabled
    master.start()
    servers = []
    try:
        for name, rack in NODES:
            d = tmp_path / name
            d.mkdir()
            if name == "a":
                make_volume(str(d), volume_id=1, n_needles=40, seed=1,
                            max_size=20_000).close()
            s = VolumeServer([str(d)], [f"127.0.0.1:{master.grpc_port}"],
                             ip="127.0.0.1", port=free_port(),
                             pulse_seconds=0.5, rack=rack,
                             max_volume_count=40, codec_name="torch_cpu")
            s.start()
            servers.append(s)
            url = f"127.0.0.1:{s.port}"
            _wait(lambda u=url: u in master.topo.nodes, f"{url} joined")
        _wait(lambda: any(1 in n.volumes for n in master.topo.nodes.values()),
              "volume 1 at the master")
        env = port_shell.CommandEnv(f"127.0.0.1:{master.grpc_port}")
        out: dict = {}
        shell = threading.Thread(target=lambda: out.setdefault(
            "text", port_shell.run_command(env, "ec.encode -volumeId=1")))
        shell.start()
        try:
            assert held.wait(timeout=DEADLINE_S)
            _wait(lambda: len(master.topo.lookup_ec_shards(1)) == mounted,
                  f"{mounted} shards of volume 1 at the master")
            lost = REPAIR_BATCH_VOLUMES.labels("lost").value
            master.mass_repair._last_plan = float("-inf")
            master.mass_repair.tick()
            assert not [j for j in master.lifecycle.journal.jobs()
                        if j["transition"] == "mass_repair"]
            assert master.mass_repair._counts["unrepairable"] == 0
            assert REPAIR_BATCH_VOLUMES.labels("lost").value == lost
        finally:
            release.set()
            shell.join(timeout=DEADLINE_S)
        assert "ec.encode 1: spread" in out["text"], out
        _wait(lambda: len(master.topo.lookup_ec_shards(1)) == 14
              and not any(1 in n.volumes for n in master.topo.nodes.values()),
              "14 shards of volume 1, its .dat dropped")
        master.mass_repair._last_plan = float("-inf")
        master.mass_repair.tick()
        assert master.mass_repair.status()["counts"]["planned"] == 0
    finally:
        for s in servers:
            s.stop()
        master.stop()
