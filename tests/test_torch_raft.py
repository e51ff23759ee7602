"""The port's raft quorum held against the reference's (tests/test_raft.py
and tests/test_raft_partition.py).

The consensus core runs the same command sequences through a port node
set and a reference node set over the same in-memory transport, and the
applied state, the persisted state and the rpc answers are compared.  The
master quorum runs as the reference's tests run it, with port masters and
port volume servers (`cpu` codec): failover keeps the volume-id state,
forged rpcs are refused, followers redirect, volume servers chase the new
leader and ask it their lookups (a reference fault the port repairs), and
a leader partitioned away mid-encode leaves its ec_encode job to the new
leader, which finishes it exactly once with shards equal by sha256 to the
reference's encode of the same volume.
"""

import hashlib
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import pytest
from helpers import free_port, make_volume
from torch_threads import one_torch_thread  # noqa: F401

from seaweedfs_tpu.master import raft as ref_raft
from seaweedfs_tpu_torch.master import raft as port_raft
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.util import faultpoint

RAFT = {"ref": ref_raft, "port": port_raft}
DEADLINE_S = 30.0


def _wait(cond, what: str, timeout: float = DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError(f"{what}: not within {timeout} s")


class Net:
    """In-memory lossy transport between named nodes."""

    def __init__(self):
        self.nodes: dict = {}
        self.cut: set[tuple[str, str]] = set()
        self.lock = threading.Lock()

    def send(self, src: str):
        def _send(dst: str, msg: dict):
            with self.lock:
                if (src, dst) in self.cut or (dst, src) in self.cut:
                    return None
                node = self.nodes.get(dst)
            if node is None:
                return None
            return node.handle(msg)

        return _send

    def partition(self, a: str, b: str):
        with self.lock:
            self.cut.add((a, b))

    def heal(self):
        with self.lock:
            self.cut.clear()


def make_cluster(pkg: str, n=3, tmp_path=None):
    net = Net()
    ids = [f"n{i}" for i in range(n)]
    applied = {i: [] for i in ids}
    nodes = []
    for i in ids:
        node = RAFT[pkg].RaftNode(
            i, ids, net.send(i),
            apply_fn=lambda cmd, i=i: applied[i].append(cmd),
            state_path=str(tmp_path / f"{pkg}-{i}.raft") if tmp_path else "",
            election_timeout=(0.15, 0.3),
            heartbeat_interval=0.05,
        )
        net.nodes[i] = node
        nodes.append(node)
    return net, nodes, applied


def wait_leader(nodes):
    def one():
        leaders = [n for n in nodes if n.is_leader() and not n._stop.is_set()]
        return leaders[0] if len(leaders) == 1 else None
    return _wait(one, "a single leader", 5.0)


def _stop(nodes):
    for n in nodes:
        n.stop()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_raft_elects_single_leader(tmp_path, pkg):
    net, nodes, _ = make_cluster(pkg, 3, tmp_path)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        _wait(lambda: all(n.leader_id == leader.id for n in nodes),
              "every node names the leader", 5.0)
        assert sum(1 for n in nodes if n.is_leader()) == 1
    finally:
        _stop(nodes)


def test_raft_replicates_and_applies_as_the_reference(tmp_path):
    """The same proposals through both node sets: every node of both
    applies the same commands in the same order."""
    want = [{"op": "max_vid", "value": v} for v in (5, 9, 12)]
    got = {}
    for pkg in ("ref", "port"):
        net, nodes, applied = make_cluster(pkg, 3, tmp_path)
        for n in nodes:
            n.start()
        try:
            leader = wait_leader(nodes)
            for cmd in want:
                assert leader.propose(dict(cmd), timeout=3)
            _wait(lambda: all(applied[n.id] == want for n in nodes),
                  f"{pkg}: every node applied", 5.0)
            got[pkg] = {n.id: applied[n.id] for n in nodes}
        finally:
            _stop(nodes)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_raft_leader_failover_preserves_log(tmp_path, pkg):
    net, nodes, applied = make_cluster(pkg, 3, tmp_path)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        assert leader.propose({"op": "max_vid", "value": 7}, timeout=3)
        leader.stop()
        net.nodes.pop(leader.id)
        rest = [n for n in nodes if n is not leader]
        new_leader = wait_leader(rest)
        assert new_leader is not leader
        assert any(e.command == {"op": "max_vid", "value": 7}
                   for e in new_leader.log)
        assert new_leader.propose({"op": "max_vid", "value": 8}, timeout=3)
        _wait(lambda: all({"op": "max_vid", "value": 8} in applied[n.id]
                          for n in rest), "8 applied everywhere", 5.0)
        for n in rest:
            assert {"op": "max_vid", "value": 7} in applied[n.id]
    finally:
        _stop(nodes)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_raft_minority_partition_cannot_commit(tmp_path, pkg):
    net, nodes, applied = make_cluster(pkg, 3, tmp_path)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        others = [n for n in nodes if n is not leader]
        for o in others:
            net.partition(leader.id, o.id)
        assert not leader.propose({"op": "max_vid", "value": 99},
                                  timeout=1.0)
        new_leader = wait_leader(others)
        assert new_leader.propose({"op": "max_vid", "value": 100},
                                  timeout=3)
        net.heal()
        _wait(lambda: not leader.is_leader() and {
            "op": "max_vid", "value": 100} in applied[leader.id],
            "the old leader rejoins and repairs its log", 5.0)
        assert {"op": "max_vid", "value": 99} not in applied[new_leader.id]
    finally:
        _stop(nodes)


def test_raft_persisted_state_reads_across_packages(tmp_path):
    """A committed log persisted by one package's node restarts the other
    package's node: the state file has one format."""
    for writer, reader in (("ref", "port"), ("port", "ref")):
        net, nodes, _ = make_cluster(writer, 3, tmp_path)
        for n in nodes:
            n.start()
        leader = wait_leader(nodes)
        assert leader.propose({"op": "max_vid", "value": 42}, timeout=3)
        _stop(nodes)
        reborn = RAFT[reader].RaftNode(
            "n0", ["n0", "n1", "n2"], lambda d, m: None,
            state_path=str(tmp_path / f"{writer}-n0.raft"))
        assert any(e.command == {"op": "max_vid", "value": 42}
                   for e in reborn.log)
        assert reborn.term >= 1


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_raft_apply_time_increment_unique_across_failover(tmp_path, pkg):
    net, nodes, _ = make_cluster(pkg, 3, tmp_path)
    for n in nodes:
        counter = [0]

        def apply(cmd, counter=counter):
            if cmd.get("op") == "inc":
                counter[0] += 1
                return counter[0]
            return None

        n.apply_fn = apply
        n.start()
    try:
        leader = wait_leader(nodes)
        issued = []
        for _ in range(3):
            ok, v = leader.propose_and_get({"op": "inc"}, timeout=3)
            assert ok
            issued.append(v)
        assert issued == [1, 2, 3]
        leader.stop()
        net.nodes.pop(leader.id)
        new_leader = wait_leader([n for n in nodes if n is not leader])
        ok, v = new_leader.propose_and_get({"op": "inc"}, timeout=3)
        assert ok and v == 4, f"expected fresh id 4, got {v}"
    finally:
        _stop(nodes)


def _answers(pkg: str, tmp_path, msgs: list[dict], restart_at: int = -1,
             apply=None) -> tuple[list, object]:
    """Feed `msgs` to one node (restarted from its state file before
    message `restart_at`); -> (its answers, the last node)."""
    path = str(tmp_path / f"{pkg}-solo.raft")
    mk = lambda: RAFT[pkg].RaftNode(  # noqa: E731
        "n0", ["n0", "n1", "n2"], lambda d, m: None,
        apply_fn=apply, state_path=path)
    node = mk()
    out = []
    for i, msg in enumerate(msgs):
        if i == restart_at:
            node = mk()
        out.append(node.handle(dict(msg)))
    return out, node


def _vote(term, candidate):
    return {"type": "vote", "term": term, "candidate": candidate,
            "last_log_index": 0, "last_log_term": 0}


def test_raft_restart_mid_election_cannot_double_vote(tmp_path):
    """A node that voted, crashed and restarted in the same term honours
    its persisted vote; both packages answer the sequence alike."""
    msgs = [_vote(5, "n1"), _vote(5, "n2"), _vote(5, "n1")]
    got = {pkg: _answers(pkg, tmp_path, msgs, restart_at=1)
           for pkg in ("ref", "port")}
    assert [a["granted"] for a in got["port"][0]] == [True, False, True]
    assert got["port"][0] == got["ref"][0]
    assert (got["port"][1].term, got["port"][1].voted_for) == (5, "n1")


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_raft_same_term_stepdown_keeps_vote(tmp_path, pkg):
    node = RAFT[pkg].RaftNode("n0", ["n0", "n1", "n2"], lambda d, m: None,
                              state_path=str(tmp_path / f"{pkg}.raft"))
    assert node.handle(_vote(3, "n1"))["granted"] is True
    with node.lock:
        node._become_follower(node.term)  # same-term step-down
    assert node.voted_for == "n1"
    assert node.handle(_vote(3, "n2"))["granted"] is False
    assert node.handle(_vote(4, "n2"))["granted"] is True


def test_raft_conflicting_entries_truncated_to_converge(tmp_path):
    """A follower holding a deposed leader's uncommitted entries
    truncates them on the new leader's conflicting append: both packages
    answer alike, apply alike and persist the truncation."""
    stale = {"type": "append", "term": 1, "leader": "n1",
             "prev_log_index": 0, "prev_log_term": 0,
             "entries": [{"term": 1, "command": {"op": "max_vid",
                                                 "value": 7}},
                         {"term": 1, "command": {"op": "max_vid",
                                                 "value": 8}}],
             "leader_commit": 0}
    fresh = {"type": "append", "term": 2, "leader": "n2",
             "prev_log_index": 0, "prev_log_term": 0,
             "entries": [{"term": 2, "command": {"op": "noop"}},
                         {"term": 2, "command": {"op": "max_vid",
                                                 "value": 9}}],
             "leader_commit": 2}
    got = {}
    for pkg in ("ref", "port"):
        applied = []
        answers, node = _answers(pkg, tmp_path, [stale, fresh],
                                 apply=applied.append)
        reborn = RAFT[pkg].RaftNode(
            "n0", ["n0", "n1", "n2"], lambda d, m: None,
            state_path=str(tmp_path / f"{pkg}-solo.raft"))
        got[pkg] = (answers, applied, [e.term for e in node.log],
                    [e.term for e in reborn.log])
    assert got["port"][1] == [{"op": "max_vid", "value": 9}]
    assert got["port"][3] == [2, 2]
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_raft_partitioned_leader_steps_down(tmp_path, pkg):
    """Check-quorum: a leader cut off from every follower deposes itself
    (the role-change callback fires) instead of reigning alone."""
    net, nodes, applied = make_cluster(pkg, 3, tmp_path)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        deposed = threading.Event()
        leader.on_role_change = lambda role, term: (
            deposed.set() if role != RAFT[pkg].LEADER else None)
        for o in nodes:
            if o is not leader:
                net.partition(leader.id, o.id)
        assert not leader.propose({"op": "max_vid", "value": 50},
                                  timeout=1.0)
        assert deposed.wait(5.0), "partitioned leader never stepped down"
        assert not leader.is_leader()
        for n in nodes:
            assert {"op": "max_vid", "value": 50} not in applied[n.id]
        net.heal()
        new_leader = wait_leader(nodes)
        assert new_leader.propose({"op": "max_vid", "value": 51}, timeout=3)
    finally:
        _stop(nodes)


def test_port_follower_slow_flush_keeps_the_leader(tmp_path):
    """Port difference (a reference fault): a follower whose flushes take
    three election timeouts (a disk busy with shard writes) neither
    starts an election nor deposes the leader: it answers heartbeats
    while it flushes, and the other follower carries the commits."""
    net, nodes, applied = make_cluster("port", 3, tmp_path)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        term = leader.term
        slow = next(n for n in nodes if n is not leader)
        real_write = slow._write_state

        def stalled(version, doc):
            time.sleep(1.0)
            real_write(version, doc)

        slow._write_state = stalled
        want = [{"op": "max_vid", "value": v} for v in range(5)]
        for cmd in want:
            assert leader.propose(dict(cmd), timeout=3)
        _wait(lambda: all(applied[n.id] == want for n in nodes),
              "every node applied", 10.0)
        assert leader.is_leader() and leader.term == term
        assert all(n.term == term for n in nodes)
    finally:
        _stop(nodes)


def test_port_node_stop_joins_its_threads(tmp_path):
    """Port difference: stop() joins the election and replication loops,
    the role-change callbacks and the rpc pool of the node."""
    before = set(threading.enumerate())
    net, nodes, _ = make_cluster("port", 3, tmp_path)
    for n in nodes:
        n.on_role_change = lambda role, term: time.sleep(0.05)
        n.start()
    wait_leader(nodes)
    _stop(nodes)
    left = [t.name for t in set(threading.enumerate()) - before
            if t.name.startswith("master-raft")]
    assert left == []


def test_master_peers_mismatch_rejected():
    with pytest.raises(ValueError):
        MasterServer(ip="127.0.0.1", port=19999,
                     peers=["10.0.0.1:9333", "10.0.0.2:9333"])


# -- master quorum integration ----------------------------------------------


def _quorum(tmp_path, n=3, **kw) -> list:
    ports = [free_port() for _ in range(n)]
    peers = [f"127.0.0.1:{p}" for p in ports]
    masters = [MasterServer(ip="127.0.0.1", port=p, peers=peers,
                            raft_state_dir=str(tmp_path), **kw)
               for p in ports]
    for m in masters:
        m.start()
    return masters


def _leader(masters, warmed=False):
    def one():
        live = [m for m in masters if not m._stop.is_set()]
        leaders = [m for m in live if m.is_leader()]
        if len(leaders) != 1 or (warmed and not leaders[0].control_warmed()):
            return None
        want = f"127.0.0.1:{leaders[0].port}"
        return leaders[0] if all(m.leader() == want for m in live) else None
    return _wait(one, "one leader every master names")


def _stop_all(*groups):
    for g in groups:
        for x in g:
            try:
                x.stop()
            except Exception:  # noqa: BLE001 — stopping twice is fine
                pass


def test_master_quorum_failover(tmp_path):
    masters = _quorum(tmp_path)
    try:
        leader = _leader(masters)
        follower = next(m for m in masters if m is not leader)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{follower.port}/cluster/status",
                timeout=5) as r:
            status = json.loads(r.read())
        assert status["Leader"] == f"127.0.0.1:{leader.port}"
        assert status["IsLeader"] is False
        assert status["Raft"]["role"] == "follower"
        vid = leader.next_volume_id()
        _wait(lambda: all(m.topo.max_volume_id >= vid for m in masters),
              "the volume id replicated")
        leader.stop()
        rest = [m for m in masters if m is not leader]
        new_leader = _leader(rest)
        assert new_leader.topo.max_volume_id >= vid
        assert new_leader.next_volume_id() > vid
    finally:
        _stop_all(masters)


def test_raft_transport_rejects_forged_messages(tmp_path):
    """With a cluster secret, unsigned /cluster/raft POSTs get 403 and
    change nothing."""
    masters = _quorum(tmp_path, 2, jwt_signing_key=b"sekrit")
    try:
        _wait(lambda: any(m.is_leader() for m in masters),
              "the signed quorum elects")
        forged = json.dumps({
            "type": "append", "term": 999, "leader": "evil",
            "prev_log_index": 0, "prev_log_term": 0,
            "entries": [{"term": 999, "command": {"op": "max_vid",
                                                  "value": 4_000_000_000}}],
            "leader_commit": 1,
        }).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{masters[0].port}/cluster/raft", data=forged,
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5)
        assert ei.value.code == 403
        assert masters[0].raft.term < 999
        assert masters[0].topo.max_volume_id < 4_000_000_000
    finally:
        _stop_all(masters)


def test_follower_redirects_admin_endpoints(tmp_path):
    """Followers 307 the state-bearing endpoints to the leader (a posted
    body drained first), and a follower that knows a leader is
    healthy."""
    masters = _quorum(tmp_path)
    try:
        leader = _leader(masters)
        follower = next(m for m in masters if m is not leader)
        expect = f"http://127.0.0.1:{leader.port}"

        class NoRedirect(urllib.request.HTTPRedirectHandler):
            def redirect_request(self, *a, **k):
                return None

        opener = urllib.request.build_opener(NoRedirect)
        for path in ("/dir/assign", "/vol/grow?collection=x", "/vol/status"):
            with pytest.raises(urllib.error.HTTPError) as e:
                opener.open(f"http://127.0.0.1:{follower.port}{path}",
                            timeout=5)
            assert e.value.code == 307, path
            assert e.value.headers["Location"].startswith(expect), path
            e.value.close()
        req = urllib.request.Request(
            f"http://127.0.0.1:{follower.port}/submit",
            data=b"x" * 100000, method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            opener.open(req, timeout=5)
        assert e.value.code == 307
        e.value.close()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{follower.port}/cluster/healthz",
                timeout=5) as r:
            assert json.loads(r.read())["ok"] is True
    finally:
        _stop_all(masters)


def _start_volume_servers(tmp_path, masters, n, **kw) -> list:
    from seaweedfs_tpu_torch.volume.server import VolumeServer

    servers = []
    for i in range(n):
        d = tmp_path / f"vol{i}"
        d.mkdir(exist_ok=True)
        s = VolumeServer(
            directories=[str(d)],
            master_addresses=[f"127.0.0.1:{m.grpc_port}" for m in masters],
            ip="127.0.0.1", port=free_port(), pulse_seconds=0.5,
            rack=f"rack{i // 2}", max_volume_count=20, codec_name="cpu",
            **kw)
        s.start()
        servers.append(s)
    return servers


def _assign_ok(m) -> bool:
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{m.port}/dir/assign", timeout=5) as r:
            return "fid" in json.loads(r.read())
    except (OSError, ValueError):
        return False


def test_volume_server_chases_leader_across_failover(tmp_path):
    """A volume server heartbeating a 3-master quorum re-registers with
    the new leader after the old one stops, assigns keep working there,
    and its lookups go to the leader whose ack it holds.  Port
    difference (a reference fault): the reference's lookups ask
    `current_leader or master_addresses[0]`, and a server that reached
    the leader as a seed has no current_leader, so they ask the first
    seed, which here is the stopped master."""
    masters = _quorum(tmp_path)
    servers = []
    try:
        # the first seed is the leader: the case the port repairs
        leader = _leader(masters)
        masters.remove(leader)
        masters.insert(0, leader)
        servers = _start_volume_servers(tmp_path, masters, 1)
        vs = servers[0]
        _wait(lambda: leader.topo.nodes, "the server registered")
        assert _assign_ok(leader)
        assert vs._lookup_master() == f"127.0.0.1:{leader.grpc_port}"
        leader.stop()
        new_leader = _leader(masters[1:])
        _wait(lambda: new_leader.topo.nodes, "re-registered after failover")
        _wait(lambda: _assign_ok(new_leader), "assign on the new leader")
        _wait(lambda: vs._lookup_master()
              == f"127.0.0.1:{new_leader.grpc_port}",
              "lookups asking the new leader")
        assert vs.master_addresses[0] == f"127.0.0.1:{leader.grpc_port}"
    finally:
        _stop_all(servers, masters)


def _shard_digests(servers, vid: int) -> dict[int, str]:
    from seaweedfs_tpu.storage.ec import constants as ecc

    out = {}
    for s in servers:
        for loc in s.store.locations:
            base = loc.base_name(vid, "")
            for sid in range(ecc.TOTAL_SHARDS):
                p = base + ecc.to_ext(sid)
                if os.path.exists(p):
                    with open(p, "rb") as f:
                        out.setdefault(sid, hashlib.sha256(
                            f.read()).hexdigest())
    return out


def test_leader_lost_mid_encode_leaves_one_equal_encode(tmp_path):
    """A port quorum with 4 port volume servers on `cpu`: the lifecycle
    seals and starts encoding volume 1; while its ec_encode job is held
    running on the leader (a delay at `lifecycle.job.run`), the leader is
    cut from its peers (`raft.send`) and stopped.  The new leader resumes
    the replicated job and finishes it exactly once: one done record with
    a `resumed` marker on every live master, 14 shards mounted across the
    servers and the source dropped, each shard equal by sha256 to the
    reference's encode of the same volume, and a volume id grown
    afterwards not reissued."""
    from seaweedfs_tpu.storage.ec import constants as ecc
    from seaweedfs_tpu.storage.ec.encoder import (
        generate_ec_files,
        write_sorted_file_from_idx,
    )

    stage = tmp_path / "stage"
    stage.mkdir()
    vol = make_volume(str(stage), volume_id=1, n_needles=60, seed=5,
                      max_size=64 * 1024)
    base = vol.file_name()
    vol.close()
    (tmp_path / "vol0").mkdir()
    for ext in (".dat", ".idx"):
        shutil.copy(base + ext, tmp_path / "vol0" / f"1{ext}")
    # the reference's encode of the same volume, default block sizes
    generate_ec_files(base, codec_name="cpu")
    write_sorted_file_from_idx(base)
    want = {}
    for sid in range(ecc.TOTAL_SHARDS):
        with open(base + ecc.to_ext(sid), "rb") as f:
            want[sid] = hashlib.sha256(f.read()).hexdigest()
    stale = time.time() - 60
    os.utime(tmp_path / "vol0" / "1.dat", (stale, stale))
    faultpoint.set_fault("lifecycle.job.run", "delay", delay=3.0,
                         match="ec_encode:1")
    masters = _quorum(
        tmp_path, volume_size_limit_mb=1, pulse_seconds=0.5,
        lifecycle_interval=0.5,
        lifecycle_policy={"*": {"ec_cooldown_seconds": 0}})
    servers = []
    try:
        leader = _leader(masters, warmed=True)
        servers = _start_volume_servers(tmp_path, masters, 4)
        _wait(lambda: len(leader.topo.nodes) == 4, "4 servers registered")
        old_epoch = leader.leader_epoch()

        def running():
            return [j for j in leader.lifecycle.journal.jobs(("running",))
                    if j["transition"] == "ec_encode"]

        _wait(running, "the ec_encode job running")
        before_vids = {1, leader.topo.max_volume_id}
        faultpoint.set_fault("raft.send", "error",
                             match=f"127.0.0.1:{leader.port}")
        faultpoint.clear_fault("lifecycle.job.run")
        rest = [m for m in masters if m is not leader]
        new_leader = _leader(rest, warmed=True)
        assert new_leader.leader_epoch() > old_epoch
        leader.stop()
        faultpoint.clear_fault("raft.send")

        def done():
            j = new_leader.lifecycle.journal.get("1:ec_encode")
            return j is not None and j["state"] == "done"

        _wait(done, "the ec_encode job done", 60.0)
        job = new_leader.lifecycle.journal.get("1:ec_encode")
        assert job.get("resumed", 0) >= 1
        for m in rest:
            _wait(lambda m=m: (m.lifecycle.journal.get("1:ec_encode")
                               or {}).get("state") == "done",
                  "the job done on every live master")
        _wait(lambda: sum(len(n.ec_shards.get(1).shard_ids())
                          for n in new_leader.topo.nodes.values()
                          if 1 in n.ec_shards) == ecc.TOTAL_SHARDS,
              "14 shards mounted")
        _wait(lambda: not (tmp_path / "vol0" / "1.dat").exists(),
              "the source dropped")
        assert _shard_digests(servers, 1) == want
        grown = new_leader.grow_volumes("after", "000", "", target_count=1)
        assert grown and not set(grown) & before_vids
    finally:
        faultpoint.clear_fault("lifecycle.job.run")
        faultpoint.clear_fault("raft.send")
        _stop_all(servers, masters)


# -- partition chaos (tests/test_raft_partition.py) --------------------------


def _stage_ec_volumes(tmp_path, servers, vids, victim_sids):
    """Tiny EC volumes encoded by the reference and mounted across the
    port's `servers`; the victim (servers[0]) holds victim_sids(v)."""
    from seaweedfs_tpu.storage.ec import constants as ecc
    from seaweedfs_tpu.storage.ec.encoder import (
        generate_ec_files,
        write_sorted_file_from_idx,
    )

    stage = tmp_path / "stage"
    stage.mkdir()
    needles: dict = {}
    for v in vids:
        d = stage / str(v)
        d.mkdir()
        vol = make_volume(str(d), volume_id=v, n_needles=10, seed=v,
                          max_size=2000)
        needles[v] = {}
        for i in range(1, 11):
            n = vol.read_needle(i)
            needles[v][f"{v},{i:x}{n.cookie:08x}"] = bytes(n.data)
        base = vol.file_name()
        vol.close()
        generate_ec_files(base, large_block_size=10000,
                          small_block_size=100, codec_name="cpu",
                          slice_size=1 << 20)
        write_sorted_file_from_idx(base)
        vic = set(victim_sids(v))
        assign = {j: [] for j in range(len(servers))}
        assign[0] = sorted(vic)
        rest = [sid for sid in range(ecc.TOTAL_SHARDS) if sid not in vic]
        for k, sid in enumerate(rest):
            assign[1 + k % (len(servers) - 1)].append(sid)
        for j, sids in assign.items():
            tbase = servers[j].store.locations[0].base_name(v, "")
            shutil.copy(base + ".ecx", tbase + ".ecx")
            for sid in sids:
                shutil.copy(base + ecc.to_ext(sid), tbase + ecc.to_ext(sid))
            servers[j].store.mount_ec_shards(v, "", sids)
            ev = servers[j].store.find_ec_volume(v)
            ev.large_block_size = 10000
            ev.small_block_size = 100
    return needles


@pytest.mark.chaos
def test_chaos_asymmetric_partition_mid_mass_repair(tmp_path):
    """The reference's partition chaos on port masters and port servers:
    a mass repair held open by a delay fault, the leader cut off from its
    peers (servers still reach it), one leader survives, the repair
    completes exactly once under the new leader with 14 shards of every
    volume mounted, each exactly once, and no fid assigned twice.

    Two differences from the reference's copy, both for its faults
    (ROADMAP §C): the staged EC volumes take ids 101-106, since shards
    mounted behind the master's back do not raise its volume-id counter
    and the assigns' growth would reissue ids 1-6 as plain volumes; and
    the journal is waited on until every job is done, since the deposed
    leader's batch can mount the shards before the new leader has
    resumed and closed its jobs."""
    from seaweedfs_tpu.storage.ec import constants as ecc

    n_srv = 5
    vids = list(range(101, 107))
    (tmp_path / "raft").mkdir()
    ports = [free_port() for _ in range(3)]
    peers = [f"127.0.0.1:{p}" for p in ports]
    masters = []
    for i, p in enumerate(ports):
        jd = tmp_path / f"journal{i}"
        jd.mkdir()
        m = MasterServer(
            ip="127.0.0.1", port=p, peers=peers,
            raft_state_dir=str(tmp_path / "raft"), lifecycle_dir=str(jd),
            volume_size_limit_mb=64, pulse_seconds=0.5,
            repair_deadline_s=90.0, sequencer="snowflake",
            sequencer_node_id=i + 1)
        m.start()
        masters.append(m)
    servers = []
    fids: list = []
    stop = threading.Event()
    try:
        leader = _leader(masters, warmed=True)
        quorum = [m for m in masters if m is not leader]
        from seaweedfs_tpu_torch.volume.server import VolumeServer

        for i in range(n_srv):
            d = tmp_path / f"vol{i}"
            d.mkdir()
            s = VolumeServer(
                directories=[str(d)],
                master_addresses=[f"127.0.0.1:{m.grpc_port}"
                                  for m in masters],
                ip="127.0.0.1", port=free_port(), pulse_seconds=0.5,
                rack=f"rack{i % 2}", data_center="dc1",
                max_volume_count=600, codec_name="cpu")
            s.start()
            servers.append(s)
        _wait(lambda: len(leader.topo.nodes) == n_srv, "servers registered")
        _stage_ec_volumes(tmp_path, servers, vids,
                          lambda v: [v % 14, (v + 1) % 14])
        _wait(lambda: all(len(leader.topo.lookup_ec_shards(v)) == 14
                          for v in vids), "shards listed")

        def hammer():
            while not stop.is_set():
                live = [m for m in masters if m.is_leader()]
                if live:
                    try:
                        with urllib.request.urlopen(
                                f"http://127.0.0.1:{live[0].port}"
                                "/dir/assign", timeout=20) as r:
                            doc = json.loads(r.read())
                            if "fid" in doc:
                                fids.append(doc["fid"])
                    except OSError:
                        pass
                stop.wait(0.02)

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        _wait(lambda: len(fids) >= 5, "assigns started")
        faultpoint.set_fault("repair.batch.source", "delay", delay=1.5)
        servers[0].stop()
        _wait(lambda: [j for j in quorum[0].lifecycle.journal.jobs(
            ("running",)) if j.get("transition") == "mass_repair"],
            "a mass_repair job replicated as running", 60.0)
        faultpoint.set_fault("raft.send", "error",
                             match=f"127.0.0.1:{leader.port}")
        faultpoint.clear_fault("repair.batch.source")
        new_leader = _leader(quorum, warmed=True)
        _wait(lambda: not leader.is_leader(), "the cut leader steps down")
        survivors = servers[1:]

        def all_mounted():
            for v in vids:
                held: dict = {}
                for s in survivors:
                    for sid in s.store.status()["ec_volumes"].get(v, []):
                        held[sid] = held.get(sid, 0) + 1
                if sorted(held) != list(range(ecc.TOTAL_SHARDS)):
                    return False
                assert all(c == 1 for c in held.values()), (v, held)
            return True

        try:
            _wait(all_mounted, "14 shards of every volume, each once", 120.0)
        except AssertionError:
            held = {v: sorted(sid for s in survivors for sid in s.store.status()[
                "ec_volumes"].get(v, [])) for v in vids}
            jobs = {m.port: [(j["key"], j["state"], j.get("resumed"))
                             for j in m.lifecycle.journal.jobs()]
                    for m in masters}
            raise AssertionError(f"shards held {held}; journals {jobs}")
        def mass_done():
            mass = [j for j in new_leader.lifecycle.journal.jobs()
                    if j.get("transition") == "mass_repair"]
            return len(mass) == len(vids) and all(
                j["state"] == "done" for j in mass)

        _wait(mass_done, "every mass_repair job done", 60.0)
        stop.set()
        t.join(timeout=20)
        assert len(fids) == len(set(fids)), "a fid assigned twice"
    finally:
        stop.set()
        faultpoint.clear_fault("raft.send")
        faultpoint.clear_fault("repair.batch.source")
        _stop_all(servers[1:], masters)


@pytest.mark.chaos
def test_chaos_vs_reregisters_with_new_leader_quickly(tmp_path):
    """A volume server heartbeating a leader that gets partitioned away
    re-registers with the new leader within an election-timeout budget."""
    masters = _quorum(tmp_path)
    servers = []
    try:
        leader = _leader(masters, warmed=True)
        quorum = [m for m in masters if m is not leader]
        servers = _start_volume_servers(tmp_path, masters, 1)
        servers[0].pulse_seconds = 0.2
        _wait(lambda: leader.topo.nodes, "registered")
        faultpoint.set_fault("raft.send", "error",
                             match=f"127.0.0.1:{leader.port}")
        new_leader = _leader(quorum)
        _wait(lambda: f"127.0.0.1:{servers[0].port}" in new_leader.topo.nodes,
              "re-registered with the new leader", 3.0)
    finally:
        faultpoint.clear_fault("raft.send")
        _stop_all(servers, masters)
