"""The port's lifecycle plane held against the reference's,
tests/test_lifecycle.py case for case: policy parsing, the crash-safe job
journal, controller planning over the same DataNode/VolumeInfo fixtures
(the port's plans must equal the reference's), submission dedup, job
execution against a missing volume server, TTL expiry, the shared scrub
budget, the balance planners the shell and the controller share, the
policy file, the compaction of a remote-tiered volume, and the spreads
the controller's ec_encode jobs plan (from one snapshot, or in turn).  The
tier stage's plans (ec_encode keeping its source, then tier; the
low-space tier half) equal the reference's.
"""

from __future__ import annotations

import json
import os
import time

import pytest
from helpers import free_port

from seaweedfs_tpu.master.server import MasterServer as RefMaster
from seaweedfs_tpu.pb import master_pb2 as ref_pb
from seaweedfs_tpu.topology.topology import DataNode as RefNode
from seaweedfs_tpu.topology.topology import VolumeInfo as RefVolume
from seaweedfs_tpu_torch.maintenance import JobJournal, PolicySet
from seaweedfs_tpu_torch.maintenance.journal import job_key
from seaweedfs_tpu_torch.master.server import MasterServer as PortMaster
from seaweedfs_tpu_torch.pb import master_pb2 as port_pb
from seaweedfs_tpu_torch.storage.ttl import TTL
from seaweedfs_tpu_torch.topology.topology import DataNode as PortNode
from seaweedfs_tpu_torch.topology.topology import VolumeInfo as PortVolume
from seaweedfs_tpu_torch.util import faultpoint
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"ref": (RefMaster, RefNode, RefVolume, ref_pb),
        "port": (PortMaster, PortNode, PortVolume, port_pb)}
TIER_POLICY = {"*": {"ec_cooldown_seconds": 0, "tier_backend": "s3.cold"}}


@pytest.fixture
def masters(tmp_path):
    """-> make(policy=None, journal=True) -> {pkg: MasterServer}, one of
    each package over its own journal dir; the port's controllers are
    stopped (their worker threads joined) after the test."""
    made = []

    def make(policy=None, journal=True, **kw):
        out = {}
        for pkg, (Master, _n, _v, _pb) in PKGS.items():
            d = tmp_path / pkg
            d.mkdir(exist_ok=True)
            out[pkg] = Master(ip="127.0.0.1", port=free_port(),
                              volume_size_limit_mb=1,
                              lifecycle_dir=str(d) if journal else "",
                              lifecycle_policy=policy, **kw)
        made.append(out["port"])
        return out

    yield make
    for m in made:
        m.lifecycle.stop()


def _add_node(ms: dict, nid: str, volumes: dict, ec_vids=()) -> None:
    """The same node, built from each package's own DataNode and
    VolumeInfo, into each master's topology."""
    for pkg, m in ms.items():
        _M, Node, Volume, _pb = PKGS[pkg]
        n = Node(id=nid, public_url=nid,
                 grpc_address=f"{nid.rsplit(':', 1)[0]}:"
                              f"{int(nid.rsplit(':', 1)[1]) + 10000}")
        n.volumes = {vid: Volume(vid, **kw) for vid, kw in volumes.items()}
        n.ec_shards = {vid: 0x3FFF for vid in ec_vids}
        m.topo.nodes[nid] = n


def _plans(ms: dict, now: float | None = None) -> list[dict]:
    """Both controllers' evaluate(); equal, -> the port's."""
    got = {pkg: m.lifecycle.evaluate(now=now) for pkg, m in ms.items()}
    assert got["port"] == got["ref"]
    return got["port"]


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


def test_policy_defaults():
    pol = PolicySet().for_collection("anything")
    assert pol.seal_full_percent == 95.0
    assert pol.ec_cooldown_seconds < 0  # EC disabled by default
    assert pol.tier_backend == ""
    assert pol.vacuum_garbage_ratio == 0.3
    assert pol.ttl_expire
    from seaweedfs_tpu.maintenance import PolicySet as RefPolicySet

    assert PolicySet().to_dict() == RefPolicySet().to_dict()


def test_policy_per_collection_override():
    from seaweedfs_tpu.maintenance import PolicySet as RefPolicySet

    doc = {"*": {"seal_full_percent": 80},
           "photos": {"ec_cooldown_seconds": 10, "ec_codec": "cuda",
                      "tier_backend": "s3.cold"}}
    p = PolicySet.parse(doc)
    assert p.for_collection("photos").ec_cooldown_seconds == 10
    assert p.for_collection("photos").ec_codec == "cuda"
    assert p.for_collection("photos").tier_backend == "s3.cold"
    # photos does NOT inherit the '*' seal override (whole-policy wins)
    assert p.for_collection("other").seal_full_percent == 80
    assert p.for_collection("photos").seal_full_percent == 95.0
    assert p.to_dict() == RefPolicySet.parse(doc).to_dict()


def test_policy_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown lifecycle policy"):
        PolicySet.parse({"*": {"not_a_field": 1}})
    with pytest.raises(ValueError):
        PolicySet.parse({"*": "not an object"})
    with pytest.raises(ValueError):
        PolicySet.parse("[1, 2]")


def test_policy_parse_string_and_roundtrip():
    p = PolicySet.parse('{"*": {"rebalance_skew": 2}}')
    assert p.for_collection("x").rebalance_skew == 2
    again = PolicySet.parse(p.dumps())
    assert again.to_dict() == p.to_dict()
    from seaweedfs_tpu.maintenance import PolicySet as RefPolicySet

    assert p.dumps() == RefPolicySet.parse(
        '{"*": {"rebalance_skew": 2}}').dumps()


# ---------------------------------------------------------------------------
# TTL expiry helper
# ---------------------------------------------------------------------------


def test_ttl_seconds_and_expired():
    t = TTL.parse("3m")
    assert t.seconds() == 180
    now = time.time()
    assert t.expired(now - 181, now=now)
    assert not t.expired(now - 60, now=now)
    # empty TTL never expires, nor does an unknown modified time
    assert not TTL().expired(now - 10**9, now=now)
    assert not t.expired(0, now=now)


# ---------------------------------------------------------------------------
# journal
# ---------------------------------------------------------------------------


def _mk_job(vid, transition, state="pending", **extra):
    return {"key": job_key(vid, transition), "volume_id": vid,
            "transition": transition, "state": state,
            "created_ms": int(time.time() * 1000), "attempts": 0, **extra}


def test_journal_roundtrip_and_replay(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = JobJournal(path)
    j.put(_mk_job(1, "seal"))
    j.put(_mk_job(2, "ec_encode"))
    j.update(job_key(1, "seal"), state="done")
    j.update(job_key(2, "ec_encode"), state="running")

    j2 = JobJournal(path)
    assert j2.get(job_key(1, "seal"))["state"] == "done"
    # running replays as pending (idempotent RPCs, safe to re-run) and
    # is flagged resumed
    rec = j2.get(job_key(2, "ec_encode"))
    assert rec["state"] == "pending"
    assert rec["resumed"] == 1
    assert len(j2.active()) == 1
    # the reference's journal replays the port's file alike
    from seaweedfs_tpu.maintenance import JobJournal as RefJournal

    ref = RefJournal(path)
    assert ref.get(job_key(2, "ec_encode")) == rec
    assert ref.counts() == j2.counts()


def test_journal_memory_only_mode():
    j = JobJournal(None)
    j.put(_mk_job(1, "vacuum"))
    assert j.get(job_key(1, "vacuum"))["state"] == "pending"
    assert j.counts() == {"pending": 1}


def test_journal_survives_torn_tail(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = JobJournal(path)
    j.put(_mk_job(1, "seal"))
    with open(path, "a") as f:
        f.write('{"key": "2:seal", "state": "pe')  # torn write, no \n
    j2 = JobJournal(path)
    assert j2.get(job_key(1, "seal")) is not None
    assert j2.get(job_key(2, "seal")) is None


def test_journal_compaction_bounds_file(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = JobJournal(path)
    j.COMPACT_SLACK = 8
    j.put(_mk_job(1, "vacuum"))
    for i in range(40):
        j.update(job_key(1, "vacuum"),
                 state="done" if i % 2 else "pending")
    with open(path) as f:
        lines = [ln for ln in f if ln.strip()]
    assert len(lines) <= 10  # compacted to ~live keys, not 41 lines
    assert JobJournal(path).get(job_key(1, "vacuum")) is not None


def test_journal_write_fault_fails_loud(tmp_path):
    """The port's own fault registry: arming the point in the port
    fails the port's journal and leaves the reference's alone."""
    from seaweedfs_tpu.maintenance import JobJournal as RefJournal

    j = JobJournal(str(tmp_path / "j.jsonl"))
    ref = RefJournal(str(tmp_path / "ref.jsonl"))
    faultpoint.set_fault("lifecycle.journal.write", "error", count=1)
    try:
        ref.put(_mk_job(1, "seal"))
        with pytest.raises(Exception):
            j.put(_mk_job(1, "seal"))
        # the failed put must not half-register the job
        assert j.get(job_key(1, "seal")) is None
    finally:
        faultpoint.clear_fault("all")
    j.put(_mk_job(1, "seal"))  # works once the fault is gone
    assert j.get(job_key(1, "seal"))["state"] == "pending"


# ---------------------------------------------------------------------------
# controller planning (fake topology, no sockets)
# ---------------------------------------------------------------------------


def test_evaluate_seal_vacuum_ttl(masters):
    ms = masters()
    now = int(time.time())
    _add_node(ms, "127.0.0.1:9001", {
        1: dict(size=1 << 20, modified_at_second=now - 100),
        2: dict(size=500_000, deleted_byte_count=250_000,
                modified_at_second=now - 10),
        3: dict(size=1000, ttl=TTL.parse("1m").to_uint32(),
                modified_at_second=now - 7200),
        4: dict(size=10, modified_at_second=now - 5),  # healthy
    })
    plans = {p["key"]: p for p in _plans(ms, now)}
    assert plans["1:seal"]["transition"] == "seal"
    assert plans["2:vacuum"]["bytes"] == 500_000
    assert "3:ttl_expire" in plans
    assert not any(p["volume_id"] == 4 for p in plans.values())


def test_evaluate_ec_cooldown_gate(masters):
    ms = masters(policy={"*": {"ec_cooldown_seconds": 300}})
    now = int(time.time())
    _add_node(ms, "127.0.0.1:9001", {
        1: dict(size=1 << 19, read_only=True,
                modified_at_second=now - 100),   # too fresh
        2: dict(size=1 << 19, read_only=True,
                modified_at_second=now - 400),   # cold enough
    })
    plans = {p["key"]: p for p in _plans(ms, now)}
    assert "2:ec_encode" in plans
    assert "1:ec_encode" not in plans
    assert plans["2:ec_encode"]["keep_source"] is False


def test_evaluate_tier_follows_ec_and_keeps_source(masters, tmp_path):
    """A policy with a tier backend plans ec_encode keeping its source
    while a volume is not encoded, then tier once it is; the same plans
    as the reference's."""
    ms = masters(policy=TIER_POLICY)
    now = int(time.time())
    _add_node(ms, "127.0.0.1:9001", {
        1: dict(size=1 << 19, read_only=True, modified_at_second=now - 50),
        2: dict(size=1 << 19, read_only=True, modified_at_second=now - 50),
    }, ec_vids=(2,))
    plans = {p["key"]: p for p in _plans(ms, now)}
    # v1 not yet encoded -> ec first, and the tier stage pins the source
    assert plans["1:ec_encode"]["keep_source"] is True
    # v2 already encoded -> its .dat tiers now
    assert plans["2:tier"]["backend"] == "s3.cold"
    assert plans["2:tier"]["keep_local"] is False


def test_evaluate_half_sealed_volume_replans_seal(masters):
    ms = masters()
    now = int(time.time())
    _add_node(ms, "127.0.0.1:9001",
              {1: dict(size=1 << 20, read_only=True,
                       modified_at_second=now - 10)})
    _add_node(ms, "127.0.0.1:9002",
              {1: dict(size=1 << 20, read_only=False,
                       modified_at_second=now - 10)})
    keys = {p["key"] for p in _plans(ms, now)}
    assert "1:seal" in keys  # sealed means sealed on EVERY replica


@pytest.mark.parametrize("policy", [None, TIER_POLICY],
                         ids=["vacuum_only", "tier_half"])
def test_plan_emergency_equal_to_the_reference(masters, policy):
    """plan_emergency on a low-space node: the same forced vacuums as
    the reference's (garbage over 1 %, the live bytes fit), and with a
    tier backend in the policy the same tier half, a sealed encoded
    volume without garbage moved off the node at once."""
    ms = masters(policy=policy)
    now = int(time.time())
    _add_node(ms, "127.0.0.1:9001", {
        1: dict(size=1 << 20, deleted_byte_count=1 << 16, read_only=True,
                modified_at_second=now - 10),
        2: dict(size=1 << 20, modified_at_second=now - 10),  # no garbage
        4: dict(size=1 << 20, read_only=True, modified_at_second=now),
    }, ec_vids=(4,))
    _add_node(ms, "127.0.0.1:9002", {
        3: dict(size=1 << 20, deleted_byte_count=1 << 18,
                modified_at_second=now - 10)})
    got = {pkg: m.lifecycle.plan_emergency("127.0.0.1:9001")
           for pkg, m in ms.items()}
    assert got["port"] == got["ref"]
    want = [("1:vacuum", "low_space")]
    if policy:
        want.append(("4:tier", "low_space"))
    assert [(p["key"], p["reason"]) for p in got["port"]] == want


def test_submit_dedups_and_serializes_per_volume(masters):
    ms = masters()
    now = int(time.time())
    _add_node(ms, "127.0.0.1:9001", {
        1: dict(size=1 << 20, deleted_byte_count=900_000,
                modified_at_second=now - 100),
    })
    for m in ms.values():
        plans = m.lifecycle.evaluate()
        accepted = m.lifecycle.submit(plans)
        assert [j["key"] for j in accepted] == ["1:seal"]
        # same plan again: active job suppresses the duplicate; and a
        # second transition for the same volume is serialized behind it
        assert m.lifecycle.submit(plans) == []
        assert m.lifecycle.submit([
            {"key": "1:vacuum", "volume_id": 1, "transition": "vacuum",
             "collection": "", "node": "127.0.0.1:9001", "holders": [],
             "bytes": 10},
        ]) == []


def test_submit_reissue_cooldown_for_vacuum(masters):
    m = masters()["port"]
    plan = {"key": "7:vacuum", "volume_id": 7, "transition": "vacuum",
            "collection": "", "node": "n1", "holders": ["n1"],
            "bytes": 10}
    assert m.lifecycle.submit([plan])
    m.lifecycle.journal.update("7:vacuum", state="done")
    # freshly done: suppressed
    assert m.lifecycle.submit([plan]) == []
    # pretend it finished long ago (backdate under the journal lock —
    # put() always re-stamps updated_ms): reissued
    with m.lifecycle.journal._lock:
        m.lifecycle.journal._jobs["7:vacuum"]["updated_ms"] = (
            int(time.time() * 1000) - 10_000_000)
    assert m.lifecycle.submit([plan])


def test_failed_job_resubmit_preserves_attempts_then_parks(masters):
    """A failing transition keeps its attempt counter across
    re-submissions, so MAX_ATTEMPTS really parks it instead of retrying
    forever with a fresh counter."""
    m = masters()["port"]
    plan = {"key": "8:seal", "volume_id": 8, "transition": "seal",
            "collection": "", "node": f"127.0.0.1:{free_port()}",
            "holders": [], "bytes": 0}
    plan["holders"] = [plan["node"]]
    assert m.lifecycle.submit([plan])
    m.lifecycle.journal.update("8:seal", state="failed", attempts=2)
    accepted = m.lifecycle.submit([plan])
    assert accepted and accepted[0]["attempts"] == 2  # preserved
    # no volume server behind the node: the 3rd attempt fails -> parked
    res = m.lifecycle.run_pending(wait=True)
    assert res and res[0]["state"] == "parked", res
    assert m.lifecycle.journal.get("8:seal")["attempts"] == 3
    # parked jobs are never resubmitted
    assert m.lifecycle.submit([plan]) == []


def test_run_pending_scoped_by_keys(masters):
    m = masters()["port"]
    node = f"127.0.0.1:{free_port()}"
    for vid in (31, 32):
        m.lifecycle.submit([
            {"key": f"{vid}:seal", "volume_id": vid,
             "transition": "seal", "collection": "",
             "node": node, "holders": [node], "bytes": 0}])
    res = m.lifecycle.run_pending(wait=True, keys={"31:seal"})
    assert [r["key"] for r in res] == ["31:seal"]
    # the unscoped job is untouched
    assert m.lifecycle.journal.get("32:seal")["state"] == "pending"


def test_done_seal_never_reissued(masters):
    m = masters()["port"]
    plan = {"key": "9:tier", "volume_id": 9, "transition": "tier",
            "collection": "", "node": "n1", "holders": ["n1"],
            "bytes": 10, "backend": "s3.x"}
    assert m.lifecycle.submit([plan])
    m.lifecycle.journal.update("9:tier", state="done")
    rec = m.lifecycle.journal.get("9:tier")
    rec["updated_ms"] = 0  # even "long ago" done tier stays done
    m.lifecycle.journal.put(rec)
    assert m.lifecycle.submit([plan]) == []


def test_journal_replay_resumes_into_controller(masters):
    m = masters()["port"]
    m.lifecycle.submit([
        {"key": "5:ec_encode", "volume_id": 5, "transition": "ec_encode",
         "collection": "", "node": "n1", "holders": ["n1"], "bytes": 10},
    ])
    m.lifecycle.journal.update("5:ec_encode", state="running")
    # new controller over the same dir (a restarted master)
    m2 = PortMaster(ip="127.0.0.1", port=free_port(),
                    lifecycle_dir=m.lifecycle.journal_dir)
    try:
        active = m2.lifecycle.journal.active()
        assert [j["key"] for j in active] == ["5:ec_encode"]
        assert active[0]["state"] == "pending"
    finally:
        m2.lifecycle.stop()


def test_status_shape(masters):
    ms = masters()
    st = {pkg: m.lifecycle.status() for pkg, m in ms.items()}
    assert st["port"]["enabled"] is False
    assert "policies" in st["port"] and "*" in st["port"]["policies"]
    assert st["port"]["journalPath"].endswith("lifecycle.journal.jsonl")
    for doc in st.values():
        doc.pop("journalPath")
    assert st["port"] == st["ref"]


def test_vacuum_plan_carries_policy_ratio(masters):
    """Execution must gate on the POLICY's garbage ratio, not the
    master's global default — otherwise a 0.1 policy against the 0.3
    default plans forever and compacts never."""
    ms = masters(policy={"*": {"vacuum_garbage_ratio": 0.1}})
    now = int(time.time())
    _add_node(ms, "127.0.0.1:9001", {
        2: dict(size=500_000, deleted_byte_count=100_000,
                modified_at_second=now - 10),  # 20% garbage
    })
    plans = {p["key"]: p for p in _plans(ms, now)}
    assert plans["2:vacuum"]["ratio"] == 0.1


def test_master_vacuum_skips_read_only_volumes(masters):
    """Sealed volumes are EC candidates: read-only volumes are exempt
    from the vacuum sweep (reference behavior)."""
    ms = masters()
    now = int(time.time())
    _add_node(ms, "127.0.0.1:9001", {
        3: dict(size=100, deleted_byte_count=90, read_only=True,
                modified_at_second=now - 10),
    })
    for m in ms.values():
        assert m.vacuum_volume(3, threshold=0.1) is False


def test_ttl_expire_with_no_live_holder_fails_not_done(masters):
    """ttl_expire is done-forever once journaled: succeeding vacuously
    while every holder is offline would retain expired data for good."""
    m = masters()["port"]
    assert m.lifecycle.submit([
        {"key": "6:ttl_expire", "volume_id": 6,
         "transition": "ttl_expire", "collection": "",
         "node": "127.0.0.1:9001", "holders": ["127.0.0.1:9001"],
         "bytes": 0}])
    res = m.lifecycle.run_pending(wait=True)
    assert res and res[0]["state"] == "failed", res
    assert "no live holder" in m.lifecycle.journal.get(
        "6:ttl_expire")["error"]


def test_shared_budget_withdrawable(tmp_path):
    """A master push of 0 restores the node's local scrub default
    instead of latching a stale cluster budget forever."""
    from seaweedfs_tpu_torch.storage.scrub import Scrubber
    from seaweedfs_tpu_torch.storage.store import Store

    store = Store([str(tmp_path)], needle_cache_mb=0, codec_name="cpu")
    try:
        s = Scrubber(store, rate_mbps=4, interval_s=9999)
        local = s.bucket.rate
        s.set_shared_rate(2.0)
        assert s.bucket.rate == 2.0 * (1 << 20)
        assert s._shared_budget
        s.throttle_background(1)  # charges while the budget is active
        s.set_shared_rate(0.0)
        assert s.bucket.rate == local
        assert not s._shared_budget
    finally:
        store.close()


# ---------------------------------------------------------------------------
# pure balance planners (shared by the shell and the controller)
# ---------------------------------------------------------------------------


def test_compact_refuses_remote_or_tiering_volume(tmp_path):
    """tests/test_lifecycle.py's case on the port's Store: a volume whose
    .dat moved to the S3 stub is not compacted (the vacuum a lifecycle job
    or the master runs), naming the remote tier."""
    from helpers import make_volume, start_s3_stub

    from seaweedfs_tpu_torch.storage.backend_s3 import make_s3_backend
    from seaweedfs_tpu_torch.storage.store import Store

    stub, _handler = start_s3_stub()
    try:
        endpoint = f"http://127.0.0.1:{stub.server_address[1]}"
        make_s3_backend("vacrt", {"endpoint": endpoint, "bucket": "b"})
        make_volume(str(tmp_path), volume_id=23, n_needles=5).close()
        store = Store([str(tmp_path)], needle_cache_mb=0, codec_name="cpu")
        v = store.find_volume(23)
        v.tier_to_remote("s3.vacrt")
        with pytest.raises(ValueError, match="remote-tiered"):
            store.compact_volume(23)
        store.close()
    finally:
        stub.shutdown()
        stub.server_close()


def _topo(pb, node_vols: dict[str, list[int]], max_count: int = 10):
    info = pb.TopologyInfo(id="topo")
    dc = info.data_center_infos.add(id="dc1")
    rack = dc.rack_infos.add(id="r1")
    for nid, vids in node_vols.items():
        dn = rack.data_node_infos.add(id=nid)
        disk = dn.disk_infos[""]
        disk.volume_count = len(vids)
        disk.max_volume_count = max_count
        for vid in vids:
            disk.volume_infos.add(id=vid, size=10)
    return info


def _volume_moves(build) -> list[dict]:
    """Both packages' plan_volume_balance_moves over `build(pb)`; equal,
    -> the port's."""
    from seaweedfs_tpu.shell.volume_commands import \
        plan_volume_balance_moves as ref_plan
    from seaweedfs_tpu_torch.shell.volume_commands import \
        plan_volume_balance_moves as port_plan

    got = port_plan(build(port_pb))
    assert got == ref_plan(build(ref_pb))
    return got


def test_plan_volume_balance_moves_evens_counts():
    moves = _volume_moves(lambda pb: _topo(pb, {
        "n1:80": [1, 2, 3, 4, 5, 6], "n2:80": [], "n3:80": [7]}))
    assert moves, "skewed cluster must plan moves"
    for mv in moves:
        assert mv["source"] == "n1:80"
    assert len(moves) >= 2


def test_plan_volume_balance_skips_replica_holding_target():
    moves = _volume_moves(lambda pb: _topo(pb, {
        "n1:80": [1, 2, 3], "n2:80": [1, 2, 3], "n3:80": []}))
    for mv in moves:
        assert mv["target"] != "n2:80" or mv["volumeId"] not in (1, 2, 3)


def test_plan_volume_balance_prefers_rack_diverse_move():
    def build(pb):
        info = pb.TopologyInfo(id="topo")
        dc = info.data_center_infos.add(id="dc1")
        r1 = dc.rack_infos.add(id="r1")
        r2 = dc.rack_infos.add(id="r2")

        def add(rack, nid, vids):
            dn = rack.data_node_infos.add(id=nid)
            disk = dn.disk_infos[""]
            disk.volume_count = len(vids)
            disk.max_volume_count = 10
            for vid in vids:
                disk.volume_infos.add(id=vid, size=10)

        add(r1, "n1:80", [1, 2, 5, 6])
        add(r2, "n2:80", [])          # the underloaded target
        add(r2, "n3:80", [1, 5, 6])   # sibling of v1 already in r2
        add(r1, "n4:80", [2, 7])      # sibling of v2 in r1
        return info

    moves = _volume_moves(build)
    to_n2 = [mv for mv in moves if mv["target"] == "n2:80"]
    assert to_n2 and to_n2[0]["volumeId"] == 2, moves


def test_plan_volume_balance_balanced_is_empty():
    assert _volume_moves(lambda pb: _topo(pb, {
        "n1:80": [1, 2], "n2:80": [3, 4]})) == []
    assert _volume_moves(lambda pb: _topo(pb, {})) == []


def test_plan_ec_balance_moves():
    from seaweedfs_tpu.shell.ec_commands import \
        plan_ec_balance_moves as ref_plan
    from seaweedfs_tpu_torch.shell.ec_commands import plan_ec_balance_moves

    def build(pb):
        info = pb.TopologyInfo(id="topo")
        dc = info.data_center_infos.add(id="dc1")
        rack = dc.rack_infos.add(id="r1")
        d1 = rack.data_node_infos.add(id="n1:80").disk_infos[""]
        d1.max_volume_count = 10
        d1.ec_shard_infos.add(id=5, ec_index_bits=0x3FFF)  # all 14
        d2 = rack.data_node_infos.add(id="n2:80").disk_infos[""]
        d2.max_volume_count = 10
        return info

    moves = plan_ec_balance_moves(build(port_pb))
    assert moves == ref_plan(build(ref_pb))
    assert moves, "one node holding all 14 shards must shed"
    assert all(mv["source"] == "n1:80" and mv["target"] == "n2:80"
               for mv in moves)
    assert len({mv["shardId"] for mv in moves}) == len(moves)
    assert plan_ec_balance_moves(build(port_pb), collection="other") == []


def test_rebalance_plans_from_controller(masters):
    ms = masters(policy={"*": {"rebalance_skew": 2,
                               "seal_full_percent": 0,
                               "vacuum_garbage_ratio": 0,
                               "ttl_expire": False}})
    now = int(time.time())
    _add_node(ms, "127.0.0.1:9001", {
        i: dict(size=100, modified_at_second=now - 5) for i in range(1, 7)})
    _add_node(ms, "127.0.0.1:9002", {})
    plans = [p for p in _plans(ms, now) if p["transition"] == "rebalance"]
    assert plans, "6-0 skew with skew=2 must plan rebalance jobs"
    for p in plans:
        assert p["source"] == "127.0.0.1:9001"
        assert p["target"] == "127.0.0.1:9002"


def test_default_policy_plans_no_rebalance(masters):
    ms = masters()
    now = int(time.time())
    _add_node(ms, "127.0.0.1:9001", {
        i: dict(size=100, modified_at_second=now - 5) for i in range(1, 7)})
    _add_node(ms, "127.0.0.1:9002", {})
    assert [p for p in _plans(ms, now)
            if p["transition"] == "rebalance"] == []


# ---------------------------------------------------------------------------
# policy file persistence
# ---------------------------------------------------------------------------


def test_policy_file_persists_across_restart(tmp_path):
    m = PortMaster(ip="127.0.0.1", port=free_port(),
                   lifecycle_dir=str(tmp_path))
    m.lifecycle.set_policies({"*": {"rebalance_skew": 3}})
    assert os.path.exists(str(tmp_path / "lifecycle.policy.json"))
    m2 = PortMaster(ip="127.0.0.1", port=free_port(),
                    lifecycle_dir=str(tmp_path))
    assert m2.lifecycle.policies.for_collection("x").rebalance_skew == 3
    # the reference reads the port's policy file alike
    ref = RefMaster(ip="127.0.0.1", port=free_port(),
                    lifecycle_dir=str(tmp_path))
    assert ref.lifecycle.policies.to_dict() == m2.lifecycle.policies.to_dict()


def test_constructor_policy_overrides_file(tmp_path):
    m = PortMaster(ip="127.0.0.1", port=free_port(),
                   lifecycle_dir=str(tmp_path))
    m.lifecycle.set_policies({"*": {"rebalance_skew": 3}})
    m2 = PortMaster(ip="127.0.0.1", port=free_port(),
                    lifecycle_dir=str(tmp_path),
                    lifecycle_policy={"*": {"rebalance_skew": 5}})
    assert m2.lifecycle.policies.for_collection("x").rebalance_skew == 5
    # and the explicit policy becomes the persisted one
    with open(str(tmp_path / "lifecycle.policy.json")) as f:
        assert json.load(f)["*"]["rebalance_skew"] == 5


@pytest.mark.parametrize("doc,kept", [
    ({"*": {"tier_backend": "s3.cold", "ec_cooldown_seconds": 0}}, True),
    ({"*": {"no_such_field": 1}}, False),
])
def test_persisted_policy_file_at_master_start(tmp_path, doc, kept):
    """A persisted policy file naming a tier backend (a reference
    master's) is the master's policy at start, as the reference reads
    it; a bad policy file is warned about and the default policies
    stand, as in the reference."""
    (tmp_path / "lifecycle.policy.json").write_text(json.dumps(doc))
    m = PortMaster(ip="127.0.0.1", port=free_port(),
                   lifecycle_dir=str(tmp_path))
    ref = RefMaster(ip="127.0.0.1", port=free_port(),
                    lifecycle_dir=str(tmp_path))
    got = m.lifecycle.policies.to_dict()
    assert got == ref.lifecycle.policies.to_dict()
    if kept:
        assert got == PolicySet.parse(doc).to_dict()
        assert m.lifecycle.policies.for_collection("x").tier_backend \
            == "s3.cold"
    else:
        assert got == PolicySet().to_dict()


# ---------------------------------------------------------------------------
# the encode spread the controller's ec_encode jobs plan
# ---------------------------------------------------------------------------


def _encode_spreads(batches) -> dict:
    """Spreads of 8 volumes, two on each of 4 nodes of `-max 40`, planned
    by `balanced_ec_distribution` (the free EC slots `do_ec_encode`
    reads): each batch plans from one snapshot, then its shards mount and
    its sources drop before the next batch plans.  -> {vid: {node: n}}."""
    from seaweedfs_tpu.topology.placement import \
        balanced_ec_distribution as ref_plan
    from seaweedfs_tpu_torch.topology.placement import \
        balanced_ec_distribution

    nodes = ("a", "b", "c", "d")
    source = {v: nodes[(v - 1) // 2] for v in range(1, 9)}
    used = {n: 0 for n in nodes}
    volumes = {n: 2 for n in nodes}
    out = {}
    for batch in batches:
        free = {n: (40 - volumes[n]) * 10 - used[n] for n in nodes}
        plans = {v: balanced_ec_distribution(free, 14) for v in batch}
        for v in batch:
            assert plans[v] == ref_plan(free, 14)
            for n, sids in plans[v].items():
                used[n] += len(sids)
            volumes[source[v]] -= 1
            out[v] = {n: len(plans[v].get(n, [])) for n in nodes}
    return out


def test_encode_spreads_in_turn_stack_shards():
    """Planned from one snapshot, every volume spreads 4/4/3/3, so any
    one node's death leaves each volume 10 shards or more.  Planned in
    turn (the next encode seeing the last one's shards and its source's
    10 freed slots), the planner stacks 5 or more shards of a volume on
    one node: that node's death would be a loss, not a repair."""
    at_once = _encode_spreads([range(1, 9)])
    assert all(sorted(s.values()) == [3, 3, 4, 4] for s in at_once.values())
    for batches in ([[v] for v in range(1, 9)],
                    [[1, 3, 5, 7], [2, 4, 6, 8]]):
        in_turn = _encode_spreads(batches)
        assert max(max(s.values()) for s in in_turn.values()) >= 5


def test_two_encode_waves_stack_on_the_last_two_nodes():
    """The chip phase's layout under the default one job per node: one
    volume of each node encodes first, the other after the first wave's
    shards mount and its sources drop.  The first wave spreads 4/4/3/3
    (the first two nodes in topology order take 4), so the second puts 5
    on each of the last two: their death would be a loss, the first
    two's a repair."""
    spreads = _encode_spreads([[1, 3, 5, 7], [2, 4, 6, 8]])
    for v in (1, 3, 5, 7):
        assert spreads[v] == {"a": 4, "b": 4, "c": 3, "d": 3}
    for v in (2, 4, 6, 8):
        assert spreads[v] == {"a": 2, "b": 2, "c": 5, "d": 5}
