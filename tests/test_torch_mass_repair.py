"""The port's dead-node mass repair held against the reference's,
tests/test_mass_repair.py case for case: exposure ranking and labels,
rebuild-target spreading, the cross-volume batched partial transport
(volumes encoded by the reference on `cpu`, rebuilt by the port on
`torch_cpu`, equal by sha256; coalescing; per-volume fallback on a source
death), the orchestrator's plan over the same topology fixtures (equal to
the reference's), crash-safe journal resume exactly once, parking, the
scrub-pass and lifecycle exclusions, the Lifecycle rpc's mass-repair
actions, the volume server's cache-invalidation registry, and proactive
evacuation of a failing disk."""

import hashlib
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import grpc
import pytest
from helpers import free_port, make_volume

from seaweedfs_tpu.maintenance.mass_repair import \
    exposure_class as ref_exposure_class
from seaweedfs_tpu.maintenance.mass_repair import \
    rank_by_exposure as ref_rank
from seaweedfs_tpu.master.server import MasterServer as RefMaster
from seaweedfs_tpu.storage.ec.encoder import (generate_ec_files,
                                              write_sorted_file_from_idx)
from seaweedfs_tpu.topology.placement import \
    spread_rebuild_targets as ref_spread
from seaweedfs_tpu.topology.topology import DataNode as RefNode
from seaweedfs_tpu.topology.topology import VolumeInfo as RefVolume
from seaweedfs_tpu_torch.maintenance.mass_repair import (exposure_class,
                                                         rank_by_exposure)
from seaweedfs_tpu_torch.master.server import MasterServer as PortMaster
from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.stats.metrics import (EC_PARTIAL_FALLBACK,
                                               EC_PARTIAL_JOBS,
                                               REPAIR_BATCH_JOBS)
from seaweedfs_tpu_torch.storage.ec import constants as ecc
from seaweedfs_tpu_torch.storage.ec import partial as P
from seaweedfs_tpu_torch.storage.ec.encoder import rebuild_ec_files
from seaweedfs_tpu_torch.storage.ec.shard_bits import ShardBits
from seaweedfs_tpu_torch.topology.placement import spread_rebuild_targets
from seaweedfs_tpu_torch.topology.topology import DataNode as PortNode
from seaweedfs_tpu_torch.topology.topology import VolumeInfo as PortVolume
from seaweedfs_tpu_torch.util import faultpoint
from torch_threads import one_torch_thread  # noqa: F401

LARGE = 10000
SMALL = 100
PKGS = {"ref": (RefMaster, RefNode, RefVolume),
        "port": (PortMaster, PortNode, PortVolume)}


# -- pure planning --------------------------------------------------------


def test_rank_by_exposure_floor_first():
    """Volumes one shard from data loss (10 surviving) schedule strictly
    before every healthier volume, regardless of size."""
    vols = [
        {"volume_id": 1, "surviving": 13, "shard_size": 999999},
        {"volume_id": 2, "surviving": 10, "shard_size": 1},
        {"volume_id": 3, "surviving": 12, "shard_size": 5},
        {"volume_id": 4, "surviving": 10, "shard_size": 777},
        {"volume_id": 5, "surviving": 11, "shard_size": 123456},
    ]
    ranked = rank_by_exposure(vols)
    assert ranked == ref_rank(vols)
    assert [v["volume_id"] for v in ranked][:2] == [4, 2]
    assert [v["surviving"] for v in ranked] == [10, 10, 11, 12, 13]


def test_exposure_class_labels():
    for surviving in range(0, 15):
        assert exposure_class(surviving) == ref_exposure_class(surviving)
    assert exposure_class(9) == "lost"
    assert exposure_class(10) == "0"
    assert exposure_class(11) == "1"
    assert exposure_class(13) == "3"
    assert exposure_class(14) == "3"  # clamped: healthy never planned


def test_spread_targets_respects_cap():
    """N volumes over alive nodes: no node gets more than
    ceil(N/alive)+1 assignments, even when every volume prefers the
    same holder."""
    import math

    n_vols, nodes = 20, {f"n{i}:80": 100 for i in range(4)}
    vols = [{"volume_id": v, "surviving": 10,
             "holders": {"n0:80": 9, "n1:80": 1}} for v in range(n_vols)]
    targets = spread_rebuild_targets(vols, nodes)
    assert targets == ref_spread(vols, nodes)
    assert len(targets) == n_vols
    cap = math.ceil(n_vols / len(nodes)) + 1
    per_node: dict = {}
    for t in targets.values():
        per_node[t] = per_node.get(t, 0) + 1
    assert max(per_node.values()) <= cap, per_node


def test_spread_targets_prefers_surviving_holders():
    nodes = {"a:80": 10, "b:80": 10}
    vols = [{"volume_id": 1, "holders": {"b:80": 7, "a:80": 3}}]
    assert spread_rebuild_targets(vols, nodes) == {1: "b:80"} \
        == ref_spread(vols, nodes)


def test_spread_targets_skips_full_nodes():
    vols = [{"volume_id": 1, "holders": {"full:80": 9, "ok:80": 1}}]
    assert spread_rebuild_targets(
        vols, {"full:80": 0, "ok:80": 5}) == {1: "ok:80"}
    assert spread_rebuild_targets(
        vols, {"full:80": 0, "alsofull:80": 0}) in (
        {1: "full:80"}, {1: "alsofull:80"})


# -- cross-volume batched transport ---------------------------------------


@pytest.fixture()
def multi_volume_fleet(tmp_path):
    """4 volumes encoded by the REFERENCE on `cpu`, spread over 5 fake
    source nodes on 2 racks; each volume is missing shard (vid % 14)
    cluster-wide, whose reference bytes are the digests to meet."""
    n_src = 5
    nodes: dict = {}
    holders_of: dict = {}
    bases: dict = {}
    digests: dict = {}
    for v in range(1, 5):
        d = tmp_path / f"v{v}"
        d.mkdir()
        vol = make_volume(str(d), volume_id=v, n_needles=30, seed=v,
                          max_size=2500)
        base = vol.file_name()
        vol.close()
        generate_ec_files(base, large_block_size=LARGE,
                          small_block_size=SMALL, codec_name="cpu",
                          slice_size=1 << 20)
        write_sorted_file_from_idx(base)
        lost = v % ecc.TOTAL_SHARDS
        with open(base + ecc.to_ext(lost), "rb") as f:
            digests[v] = hashlib.sha256(f.read()).hexdigest()
        bases[v] = base
        holders: dict = {}
        for sid in range(ecc.TOTAL_SHARDS):
            if sid == lost:
                continue
            addr = f"mass-src-{sid % n_src}:0"
            nodes.setdefault(addr, {}).setdefault(v, (base, []))[1].append(
                sid)
            holders.setdefault(sid, []).append(
                (addr, f"rack{(sid % n_src) % 2}", "dc1"))
        holders_of[v] = holders
    stub_for = P.local_source_network(nodes)
    return stub_for, holders_of, bases, digests


def _batched_rebuild(tmp_path, stub_for, holders_of, bases, digests,
                     session, vids, slice_size=1000, with_fallback=False):
    """Each volume rebuilt on the port's `torch_cpu` codec through
    `session`; every rebuilt shard equal by sha256 to the reference's."""
    results = {}

    def one(v):
        rdir = tmp_path / f"r{v}"
        rdir.mkdir(exist_ok=True)
        rbase = str(rdir / str(v))
        holders = holders_of[v]
        client = P.BatchedPartialClient(
            session, v, "", lambda h=holders: h, stub_for,
            my_rack="rack0", my_dc="dc1",
            shard_size_hint=os.path.getsize(
                bases[v] + ecc.to_ext((v + 1) % ecc.TOTAL_SHARDS)))
        kw = {}
        if with_fallback:
            lost = v % ecc.TOTAL_SHARDS

            def fetch(sid, off, length, v=v, lost=lost):
                if sid == lost:
                    return None
                with open(bases[v] + ecc.to_ext(sid), "rb") as f:
                    f.seek(off)
                    return f.read(length)

            kw["remote_fetch"] = fetch
        rebuilt = rebuild_ec_files(rbase, codec_name="torch_cpu",
                                   slice_size=slice_size, partial=client,
                                   **kw)
        with open(rbase + ecc.to_ext(v % ecc.TOTAL_SHARDS), "rb") as f:
            results[v] = (rebuilt, hashlib.sha256(f.read()).hexdigest())

    with ThreadPoolExecutor(max_workers=len(vids)) as pool:
        list(pool.map(one, vids))
    for v in vids:
        rebuilt, got = results[v]
        assert rebuilt == [v % ecc.TOTAL_SHARDS], (v, rebuilt)
        assert got == digests[v], f"volume {v} differs from the reference's"


def test_batched_rebuild_byte_identity(tmp_path, multi_volume_fleet):
    """4 volumes rebuilt concurrently through one MassPartialSession:
    equal to the reference's shards, and the rack-group jobs coalesce
    into no more rpcs than jobs."""
    stub_for, holders_of, bases, digests = multi_volume_fleet
    session = P.MassPartialSession(stub_for)
    try:
        before = EC_PARTIAL_JOBS.labels("fetch", "ok").value
        _batched_rebuild(tmp_path, stub_for, holders_of, bases, digests,
                         session, [1, 2, 3, 4])
        assert EC_PARTIAL_JOBS.labels("fetch", "ok").value >= before + 4
        assert session.batched_jobs >= session.rpcs >= 1
    finally:
        session.close()


def test_batched_rebuild_multi_slice(tmp_path, multi_volume_fleet):
    """Shards larger than the slice: successive slices of one volume
    must not merge into one rpc, and output stays equal."""
    stub_for, holders_of, bases, digests = multi_volume_fleet
    session = P.MassPartialSession(stub_for)
    try:
        _batched_rebuild(tmp_path, stub_for, holders_of, bases, digests,
                         session, [1, 2], slice_size=257)
    finally:
        session.close()


def test_batch_source_death_falls_back_per_volume(tmp_path,
                                                  multi_volume_fleet):
    """The port's fault point repair.batch.source scoped to ONE volume's
    batch job: exactly that volume degrades to the full-fetch path
    (fallback counter +1), the rest ride the aggregated protocol, every
    output equal to the reference's."""
    stub_for, holders_of, bases, digests = multi_volume_fleet
    session = P.MassPartialSession(stub_for)
    faultpoint.set_fault("repair.batch.source", "error", match="vol=3")
    try:
        before_fb = EC_PARTIAL_FALLBACK.labels("rebuild").value
        _batched_rebuild(tmp_path, stub_for, holders_of, bases, digests,
                         session, [1, 2, 3, 4], with_fallback=True)
        assert EC_PARTIAL_FALLBACK.labels("rebuild").value == before_fb + 1
    finally:
        faultpoint.clear_fault("repair.batch.source")
        session.close()


def test_session_coalesces_waves():
    """While one rpc is in flight, queued jobs pile into the NEXT wave:
    a blocking first rpc forces jobs 2-4 into one batch rpc."""
    import numpy as np

    gate = threading.Event()
    first_started = threading.Event()
    batch_sizes = []

    class _Stub:
        def VolumeEcShardPartialApply(self, request):
            batch_sizes.append(len(request.batch))
            if len(batch_sizes) == 1:
                first_started.set()
                gate.wait(timeout=10)
            for job in request.batch:
                blob = bytes(job.row_count * job.size)
                yield type("R", (), {
                    "volume_id": job.volume_id, "data": blob,
                    "eof": False, "error": ""})()
                yield type("R", (), {
                    "volume_id": job.volume_id, "data": b"",
                    "eof": True, "error": ""})()

    session = P.MassPartialSession(lambda addr: _Stub())

    def job(vid):
        return {"volume_id": vid, "collection": "", "offset": 0,
                "size": 8, "row_count": 1, "shard_ids": [1],
                "coefficients": b"\x01", "delegates": []}

    try:
        f1 = session.submit("a:0", job(1))
        assert first_started.wait(timeout=10)
        fs = [session.submit("a:0", job(v)) for v in (2, 3, 4)]
        gate.set()
        assert isinstance(f1.result(timeout=10), np.ndarray)
        for f in fs:
            f.result(timeout=10)
        assert batch_sizes[0] == 1
        assert 3 in batch_sizes, batch_sizes  # jobs 2-4 rode one rpc
    finally:
        session.close()


# -- orchestrator over a topology snapshot --------------------------------


@pytest.fixture
def masters(tmp_path):
    """-> make(journal=True, pkgs=("port",)) -> {pkg: MasterServer}; the
    port's planes are stopped (threads joined) after the test."""
    made = []

    def make(journal=True, pkgs=("port",)):
        out = {}
        for pkg in pkgs:
            jd = ""
            if journal:
                jd = str(tmp_path / f"journal_{pkg}")
                os.makedirs(jd, exist_ok=True)
            out[pkg] = PKGS[pkg][0](ip="127.0.0.1", port=free_port(),
                                    volume_size_limit_mb=64,
                                    lifecycle_dir=jd)
        if "port" in out:
            made.append(out["port"])
        return out

    yield make
    for m in made:
        m.mass_repair.stop()
        m.lifecycle.stop()


def _bits(*sids):
    b = ShardBits(0)
    for s in sids:
        b = b.add(s)
    return b


def _register(ms: dict, node_id, rack, ec, volumes=()) -> dict:
    """ec: {vid: (shard_ids, shard_size)}, into every master given, each
    from its own package's DataNode; -> {pkg: node}."""
    out = {}
    for pkg, master in ms.items():
        _M, Node, Volume = PKGS[pkg]
        n = Node(id=node_id, public_url=node_id, grpc_address=node_id,
                 rack=rack, data_center="dc1", max_volumes=100)
        n.ec_shards = {vid: _bits(*sids) for vid, (sids, _sz) in ec.items()}
        n.ec_collections = {vid: "" for vid in ec}
        n.ec_shard_sizes = {vid: sz for vid, (_sids, sz) in ec.items()}
        n.volumes = {vid: Volume(volume_id=vid) for vid in volumes}
        master.topo.register_node(n)
        out[pkg] = n
    return out


def test_orchestrator_plan_ranks_and_spreads(masters):
    """Live-topology planning, equal to the reference's: the volume at
    the decode floor plans first, targets never exceed the cap,
    unrepairable volumes are reported, not planned."""
    ms = masters(journal=False, pkgs=("ref", "port"))
    _register(ms, "a:80", "r0", {1: (list(range(0, 7)), 100),
                                 2: (list(range(0, 5)), 999),
                                 3: (list(range(0, 5)), 5)})
    _register(ms, "b:80", "r1", {1: (list(range(7, 13)), 100),
                                 2: (list(range(5, 10)), 999),
                                 3: (list(range(5, 9)), 5)})
    plans = ms["port"].mass_repair.plan(dead_node="dead:80")
    assert plans == ms["ref"].mass_repair.plan(dead_node="dead:80")
    assert [p["volume_id"] for p in plans] == [2, 1]  # floor first
    assert plans[0]["surviving"] == 10
    assert plans[0]["shard_size"] == 999
    assert plans[0]["bytes"] == 4 * 999
    assert all(p["node"] in ("a:80", "b:80") for p in plans)
    assert ms["port"].mass_repair._counts["unrepairable"] == 1


@pytest.mark.parametrize("n_nodes,n_vols", [(3, 8), (4, 20)])
def test_orchestrator_plan_equal_on_a_dead_node_batch(masters, n_nodes,
                                                      n_vols):
    """A dead node's whole batch (every volume short the shards it held)
    plans alike in both packages: the same exposure order, the same
    targets under the same cap."""
    ms = masters(journal=False, pkgs=("ref", "port"))
    for i in range(n_nodes):
        ec = {}
        for v in range(1, n_vols + 1):
            sids = [s for s in range(14) if (s + v) % (n_nodes + 1) == i]
            if sids:
                ec[v] = (sids, 1000 * v)
        _register(ms, f"n{i}:80", f"r{i % 2}", ec)
    plans = ms["port"].mass_repair.plan(dead_node="dead:80")
    assert plans == ms["ref"].mass_repair.plan(dead_node="dead:80")
    assert plans


def test_volume_mid_encode_is_not_counted_lost(masters):
    """A volume mid-encode (its .dat still mounted, its shards still
    being copied and mounted) is neither planned nor counted lost at any
    shard count; the reference plans a rebuild at 12 shards and counts
    the 4-shard one lost.  Without a plain copy, the same shard maps
    plan and count alike in both."""
    ms = masters(journal=False, pkgs=("ref", "port"))
    _register(ms, "a:80", "r0", {5: (list(range(0, 4)), 64),
                                 6: (list(range(0, 4)), 64),
                                 7: (list(range(0, 7)), 64),
                                 8: (list(range(0, 7)), 64)},
              volumes=(5, 7))
    _register(ms, "b:80", "r1", {7: (list(range(7, 12)), 64),
                                 8: (list(range(7, 12)), 64)})
    port, ref = ms["port"].mass_repair, ms["ref"].mass_repair
    assert [p["volume_id"] for p in port.plan()] == [8]
    assert sorted(p["volume_id"] for p in ref.plan()) == [7, 8]
    assert port._counts["unrepairable"] == 1  # only 6
    assert ref._counts["unrepairable"] == 2


def test_orchestrator_journal_resume_exactly_once(masters):
    """Jobs journaled by a first master run (killed before execution)
    replay as pending in a second run and execute exactly once."""
    master1 = masters()["port"]
    _register({"port": master1}, "a:80", "r0", {1: (list(range(0, 7)), 64)})
    _register({"port": master1}, "b:80", "r1", {1: (list(range(7, 13)), 64)})
    accepted = master1.mass_repair.submit(master1.mass_repair.plan())
    assert len(accepted) == 1
    assert master1.mass_repair.pending()

    # "crash": a fresh master over the same journal dir
    master2 = PortMaster(ip="127.0.0.1", port=free_port(),
                         volume_size_limit_mb=64,
                         lifecycle_dir=master1.lifecycle.journal_dir)
    try:
        _register({"port": master2}, "a:80", "r0",
                  {1: (list(range(0, 7)), 64)})
        _register({"port": master2}, "b:80", "r1",
                  {1: (list(range(7, 13)), 64)})
        pending = master2.mass_repair.pending()
        assert [j["volume_id"] for j in pending] == [1]

        executed = []

        class _Stub:
            def VolumeEcShardsBatchRebuild(self, req):
                executed.extend(j.volume_id for j in req.jobs)
                resp = type("R", (), {})()
                resp.results = [type("J", (), {
                    "volume_id": j.volume_id, "rebuilt_shard_ids": [13],
                    "error": "", "used_partial": True})() for j in req.jobs]
                return resp

        master2.mass_repair._target_stub = lambda node: _Stub()
        before_ok = REPAIR_BATCH_JOBS.labels("ok").value
        master2.mass_repair.run_wave(master2.mass_repair.pending())
        assert executed == [1]
        assert not master2.mass_repair.pending()
        job = master2.mass_repair.journal.get("1:mass_repair")
        assert job["state"] == "done"
        assert REPAIR_BATCH_JOBS.labels("ok").value == before_ok + 1
        # a second wave over the drained queue re-runs nothing
        master2.mass_repair.run_wave(master2.mass_repair.pending())
        assert executed == [1]
    finally:
        master2.mass_repair.stop()
        master2.lifecycle.stop()


def test_orchestrator_failed_target_parks_after_attempts(masters):
    """An unreachable target fails the job (attempts preserved across
    resubmits) until MAX_ATTEMPTS parks it for an operator."""
    master = masters(journal=False)["port"]
    _register({"port": master}, "a:80", "r0", {1: (list(range(0, 7)), 64)})
    _register({"port": master}, "b:80", "r1", {1: (list(range(7, 13)), 64)})

    class _DeadStub:
        def VolumeEcShardsBatchRebuild(self, req):
            raise grpc.RpcError("unreachable")

    master.mass_repair._target_stub = lambda node: _DeadStub()
    for attempt in range(1, 4):
        accepted = master.mass_repair.submit(master.mass_repair.plan())
        assert accepted, f"attempt {attempt} not resubmitted"
        master.mass_repair.run_wave(master.mass_repair.pending())
        job = master.mass_repair.journal.get("1:mass_repair")
        assert job["attempts"] == attempt
    assert job["state"] == "parked"
    # parked: no more resubmission until an operator clears it
    assert master.mass_repair.submit(master.mass_repair.plan()) == []


def test_scrub_pass_skips_volume_under_mass_repair(masters):
    """Mutual exclusion, both directions, on the (volume, transition)
    journal key: a scrub finding on a volume with an active mass_repair
    job is skipped (stays queued), and the orchestrator skips a volume
    the scrub pass is currently healing."""
    master = masters(journal=False)["port"]
    _register({"port": master}, "a:80", "r0", {7: (list(range(0, 7)), 64)})
    _register({"port": master}, "b:80", "r1", {7: (list(range(7, 13)), 64)})

    accepted = master.mass_repair.submit(master.mass_repair.plan())
    assert [j["volume_id"] for j in accepted] == [7]

    finding = type("F", (), {
        "volume_id": 7, "kind": "needle", "shard_id": 0,
        "needle_id": 1, "detail": "crc", "detected_at_ms": 1})()
    master.record_scrub_findings("a:80", [finding])
    summary = master.repair_pass()
    key = ("a:80", 7, "needle", 0, 1)
    assert key in summary["skipped"]
    assert master.scrub_findings[key]["status"] == "pending"  # requeued

    # reverse: scrub pass mid-heal on volume 7 -> orchestrator defers
    master.lifecycle.journal.update("7:mass_repair", state="done")
    master._scrub_repairing.add(7)
    assert master.mass_repair.submit(master.mass_repair.plan()) == []
    master._scrub_repairing.clear()


def test_lifecycle_skips_volume_under_mass_repair(masters):
    """The shared journal's one-transition-per-volume rule keeps every
    lifecycle planner off a volume that mass repair holds, and the
    controller's executor never claims mass_repair jobs."""
    master = masters(journal=False)["port"]
    _register({"port": master}, "a:80", "r0", {9: (list(range(0, 7)), 64)})
    _register({"port": master}, "b:80", "r1", {9: (list(range(7, 13)), 64)})
    accepted = master.mass_repair.submit(master.mass_repair.plan())
    assert [j["volume_id"] for j in accepted] == [9]
    assert master.lifecycle.submit([{
        "key": "9:vacuum", "volume_id": 9, "transition": "vacuum",
        "collection": "", "node": "a:80", "holders": ["a:80"],
        "bytes": 0}]) == []
    assert master.lifecycle.run_pending(wait=True) == []
    assert master.mass_repair.pending()


def test_lifecycle_rpc_mass_repair_actions(masters):
    """The shell's surface, alike in both packages: mass_repair_status
    reports orchestrator state, mass_repair_plan dry-runs the
    exposure-ranked plan and journals nothing."""
    from seaweedfs_tpu.master.grpc_handlers import \
        MasterGrpcService as RefService
    from seaweedfs_tpu.pb import master_pb2 as ref_pb
    from seaweedfs_tpu_torch.master.grpc_handlers import MasterGrpcService

    ms = masters(journal=False, pkgs=("ref", "port"))
    _register(ms, "a:80", "r0", {4: (list(range(0, 7)), 64)})
    _register(ms, "b:80", "r1", {4: (list(range(7, 13)), 64)})
    docs = {}
    for pkg, svc, pb in (("ref", RefService(ms["ref"]), ref_pb),
                         ("port", MasterGrpcService(ms["port"]), master_pb2)):
        st = json.loads(svc.Lifecycle(pb.LifecycleRequest(
            action="mass_repair_status"), None).report)
        plan = json.loads(svc.Lifecycle(pb.LifecycleRequest(
            action="mass_repair_plan", node="dead:80"), None).report)
        st.pop("deadlineLeftSeconds")
        docs[pkg] = (st, plan)
    assert docs["port"] == docs["ref"]
    st, plan = docs["port"]
    assert st["enabled"] and st["pending"] == 0
    assert [p["volume_id"] for p in plan["planned"]] == [4]
    assert plan["planned"][0]["dead_node"] == "dead:80"
    assert ms["port"].mass_repair.pending() == []


def test_eager_cache_invalidation_registry(tmp_path):
    """Dead-node notice plumbing: every partial client / fetcher cache
    the port's volume server hands out is registered, and one call drops
    them all to force a fresh master lookup."""
    from seaweedfs_tpu_torch.volume.server import VolumeServer

    d = tmp_path / "v"
    d.mkdir()
    s = VolumeServer([str(d)], ["127.0.0.1:1"], ip="127.0.0.1",
                     port=free_port(), codec_name="cpu")
    try:
        client = s._make_partial_client(1)
        fetch = s._make_ec_fetcher(2)
        assert fetch is not None and client is not None
        now = time.monotonic()
        for c in s._loc_caches:
            c._fetched_at = now  # a fresh, trusted holder map
        assert len(list(s._loc_caches)) == 2
        assert s.invalidate_location_caches() == 2
        for c in s._loc_caches:
            assert c._fetched_at == float("-inf")
    finally:
        s.store.close()


def test_mass_repair_env_switches_and_defaults(monkeypatch):
    """The reference's environment switches under its names and with
    its defaults: on, no deadline, 4 target rpcs, 8 jobs per rpc, 600 s
    per rpc; SEAWEEDFS_TPU_MASS_REPAIR=0 turns it off."""
    for name in ("SEAWEEDFS_TPU_MASS_REPAIR",
                 "SEAWEEDFS_TPU_MASS_REPAIR_DEADLINE_S",
                 "SEAWEEDFS_TPU_MASS_REPAIR_TARGETS",
                 "SEAWEEDFS_TPU_MASS_REPAIR_JOBS_PER_RPC",
                 "SEAWEEDFS_TPU_MASS_REPAIR_RPC_TIMEOUT_S"):
        monkeypatch.delenv(name, raising=False)
    mr = PortMaster(ip="127.0.0.1", port=free_port()).mass_repair
    assert (mr.enabled, mr.deadline_s, mr.max_target_rpcs, mr.jobs_per_rpc,
            mr.rpc_timeout_s) == (True, 0.0, 4, 8, 600.0)
    monkeypatch.setenv("SEAWEEDFS_TPU_MASS_REPAIR", "0")
    monkeypatch.setenv("SEAWEEDFS_TPU_MASS_REPAIR_DEADLINE_S", "120")
    monkeypatch.setenv("SEAWEEDFS_TPU_MASS_REPAIR_JOBS_PER_RPC", "2")
    mr = PortMaster(ip="127.0.0.1", port=free_port()).mass_repair
    assert (mr.enabled, mr.deadline_s, mr.jobs_per_rpc) == (False, 120.0, 2)


def test_run_wave_chunks_jobs_per_rpc(masters):
    """A target's slice of the batch goes out in rpcs of at most
    jobs_per_rpc volumes, the most exposed first."""
    master = masters(journal=False)["port"]
    for v in range(1, 6):
        _register({"port": master}, f"a{v}:80", "r0",
                  {v: (list(range(0, 5 + v % 3)), 64)})
    _register({"port": master}, "b:80", "r1",
              {v: (list(range(8, 13)), 64) for v in range(1, 6)})
    master.mass_repair.jobs_per_rpc = 2
    accepted = master.mass_repair.submit(master.mass_repair.plan())
    for j in accepted:  # every job on one target
        master.mass_repair.journal.update(j["key"], node="b:80")
    calls = []

    class _Stub:
        def VolumeEcShardsBatchRebuild(self, req):
            calls.append([j.volume_id for j in req.jobs])
            resp = type("R", (), {})()
            resp.results = [type("J", (), {
                "volume_id": j.volume_id, "rebuilt_shard_ids": [13],
                "error": "", "used_partial": False})() for j in req.jobs]
            return resp

    master.mass_repair._target_stub = lambda node: _Stub()
    master.mass_repair.run_wave(master.mass_repair.pending())
    assert [len(c) for c in calls] == [2, 2, 1]
    surviving = {j["volume_id"]: j["surviving"] for j in accepted}
    order = [v for c in calls for v in c]
    assert [surviving[v] for v in order] == sorted(surviving.values())


def test_rate_floor_raises_the_pushed_budget(masters):
    """With a deadline, the orchestrator's floor is the bytes still
    queued over the time left; none without a deadline."""
    master = masters(journal=False)["port"]
    _register({"port": master}, "a:80", "r0",
              {1: (list(range(0, 7)), 64 << 20)})
    _register({"port": master}, "b:80", "r1",
              {1: (list(range(7, 12)), 64 << 20)})
    assert master.mass_repair.rate_floor_mbps() == 0.0
    master.mass_repair.deadline_s = 100.0
    master.mass_repair.submit(master.mass_repair.plan())
    floor = master.mass_repair.rate_floor_mbps()
    # 2 lost shards of 64 MiB over ~100 s
    assert 1.2 < floor < 1.4, floor


# -- proactive evacuation (failing-disk trigger) ---------------------------


def _set_disk_state(node, state):
    node.disk_health = {"/d": {"state": state, "free_bytes": 1,
                               "total_bytes": 2}}


def test_plan_evacuation_spreads_and_skips(masters):
    """EC shards on a failing node spread across healthy nodes by free
    EC slots, as the reference plans them; full/failing nodes are never
    targets; replicated volumes are not copied; sole-copy volumes are."""
    ms = masters(journal=False, pkgs=("ref", "port"))
    sick = _register(ms, "sick:80", "r0", {1: ([0, 1, 2], 64),
                                           2: ([5], 64)}, volumes=(7, 8))
    for n in sick.values():
        _set_disk_state(n, "failing")
    _register(ms, "a:80", "r0", {1: ([3, 4], 64)})
    _register(ms, "b:80", "r1", {}, volumes=(8,))
    for n in _register(ms, "full:80", "r1", {}).values():
        _set_disk_state(n, "full")
    moves = ms["port"].mass_repair.plan_evacuation("sick:80")
    assert moves == ms["ref"].mass_repair.plan_evacuation("sick:80")
    ec = [m for m in moves if m["kind"] == "ec_shard"]
    vols = [m for m in moves if m["kind"] == "volume"]
    assert sorted((m["volume_id"], m["shard_id"]) for m in ec) == [
        (1, 0), (1, 1), (1, 2), (2, 5)]
    assert all(m["target"] in ("a:80", "b:80") for m in moves), moves
    assert [m["volume_id"] for m in vols] == [7]


def test_on_disk_failing_rate_limited_and_executes(masters, monkeypatch):
    """The heartbeat-ingest trigger runs one evacuation per cooldown
    window and drives the per-move rpc helpers; stop() joins its
    thread."""
    master = masters(journal=False)["port"]
    sick = _register({"port": master}, "sick:80", "r0", {3: ([0, 1], 64)},
                     volumes=(9,))["port"]
    _set_disk_state(sick, "failing")
    _register({"port": master}, "a:80", "r0", {})

    done = []
    release = threading.Event()

    def ec_move(mv):
        done.append(("ec", mv["volume_id"], mv["shard_id"]))

    def vol_move(mv):
        done.append(("vol", mv["volume_id"]))
        release.set()

    monkeypatch.setattr(master.mass_repair, "_evacuate_ec_shard", ec_move)
    monkeypatch.setattr(master.mass_repair, "_evacuate_volume", vol_move)
    master.note_disk_health(sick)
    assert release.wait(timeout=10)
    master.mass_repair.stop()  # joins the evacuation thread
    assert sorted(done) == [("ec", 3, 0), ("ec", 3, 1), ("vol", 9)]
    assert master.mass_repair._counts["evacuated"] == 3
    assert not any(t.name.startswith("master-mass-repair-evacuate")
                   and t.is_alive() for t in threading.enumerate())
    # cooldown: an immediate re-trigger is a no-op
    done.clear()
    master.mass_repair._stop.clear()
    master.note_disk_health(sick)
    assert done == [] and not master.mass_repair._evacuating
