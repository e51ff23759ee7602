"""The port's partial-sum repair protocol (storage/ec/partial.py) against the
reference's, on the same inputs: source planning (locality, order, rack
groups), the coefficient wire layout, serve_partial's combined sums, the
rebuild through an in-process source fleet (byte identity for several loss
sets on the `cpu` and `torch_cpu` codecs, mixed local and remote sources,
the wire saving, the fallback when a source dies, the full fetch when it is
cheaper, the size probe, bad geometry refused) and the partial-sum degraded
read.  Volumes are written and encoded with the reference; the tolerance is
exact bytes throughout.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from seaweedfs_tpu.storage.ec import partial as RP
from seaweedfs_tpu.storage.ec.encoder import (
    generate_ec_files as ref_generate,
    write_sorted_file_from_idx as ref_sorted_index,
)
from seaweedfs_tpu.topology import placement as ref_placement
from seaweedfs_tpu_torch.ops.codec_service import CodecService
from seaweedfs_tpu_torch.stats.metrics import (
    EC_OP_HISTOGRAM,
    EC_PARTIAL_FALLBACK,
    EC_PARTIAL_JOBS,
    EC_REBUILD_BYTES,
)
from seaweedfs_tpu_torch.storage.ec import constants as ecc
from seaweedfs_tpu_torch.storage.ec import partial as P
from seaweedfs_tpu_torch.storage.ec.encoder import rebuild_ec_files
from seaweedfs_tpu_torch.storage.ec.volume import EcVolume
from seaweedfs_tpu_torch.topology import placement
from seaweedfs_tpu_torch.util import faultpoint

from helpers import make_volume
from torch_threads import one_torch_thread  # noqa: F401

LARGE = 10000
SMALL = 100

HOLDERS = [
    {0: ("n0", "r2", "d1"), 1: ("n1", "r1", "d1"), 2: ("n2", "r9", "d9"),
     3: ("n3", "r1", "d1")},
    {0: ("a", "r1", "d1"), 1: ("a", "r1", "d1"), 2: ("b", "r1", "d1"),
     3: ("c", "r2", "d1")},
    {s: (f"h{s % 3}", f"r{s % 2}", "d1" if s < 9 else "d2")
     for s in range(14)},
]


# -- planning, held against the reference's placement --------------------


@pytest.mark.parametrize("where", [("r1", "d1", "r1", "d1"),
                                   ("r2", "d1", "r1", "d1"),
                                   ("r1", "d2", "r1", "d1"),
                                   ("", "d1", "r1", "d1"),
                                   ("", "", "", "")])
def test_ec_source_locality_matches_reference(where):
    assert placement.ec_source_locality(*where) == \
        ref_placement.ec_source_locality(*where)


@pytest.mark.parametrize("holders", HOLDERS)
@pytest.mark.parametrize("me", [("r1", "d1"), ("r2", "d1"), ("", "")])
def test_order_best_holder_and_groups_match_reference(holders, me):
    assert placement.order_ec_sources(holders, *me) == \
        ref_placement.order_ec_sources(holders, *me)
    assert placement.group_partial_sources(holders) == \
        ref_placement.group_partial_sources(holders)
    cands = list(holders.values())
    assert placement.best_ec_holder(cands, *me) == \
        ref_placement.best_ec_holder(cands, *me)


def test_group_partial_sources_one_group_per_rack():
    groups = placement.group_partial_sources(HOLDERS[1])
    g1 = next(g for g in groups if g["rack"] == "r1")
    # the aggregator holds the most shards; the single-shard member delegates
    assert g1["aggregator"] == "a"
    assert g1["members"] == {"a": [0, 1], "b": [2]}


def test_pack_coefficients_layout_matches_reference():
    rng = np.random.default_rng(1)
    coef = {s: rng.integers(0, 256, 4, dtype=np.uint8) for s in (3, 7, 11)}
    for order in ([3, 7], [11, 3, 7], [7]):
        assert P.pack_coefficients(coef, order) == \
            RP.pack_coefficients(coef, order)
    two = {3: np.array([1, 2], np.uint8), 7: np.array([5, 6], np.uint8)}
    assert P.pack_coefficients(two, [3, 7]) == bytes([1, 5, 2, 6])


# -- fixtures -------------------------------------------------------------


@pytest.fixture(scope="module")
def encoded_base(tmp_path_factory):
    """A reference volume encoded by the reference (small blocks)."""
    d = tmp_path_factory.mktemp("partial")
    vol = make_volume(str(d), n_needles=60, seed=33, max_size=3000)
    base = vol.file_name()
    vol.close()
    ref_generate(base, large_block_size=LARGE, small_block_size=SMALL,
                 codec_name="cpu", slice_size=1 << 20)
    ref_sorted_index(base)
    return base


def _shard_bytes(base):
    out = {}
    for i in range(ecc.TOTAL_SHARDS):
        with open(base + ecc.to_ext(i), "rb") as f:
            out[i] = f.read()
    return out


def _fleet(mod, base, absent, rack_of=lambda sid: f"rack{sid % 2}",
           served_by=None):
    """One fake node per shard not in `absent`, served by the
    local_source_network of `served_by` (default `mod`); -> `mod`'s
    PartialRepairClient over it."""
    nodes, holders = {}, {}
    for sid in range(ecc.TOTAL_SHARDS):
        if sid in absent:
            continue
        addr = f"src-{sid}:0"
        nodes[addr] = (base, [sid])
        holders[sid] = [(addr, rack_of(sid), "dc1")]
    return mod.PartialRepairClient(
        1, "", lambda: holders,
        (served_by or mod).local_source_network(nodes),
        my_rack="rack0", my_dc="dc1")


def _full_fetch(base, lost):
    def fetch(sid, off, length):
        if sid in lost:
            return None
        with open(base + ecc.to_ext(sid), "rb") as f:
            f.seek(off)
            return f.read(length)

    return fetch


def _request(pb, coef: np.ndarray, sids, offset, size, delegates=()):
    req = pb.VolumeEcShardPartialApplyRequest(
        volume_id=1, offset=offset, size=size, row_count=coef.shape[0],
        shard_ids=list(sids), coefficients=coef.tobytes())
    for addr, dsids, dcoef in delegates:
        req.delegates.add(grpc_address=addr, shard_ids=dsids,
                          coefficients=dcoef)
    return req


# -- the source side ------------------------------------------------------


@pytest.mark.parametrize("rows,sids,offset,size", [
    (1, [0], 0, 100), (4, [1, 2, 3, 4, 5], 37, 1000),
    (2, list(range(10)), 999, 3001)])
def test_serve_partial_matches_reference(encoded_base, rows, sids, offset,
                                         size):
    """The same request served by both packages' serve_partial: the same
    (rows, size) GF(2^8) sums, with and without a delegate fleet."""
    from seaweedfs_tpu.pb import volume_server_pb2 as ref_vs
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs

    coef = np.random.default_rng(rows).integers(
        0, 256, (rows, len(sids)), dtype=np.uint8)
    read = _full_fetch(encoded_base, set())
    got = P.serve_partial(_request(vs, coef, sids, offset, size), read)
    want = RP.serve_partial(_request(ref_vs, coef, sids, offset, size), read)
    assert got.tobytes() == want.tobytes()
    # half the shards through a delegate of each package's own fleet
    half = sids[: len(sids) // 2] or sids
    rest = [s for s in sids if s not in half]
    nodes = {"d:0": (encoded_base, rest)}
    dcoef = coef[:, len(half):].copy().tobytes()
    dl = [("d:0", rest, dcoef)] if rest else []
    got2 = P.serve_partial(
        _request(vs, coef[:, :len(half)].copy(), half, offset, size, dl),
        read, stub_for=P.local_source_network(nodes))
    want2 = RP.serve_partial(
        _request(ref_vs, coef[:, :len(half)].copy(), half, offset, size, dl),
        read, stub_for=RP.local_source_network(nodes))
    assert got2.tobytes() == want2.tobytes() == got.tobytes()


def test_serve_partial_rejects_bad_geometry():
    req = SimpleNamespace(row_count=2, shard_ids=[1], coefficients=b"\x01",
                          size=10, offset=0, delegates=[], volume_id=1,
                          collection="")
    with pytest.raises(ValueError):
        P.serve_partial(req, lambda sid, off, ln: b"\0" * ln)
    # a missing local shard must fail the serve, not zero-fill it
    req2 = SimpleNamespace(row_count=1, shard_ids=[1],
                           coefficients=b"\x01", size=10, offset=0,
                           delegates=[], volume_id=1, collection="")
    with pytest.raises(IOError):
        P.serve_partial(req2, lambda sid, off, ln: None)


def test_probe_answers_shard_size(encoded_base):
    size = os.path.getsize(encoded_base + ecc.to_ext(1))
    assert _fleet(P, encoded_base, {0}).shard_size() == size \
        == _fleet(RP, encoded_base, {0}).shard_size()


# -- the rebuilder side ---------------------------------------------------

LOSS_PATTERNS = [(0,), (13,), (0, 1, 2, 3), (10, 11, 12, 13), (2, 7, 11, 13)]


@pytest.mark.parametrize("lost", LOSS_PATTERNS)
@pytest.mark.parametrize("codec_name", ["cpu", "torch_cpu"])
def test_partial_rebuild_byte_identity(encoded_base, tmp_path, lost,
                                       codec_name):
    """All 10 sources remote: the port's rebuild through the aggregated
    partials reproduces the reference encoder's shards exactly."""
    originals = _shard_bytes(encoded_base)
    rbase = str(tmp_path / "1")
    rebuilt = rebuild_ec_files(
        rbase, codec_name=codec_name, slice_size=1000,
        remote_fetch=_full_fetch(encoded_base, set(lost)),
        partial=_fleet(P, encoded_base, set(lost)))
    assert sorted(rebuilt) == sorted(lost)
    for sid in lost:
        with open(rbase + ecc.to_ext(sid), "rb") as f:
            assert f.read() == originals[sid], f"shard {sid} differs"


@pytest.mark.parametrize("local,lost", [((0, 1, 3, 4, 5), (2,)),
                                        ((4, 5, 6, 7, 8), (0, 13))])
@pytest.mark.parametrize("served_by", [P, RP], ids=["port_fleet",
                                                    "reference_fleet"])
def test_partial_rebuild_with_local_sources(encoded_base, tmp_path, local,
                                            lost, served_by):
    """Mixed sourcing: the local shards' plan columns are applied here,
    the remote ones arrive as partials from a fleet of either package —
    the identity block of the port's slice closes the GF sum."""
    originals = _shard_bytes(encoded_base)
    rbase = str(tmp_path / "1")
    for sid in local:
        os.link(encoded_base + ecc.to_ext(sid), rbase + ecc.to_ext(sid))
    before = EC_PARTIAL_JOBS.labels("fetch", "ok").value
    rebuilt = rebuild_ec_files(
        rbase, codec_name="torch_cpu", slice_size=1000,
        remote_fetch=_full_fetch(encoded_base, set(lost)),
        partial=_fleet(P, encoded_base, set(lost) | set(local),
                       served_by=served_by))
    assert rebuilt == sorted(lost)
    for sid in lost:
        with open(rbase + ecc.to_ext(sid), "rb") as f:
            assert f.read() == originals[sid]
    assert EC_PARTIAL_JOBS.labels("fetch", "ok").value > before


def test_partial_rebuild_wire_reduction_counters(encoded_base, tmp_path):
    """One lost shard, all 10 sources remote on 2 racks: the partial path
    pulls 2 x shard_size (one partial per rack) against 10 x shard_size
    for full fetches, in the locality-labelled rebuild counters."""
    lost = {0}
    shard_size = os.path.getsize(encoded_base + ecc.to_ext(1))

    def leg(name, **kw):
        rdir = tmp_path / name
        rdir.mkdir()
        before = {lab: EC_REBUILD_BYTES.labels(lab).value
                  for lab in ("local", "rack", "dc")}
        rebuilt = rebuild_ec_files(
            str(rdir / "1"), codec_name="cpu", slice_size=1000,
            shard_size=shard_size, **kw)
        assert rebuilt == [0]
        return {lab: EC_REBUILD_BYTES.labels(lab).value - before[lab]
                for lab in ("local", "rack", "dc")}

    fetch = _full_fetch(encoded_base, lost)
    fetch.locality_of = lambda sid: "rack" if sid % 2 == 0 else "dc"
    full = leg("full", remote_fetch=fetch)
    part = leg("partial", remote_fetch=_full_fetch(encoded_base, lost),
               partial=_fleet(P, encoded_base, lost))
    assert full["rack"] + full["dc"] == 10 * shard_size
    assert part["rack"] == shard_size and part["dc"] == shard_size


def test_partial_source_death_falls_back_clean(encoded_base, tmp_path):
    """faultpoint ec.partial.apply kills one source mid-protocol: the
    rebuild degrades to full fetches in place (one fallback counted),
    byte-identical; with no full-fetch transport it fails cleanly and no
    partial .ecNN survives."""
    originals = _shard_bytes(encoded_base)
    lost = {0, 13}
    rbase = str(tmp_path / "1")
    faultpoint.set_fault("ec.partial.apply", "error", match="src-1:0")
    try:
        before = EC_PARTIAL_FALLBACK.labels("rebuild").value
        rebuilt = rebuild_ec_files(
            rbase, codec_name="cpu", slice_size=1000,
            remote_fetch=_full_fetch(encoded_base, lost),
            partial=_fleet(P, encoded_base, lost,
                           rack_of=lambda sid: "rack0"))
        assert sorted(rebuilt) == sorted(lost)
        assert EC_PARTIAL_FALLBACK.labels("rebuild").value == before + 1
        for sid in lost:
            with open(rbase + ecc.to_ext(sid), "rb") as f:
                assert f.read() == originals[sid]
    finally:
        faultpoint.clear_fault("ec.partial.apply")
    rdir2 = tmp_path / "fb2"
    rdir2.mkdir()
    rbase2 = str(rdir2 / "1")
    faultpoint.set_fault("ec.partial.apply", "error")
    try:
        with pytest.raises((IOError, ValueError)):
            rebuild_ec_files(
                rbase2, codec_name="cpu", slice_size=1000,
                partial=_fleet(P, encoded_base, lost,
                               rack_of=lambda sid: "rack0"))
        for sid in lost:
            assert not os.path.exists(rbase2 + ecc.to_ext(sid))
    finally:
        faultpoint.clear_fault("ec.partial.apply")


@pytest.mark.parametrize("route", ["direct", "service"])
def test_partial_fallback_stays_on_the_rebuild_codec(encoded_base, tmp_path,
                                                     route):
    """The partial source dies after the first slice: the rest of the
    rebuild takes full fetches, and their remote term runs on the
    rebuild's own codec (`torch_cpu`, or its codec service), never on the
    host codec: the `cpu` codec's apply_rows count does not move after the
    fallback.  Byte-identical."""
    originals = _shard_bytes(encoded_base)
    lost, local = (0, 13), (1, 2, 3, 4, 5)
    rbase = str(tmp_path / "1")
    for sid in local:
        os.link(encoded_base + ecc.to_ext(sid), rbase + ecc.to_ext(sid))
    shard_size = os.path.getsize(encoded_base + ecc.to_ext(1))
    n_slices = -(-shard_size // 1000)
    assert n_slices >= 3
    client = _fleet(P, encoded_base, set(lost) | set(local),
                    rack_of=lambda sid: "rack0")
    fetch, calls, host_after_first = client.fetch, [0], []
    host = EC_OP_HISTOGRAM.labels("apply_rows", "cpu")
    mine = EC_OP_HISTOGRAM.labels("apply_rows", "torch_cpu")

    def dying(*args, **kwargs):
        calls[0] += 1
        if calls[0] > 1:
            host_after_first.append(host.count)
            raise IOError("partial source died")
        return fetch(*args, **kwargs)

    client.fetch = dying
    service, shapes = None, []
    if route == "service":
        service = CodecService(mode="device", codec_name="torch_cpu",
                               device="cpu")
        submit = service.submit_apply

        def spy(rows, inputs, out=None):
            shapes.append(np.asarray(rows).shape)
            return submit(rows, inputs, out)

        service.submit_apply = spy
    before = (EC_PARTIAL_FALLBACK.labels("rebuild").value, mine.count)
    try:
        rebuilt = rebuild_ec_files(
            rbase, codec_name="torch_cpu", slice_size=1000,
            remote_fetch=_full_fetch(encoded_base, set(lost) | set(local)),
            partial=client, service=service)
    finally:
        if service is not None:
            service.close()
    assert rebuilt == list(lost)
    for sid in lost:
        with open(rbase + ecc.to_ext(sid), "rb") as f:
            assert f.read() == originals[sid]
    assert EC_PARTIAL_FALLBACK.labels("rebuild").value == before[0] + 1
    assert calls[0] == 2 and host.count == host_after_first[0]
    # one remote term (2 lost x 5 remote sources) per slice after the first
    if route == "direct":
        assert mine.count == before[1] + n_slices - 1
    else:
        assert shapes.count((2, 5)) == n_slices - 1
        assert shapes.count((2, 7)) == n_slices


def test_partial_skipped_when_full_fetch_is_cheaper(encoded_base, tmp_path):
    """4 lost shards against 3 remote sources: partials would pull more
    than full fetches, so the rebuild takes full fetches outright."""
    originals = _shard_bytes(encoded_base)
    lost = (0, 1, 2, 3)
    local = (4, 5, 6, 7, 8, 9, 13)
    rbase = str(tmp_path / "1")
    for sid in local:
        os.link(encoded_base + ecc.to_ext(sid), rbase + ecc.to_ext(sid))
    client = _fleet(P, encoded_base, set(lost) | set(local))
    ref_client = _fleet(RP, encoded_base, set(lost) | set(local))
    assert client.ingress_advantage([10, 11, 12], 4) == \
        ref_client.ingress_advantage([10, 11, 12], 4) < 1.0
    fetched_ok = EC_PARTIAL_JOBS.labels("fetch", "ok").value
    rebuilt = rebuild_ec_files(
        rbase, codec_name="cpu", slice_size=1000,
        remote_fetch=_full_fetch(encoded_base, set(lost)), partial=client)
    assert sorted(rebuilt) == sorted(lost)
    assert EC_PARTIAL_JOBS.labels("fetch", "ok").value == fetched_ok
    for sid in lost:
        with open(rbase + ecc.to_ext(sid), "rb") as f:
            assert f.read() == originals[sid]


# -- degraded reads -------------------------------------------------------


@pytest.fixture()
def degraded_volume(tmp_path):
    """Shard 0 lost cluster-wide, 1-7 on peers (a second directory), 8-13
    local; -> (base, peer base, {needle id: data})."""
    vol = make_volume(str(tmp_path), n_needles=30, seed=5)
    vol.sync()
    base = vol.file_name()
    ref_generate(base, large_block_size=LARGE, small_block_size=SMALL)
    ref_sorted_index(base)
    wants = {i: bytes(vol.read_needle(i).data) for i in range(1, 31)}
    vol.close()
    peer = tmp_path / "peer"
    peer.mkdir()
    pbase = str(peer / "1")
    for sid in range(ecc.TOTAL_SHARDS):
        os.link(base + ecc.to_ext(sid), pbase + ecc.to_ext(sid))
    for sid in range(0, 8):
        os.remove(base + ecc.to_ext(sid))
    return base, pbase, wants


@pytest.mark.parametrize("codec_name", ["cpu", "torch_cpu"])
def test_degraded_read_partial_byte_identity(degraded_volume, codec_name):
    """Needles with intervals on the lost shard decode from one 1 x W
    partial per rack, equal to the reference volume's needles."""
    base, pbase, wants = degraded_volume
    nodes, holders = {}, {}
    for sid in range(1, 8):
        nodes[f"deg-{sid}:0"] = (pbase, [sid])
        holders[sid] = [(f"deg-{sid}:0", f"rack{sid % 2}", "dc1")]
    ev = EcVolume(base, 1, codec_name=codec_name, large_block_size=LARGE,
                  small_block_size=SMALL)
    try:
        ev.partial_client = P.PartialRepairClient(
            1, "", lambda: holders, P.local_source_network(nodes),
            my_rack="rack0", my_dc="dc1")
        before = EC_PARTIAL_JOBS.labels("fetch", "ok").value
        for i, want in wants.items():
            assert bytes(ev.read_needle(i).data) == want, f"needle {i}"
        assert EC_PARTIAL_JOBS.labels("fetch", "ok").value > before
    finally:
        ev.close()


def test_degraded_read_partial_falls_back(degraded_volume):
    """A dead partial client must not fail the read — the gather path
    serves it and the degraded fallback counter moves."""
    base, pbase, wants = degraded_volume

    class Dead:
        def remote_shards(self):
            raise IOError("master unreachable")

    ev = EcVolume(base, 1, codec_name="cpu", large_block_size=LARGE,
                  small_block_size=SMALL)
    try:
        ev.partial_client = Dead()
        ev.remote_fetch = _full_fetch(pbase, {0})
        before = EC_PARTIAL_FALLBACK.labels("degraded").value
        for i, want in wants.items():
            assert bytes(ev.read_needle(i).data) == want
        assert EC_PARTIAL_FALLBACK.labels("degraded").value > before
    finally:
        ev.close()
