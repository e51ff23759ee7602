"""The port's codec registry, its host SIMD codec and its tracing, held
against the reference on the CPU.

`cpu` (the native SIMD library) and `torch_cpu` (the kernel's plain PyTorch
version) must give the reference codecs' bytes: known answers, parity,
every reconstruct entry.  `InstrumentedCodec` must record the reference's
metric families with the port's impl labels, and open spans only inside a
trace.  Without a card, `effective_codec("cuda")` degrades to `cpu` with a
reason while `get_codec("cuda")` raises.  Inputs are seeded; comparisons
are byte equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops.rs_cpu import ReedSolomon as RefRS
from seaweedfs_tpu_torch.ops import codec as pcodec
from seaweedfs_tpu_torch.ops import codec_service, device_probe
from seaweedfs_tpu_torch.ops.codec import (
    InstrumentedCodec,
    available_codecs,
    effective_codec,
    get_codec,
)
from seaweedfs_tpu_torch.stats.metrics import (
    EC_BYTES_HISTOGRAM,
    EC_OP_HISTOGRAM,
    REGISTRY,
)
from seaweedfs_tpu_torch.telemetry import trace

from test_rs_known_answers import KAT_AFFINE_PARITY
from torch_threads import one_torch_thread  # noqa: F401

HOST_CODECS = ("cpu", "torch_cpu")
no_card = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="this host has a CUDA card")


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    codec_service.shutdown_all(timeout=10)
    device_probe.reset_cache()
    pcodec._AUTO_CHOICE.clear()
    trace.TRACER.clear()


def _stripe(rng, width):
    shards = [rng.integers(0, 256, width, dtype=np.uint8) for _ in range(10)]
    return shards + [np.zeros(width, dtype=np.uint8) for _ in range(4)]


@pytest.mark.parametrize("name", HOST_CODECS)
def test_every_codec_matches_kat(name):
    """The pinned parity bytes (tests/test_rs_known_answers.py) from the
    port's host codecs; `cuda` joins available_codecs() on a card."""
    assert name in available_codecs()
    d = np.fromfunction(lambda i, j: (i * 31 + j * 7 + 1) % 256, (10, 16))
    par = np.asarray(get_codec(name).parity_of(d.astype(np.uint8)))
    assert par.tolist() == KAT_AFFINE_PARITY, f"codec {name} drifted"


@pytest.mark.parametrize("name", HOST_CODECS)
@pytest.mark.parametrize("width", [1, 31, 33, 4096 + 7])
def test_host_codecs_equal_reference_cpu(name, width):
    rng = np.random.default_rng(width)
    ref = RefRS()
    codec = get_codec(name)
    shards = _stripe(rng, width)
    want = [s.copy() for s in shards]
    ref.encode(want)
    got = [s.copy() for s in shards]
    codec.encode(got)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert codec.verify(want)
    for lost in ((0,), (0, 1, 2, 3), (2, 5, 11, 13), (10, 11, 12, 13)):
        broken = [None if i in lost else s for i, s in enumerate(want)]
        for entry in ("reconstruct", "reconstruct_data"):
            r = getattr(codec, entry)(list(broken))
            e = getattr(ref, entry)(list(broken))
            for i in range(14):
                if e[i] is None:
                    assert r[i] is None
                else:
                    assert np.array_equal(np.asarray(r[i]), e[i]), (entry, i)
        if name == "cpu":
            for sid in lost:
                assert np.array_equal(codec.reconstruct_one(broken, sid),
                                      ref.reconstruct_one(broken, sid))
    rows = np.asarray(rng.integers(0, 256, (3, 10)), dtype=np.uint8)
    if name == "cpu":
        assert all(np.array_equal(a, b) for a, b in zip(
            codec.apply_rows(rows, want[:10]), ref.apply_rows(rows, want[:10])))
        outs = [np.empty(width, np.uint8) for _ in range(4)]
        codec.parity_into(want[:10], outs)
        assert all(np.array_equal(o, w) for o, w in zip(outs, want[10:]))


def test_random_10_of_14_reconstruct_stripes():
    """A stripe rebuilt from 10 random survivors, on both host codecs,
    equals the lost bytes."""
    rng = np.random.default_rng(4)
    want = _stripe(rng, 333)
    RefRS().encode(want)
    for name in HOST_CODECS:
        codec = get_codec(name)
        for _ in range(20):
            sid = int(rng.integers(0, 14))
            others = [i for i in range(14) if i != sid]
            chosen = set(int(i) for i in rng.choice(others, 10, replace=False))
            shards = [want[i] if i in chosen else None for i in range(14)]
            rebuilt = codec.reconstruct(shards)
            assert np.array_equal(np.asarray(rebuilt[sid]), want[sid])


def test_instrumented_codec_records_op_impl_bytes():
    """The reference's families, one child per (op, impl); bytes as the
    reference counts them (the payload, or the rows for apply_rows)."""
    rng = np.random.default_rng(1)
    for name in HOST_CODECS:
        codec = get_codec(name)
        assert isinstance(codec, InstrumentedCodec) and codec._impl == name
        shards = _stripe(rng, 512)
        counts = {op: EC_OP_HISTOGRAM.labels(op, name).count
                  for op in ("encode", "reconstruct", "apply_rows")}
        sums = {op: EC_BYTES_HISTOGRAM.labels(op, name).total
                for op in ("encode", "reconstruct", "apply_rows")}
        codec.encode(shards)
        broken = list(shards)
        broken[2] = broken[11] = None
        rec = codec.reconstruct(broken)
        assert np.array_equal(np.asarray(rec[2]), shards[2])
        if name == "cpu":
            codec.apply_rows(np.ones((1, 10), np.uint8), shards[:10])
        for op in ("encode", "reconstruct"):
            assert EC_OP_HISTOGRAM.labels(op, name).count == counts[op] + 1
        assert EC_BYTES_HISTOGRAM.labels("encode", name).total \
            == sums["encode"] + 14 * 512
        assert EC_BYTES_HISTOGRAM.labels("reconstruct", name).total \
            == sums["reconstruct"] + 12 * 512
        if name == "cpu":
            assert EC_BYTES_HISTOGRAM.labels("apply_rows", name).total \
                == sums["apply_rows"] + 10 * 512
        # the untimed attributes pass through
        assert codec.data_shards == 10 and codec.matrix.shape == (14, 10)
        text = REGISTRY.render(["seaweedfs_ec_op_"])
        for op in ("encode", "reconstruct"):
            assert f'seaweedfs_ec_op_seconds_count{{op="{op}",impl="{name}"}}' \
                in text
            assert f'seaweedfs_ec_op_bytes_count{{op="{op}",impl="{name}"}}' \
                in text


def test_codec_spans_only_inside_a_trace():
    rng = np.random.default_rng(2)
    shards = _stripe(rng, 256)
    codec = get_codec("torch_cpu")
    trace.TRACER.clear()
    codec.encode([s.copy() for s in shards])
    assert trace.TRACER.spans() == []  # outside any trace: metrics only
    RefRS().encode(shards)
    broken = [None if i < 4 else s for i, s in enumerate(shards)]
    with trace.start_span("test.read") as root:
        rec = codec.reconstruct(broken)
        assert trace.current_trace_id() == root.trace_id
    assert np.array_equal(np.asarray(rec[0]), shards[0])
    spans = {s.name: s for s in trace.TRACER.spans()}
    for name in ("ec.reconstruct", "ec.device_put", "ec.device_compute",
                 "ec.device_get"):
        assert name in spans, name
        assert spans[name].trace_id == root.trace_id
        assert spans[name].attrs["impl"] == "torch_cpu"
    assert spans["ec.reconstruct"].parent_id == root.span_id
    assert spans["ec.device_compute"].parent_id \
        == spans["ec.reconstruct"].span_id
    assert spans["ec.reconstruct"].attrs["bytes"] == 10 * 256
    assert trace.current_context() is None
    assert spans["test.read"].span_id == root.span_id


@no_card
def test_get_codec_degrades_to_cpu_when_probe_fails():
    """The port's form of tests/test_codec_service.py's: the probe fails,
    effective_codec answers cpu with the reason, get_codec("cuda") still
    raises (no silent switch), and the answer a caller acts on builds the
    host SIMD codec."""
    device_probe.reset_cache()
    device_probe.probe(timeout_s=0.001, refresh=True)  # poison the cache
    name, reason = effective_codec("cuda")
    assert name == "cpu" and "timed out" in reason
    with pytest.raises(RuntimeError, match="CUDA"):
        get_codec("cuda")
    assert get_codec(name)._impl == "cpu"
    for host in HOST_CODECS:  # host names pass through untouched
        assert effective_codec(host) == (host, "")


@no_card
def test_effective_codec_without_a_card():
    device_probe.reset_cache()
    name, reason = effective_codec("cuda")
    assert name == "cpu" and reason  # the probe answers: no accelerator
    assert "cuda" not in available_codecs()


def test_auto_codec_resolves():
    """`auto` picks cpu on a host without a card (probe first, no timing
    subprocess) and gives the reference's parity; the choice is cached."""
    codec = get_codec("auto")
    data = np.arange(10 * 64, dtype=np.uint8).reshape(10, 64)
    ref = RefRS().parity_of(data)
    assert np.array_equal(np.asarray(codec.parity_of(data)), ref)
    if not torch.cuda.is_available():
        assert codec._impl == "cpu"
        assert pcodec.AUTO_TIMES["choice"] == "cpu"
        assert pcodec.AUTO_TIMES["cuda_s"] is None
    assert pcodec._AUTO_CHOICE == [codec._impl]
    assert get_codec("auto")._impl == codec._impl


def test_unknown_codec_raises():
    with pytest.raises(ValueError, match="unknown ec codec"):
        get_codec("tpu")


def test_service_host_mode_runs_the_native_cpu_codec(monkeypatch):
    """Host mode computes on the native library (the reference's host mode
    runs its SIMD codec), not on the kernel's plain version."""
    from seaweedfs_tpu_torch.ops import rs_cuda

    calls = {"native": 0}
    inner = codec_service.native.gf_apply_fast

    def counting(*a, **kw):
        calls["native"] += 1
        return inner(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("host mode ran the plain torch version")

    monkeypatch.setattr(codec_service.native, "gf_apply_fast", counting)
    monkeypatch.setattr(rs_cuda, "gf_apply_reference", refuse)
    rng = np.random.default_rng(3)
    svc = codec_service.get_service("torch_cpu")
    assert svc.mode == "host" and svc.codec_name == "cpu"
    try:
        blocks = [rng.integers(0, 256, (10, w), dtype=np.uint8)
                  for w in (5, 1000, 70000)]
        futs = svc.submit_parity_many(blocks)
        for b, f in zip(blocks, futs):
            assert np.array_equal(np.asarray(f.result(30)),
                                  RefRS().parity_of(b))
    finally:
        svc.close()
    assert calls["native"] >= 1
