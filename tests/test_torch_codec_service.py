"""The port's codec service and device probe held against the JAX package,
on the CPU.

One test for each of tests/test_codec_service.py's.  The same seeded numpy inputs go
through the reference CodecService (host mode, and device mode on the
virtual cpu-jax mesh as its own tests run it) and through the port's
service in host mode and in device mode on CPU tensors
(`mode="device", device="cpu"`: the same batching, per-job upload into
one block and batched dispatch as on the card, through the kernel's plain
version).  GF
arithmetic is exact, so every comparison is byte equality.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import codec_service as ref_service
from seaweedfs_tpu.ops import device_probe as ref_probe
from seaweedfs_tpu.ops import gf256 as jgf
from seaweedfs_tpu.ops.rs_cpu import ReedSolomon
from seaweedfs_tpu_torch.ops import codec_service, device_probe
from seaweedfs_tpu_torch.ops.codec import DEVICE_CODEC_NAMES, get_codec
from seaweedfs_tpu_torch.ops.codec_service import CodecService
from seaweedfs_tpu_torch.stats.metrics import (
    EC_SERVICE_BATCH_JOBS,
    EC_SERVICE_STAGE,
)
from seaweedfs_tpu_torch.storage.ec import encoder as tenc
from seaweedfs_tpu_torch.storage.ec.constants import TOTAL_SHARDS, to_ext

from helpers import make_volume
from torch_threads import one_torch_thread  # noqa: F401

# the port's service: host mode, and device mode on CPU tensors
MODES = [pytest.param(("host", None), id="host"),
         pytest.param(("device", "cpu"), id="device-cpu")]


def _svc(mode, **kw) -> CodecService:
    return CodecService(mode=mode[0], device=mode[1], **kw)


@pytest.fixture(autouse=True)
def _clean_service_state():
    yield
    codec_service.shutdown_all(timeout=10)
    device_probe.reset_cache()
    ref_service.shutdown_all(timeout=10)
    ref_probe.reset_cache()


def _rand_block(rng, width):
    return rng.integers(0, 256, (10, width), dtype=np.uint8)


def _as2d(result):
    return np.stack([np.asarray(r) for r in result])


def _ref_results(submit_many, *args):
    """Results of the reference host-mode service for the same jobs."""
    svc = ref_service.CodecService(mode="host")
    try:
        return [_as2d(f.result(60)) for f in
                submit_many(svc)(*args)]
    finally:
        svc.close()


def _plan(lost):
    present = [i for i in range(14) if i not in lost]
    return jgf.decode_plan_for(jgf.rs_matrix(10, 14), 10, present, lost)


# -- device probe -----------------------------------------------------------


def test_probe_ok_on_this_host_and_cached(monkeypatch):
    device_probe.reset_cache()
    pr = device_probe.probe(timeout_s=120)
    assert pr.ok and pr.devices >= 1
    assert pr.platform == ("cuda" if torch.cuda.is_available() else "cpu")
    assert pr.accelerator == torch.cuda.is_available()
    # cpu-jax answers the reference probe the same way: ok, no accelerator
    ref = ref_probe.probe(timeout_s=120, refresh=True)
    assert ref.ok and not ref.accelerator
    if not torch.cuda.is_available():
        assert pr.accelerator == ref.accelerator

    # second call must come from the cache — a subprocess here would fail
    def boom(*a, **k):
        raise AssertionError("probe re-ran despite cache")

    monkeypatch.setattr(subprocess, "run", boom)
    assert device_probe.probe() is pr


def test_probe_hard_deadline_reports_unreachable():
    device_probe.reset_cache()
    pr = device_probe.probe(timeout_s=0.001, refresh=True)
    assert not pr.ok and not pr.accelerator
    assert "timed out" in pr.error
    assert pr.seconds < 5.0
    assert pr.to_json()["error"] == pr.error


def test_failed_probe_degrades_auto_service_not_the_cuda_codec():
    """The reference's get_codec("tpu") degrades to cpu on a failed probe;
    the port's explicit `cuda` codec never falls back — only the service's
    `auto` mode does, and it records why."""
    device_probe.reset_cache()
    device_probe.probe(timeout_s=0.001, refresh=True)  # poison the cache
    svc = CodecService(mode="auto", codec_name="cuda")
    assert svc.mode == "host" and "timed out" in svc.fallback_reason
    svc.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            get_codec("cuda")


def test_device_codec_names_gate_the_probe(monkeypatch):
    from seaweedfs_tpu.ops.codec import effective_codec

    assert DEVICE_CODEC_NAMES == frozenset({"cuda"})

    def boom(*a, **k):
        raise AssertionError("a host codec name ran the probe")

    monkeypatch.setattr(device_probe, "_run_probe", boom)
    device_probe.reset_cache()
    svc = CodecService(mode="auto", codec_name="torch_cpu")
    assert svc.mode == "host" and svc.fallback_reason == ""
    svc.close()
    assert codec_service.service_for_codec("torch_cpu") is None
    # the reference passes a host codec through the same way
    assert effective_codec("cpu") == ("cpu", "")


# -- byte identity, host and device-on-cpu ------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_parity_identity_mixed_widths(mode):
    svc = _svc(mode)
    rng = np.random.default_rng(1)
    widths = (0, 1, 7, 100, 4096, 17 << 10, 300_000)  # spans the slab cutoff
    blocks = [_rand_block(rng, w) for w in widths]
    futs = [svc.submit_parity(b) for b in blocks]
    want = _ref_results(lambda s: s.submit_parity_many, blocks)
    rs = ReedSolomon()
    for fut, b, exp in zip(futs, blocks, want):
        got = _as2d(fut.result(60)) if b.shape[1] else np.empty((4, 0))
        assert np.array_equal(got, exp)
        assert np.array_equal(got, rs.parity_of(b))
    svc.close()


@pytest.mark.parametrize("mode", MODES)
def test_apply_identity_decode_plan(mode):
    svc = _svc(mode)
    rng = np.random.default_rng(2)
    plan = _plan((0, 1, 2, 3))
    block = _rand_block(rng, 5000)
    got = _as2d(svc.submit_apply(plan, block).result(60))
    (want,) = _ref_results(lambda s: lambda b: [s.submit_apply(plan, b)],
                           block)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.stack(ReedSolomon().apply_rows(
        plan, list(block))))
    svc.close()


@pytest.mark.parametrize("mode", MODES)
def test_vectored_submit_preserves_order_and_identity(mode):
    svc = _svc(mode)
    rng = np.random.default_rng(3)
    datas = [_rand_block(rng, w) for w in (64, 0, 2048, 9000, 3)]
    futs = svc.submit_parity_many(datas)
    want = _ref_results(lambda s: s.submit_parity_many, datas)
    for fut, exp in zip(futs, want):
        got = _as2d(fut.result(60)) if exp.shape[1] else np.empty((4, 0))
        assert np.array_equal(got, exp)
    svc.close()


@pytest.mark.parametrize("mode", MODES)
def test_out_buffers_filled_in_place(mode):
    svc = _svc(mode)
    rng = np.random.default_rng(4)
    block = _rand_block(rng, 12345)
    out = np.zeros((4, 12345), dtype=np.uint8)
    svc.parity_into(block, out)
    ref_out = np.zeros_like(out)
    ref = ref_service.CodecService(mode="host")
    ref.parity_into(block, ref_out)
    ref.close()
    assert np.array_equal(out, ref_out)
    # a list of row buffers is filled row by row
    rows = [np.zeros(12345, np.uint8) for _ in range(4)]
    fut = svc.submit_parity(block, out=rows)
    assert all(got is row for got, row in zip(fut.result(60), rows))
    assert np.array_equal(np.stack(rows), ref_out)
    svc.close()


@pytest.mark.parametrize("mode", MODES)
def test_list_of_rows_input(mode):
    """mmap-view-style input: a list of 1-D rows, not a 2-D array."""
    svc = _svc(mode)
    rng = np.random.default_rng(5)
    rows = [rng.integers(0, 256, 777, dtype=np.uint8) for _ in range(10)]
    got = _as2d(svc.submit_parity(rows).result(60))
    (want,) = _ref_results(lambda s: lambda r: [s.submit_parity(r)], rows)
    assert np.array_equal(got, want)
    svc.close()


@pytest.mark.parametrize("mode", MODES)
def test_strided_row_views_are_decoded_correctly(mode):
    """Non-contiguous row views are copied before they reach the compute,
    for widths on BOTH sides of the slab-coalescing cutoff."""
    svc = _svc(mode, coalesce_kb=16)
    rng = np.random.default_rng(15)
    for w in (1024, 64 << 10):  # slab path and per-job path
        rows = [rng.integers(0, 256, 2 * w, dtype=np.uint8)[::2]
                for _ in range(10)]
        got = _as2d(svc.submit_parity(rows).result(60))
        exp = ReedSolomon().parity_of(np.stack(
            [np.ascontiguousarray(r_) for r_ in rows]))
        assert np.array_equal(got, exp)
    svc.close()


def test_device_mode_identity_parity_and_apply():
    """The port's device mode against the reference's device mode (the
    mesh dry-run on the virtual 8-device CPU mesh)."""
    svc = CodecService(mode="device", device="cpu")
    ref = ref_service.CodecService(mode="device", codec_name="tpu_xor")
    rng = np.random.default_rng(6)
    blocks = [_rand_block(rng, w) for w in (64, 200, 256, 1000)]
    plan = _plan((2,))
    ablock = _rand_block(rng, 513)
    futs = svc.submit_parity_many(blocks)
    afut = svc.submit_apply(plan, ablock)
    rfuts = ref.submit_parity_many(blocks)
    rafut = ref.submit_apply(plan, ablock)
    for fut, rfut in zip(futs, rfuts):
        assert np.array_equal(_as2d(fut.result(120)), _as2d(rfut.result(120)))
    assert np.array_equal(_as2d(afut.result(120)), _as2d(rafut.result(120)))
    svc.close()
    ref.close()


def test_auto_mode_falls_back_to_host_without_accelerator():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    device_probe.reset_cache()
    svc = CodecService(mode="auto", codec_name="cuda")
    assert svc.mode == "host"
    assert svc.fallback_reason  # names why the device path was refused
    rng = np.random.default_rng(7)
    block = _rand_block(rng, 1024)
    assert np.array_equal(
        _as2d(svc.submit_parity(block).result(60)),
        ReedSolomon().parity_of(block))
    svc.close()


def test_default_service_runs_on_the_card(monkeypatch):
    """No arguments mean the card: the default `auto` mode with the `cuda`
    codec picks device mode whenever the probe reports an accelerator (with
    no card to open, construction then raises rather than fall back), and
    only an absent accelerator sends it to the host, saying why."""
    device_probe.reset_cache()
    svc = CodecService()
    assert svc.codec_name == "cuda"
    if torch.cuda.is_available():
        assert svc.mode == "device" and svc.device.type == "cuda"
    else:
        assert svc.mode == "host"
        assert svc.fallback_reason == "no accelerator (cpu)"
    svc.close()
    monkeypatch.setattr(device_probe, "probe", lambda *a, **k:
                        device_probe.ProbeResult(ok=True, devices=1,
                                                 platform="cuda"))
    monkeypatch.delenv("SEAWEEDFS_TPU_EC_SERVICE", raising=False)
    if torch.cuda.is_available():
        assert CodecService().mode == "device"
        assert codec_service.get_service().mode == "device"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            CodecService()
        with pytest.raises(RuntimeError, match="CUDA"):
            codec_service.get_service()


def test_batch_cap_defaults_admit_encoder_slices(monkeypatch):
    """On a card a batch holds several of the encoder's 16 MiB-per-shard
    slices (160 MiB of input each, two in flight per volume); the host
    keeps the reference's 64 MB.  The env knob sets both."""
    monkeypatch.delenv("SEAWEEDFS_TPU_EC_SERVICE_BATCH_MB", raising=False)
    slice_input = 10 * tenc.DEFAULT_SLICE
    dev = CodecService(mode="device", device="cpu")
    host = CodecService(mode="host")
    assert dev.max_batch_bytes >= 2 * 3 * slice_input
    assert host.max_batch_bytes == 64 << 20 == ref_service.CodecService(
        mode="host").max_batch_bytes
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SERVICE_BATCH_MB", "200")
    for mode in (("host", None), ("device", "cpu")):
        assert _svc(mode).max_batch_bytes == 200 << 20
        assert _svc(mode, max_batch_mb=7).max_batch_bytes == 7 << 20
    for svc in (dev, host):
        svc.close()


# -- scheduler behavior -----------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_batches_coalesce_under_load(mode):
    child = EC_SERVICE_BATCH_JOBS.labels()
    before_total, before_count = child.total, child.count
    svc = _svc(mode, max_batch=16, coalesce_kb=16)
    rng = np.random.default_rng(8)
    big = _rand_block(rng, 8 << 20)  # occupies the worker for a while
    small = [_rand_block(rng, 2048) for _ in range(12)]
    first = svc.submit_parity(big)
    futs = svc.submit_parity_many(small)
    first.result(120)
    want = _ref_results(lambda s: s.submit_parity_many, small)
    for f, exp in zip(futs, want):
        assert np.array_equal(_as2d(f.result(120)), exp)
    svc.close()
    jobs = child.total - before_total
    batches = child.count - before_count
    assert jobs == 13
    # the 12 small jobs queued while the big one computed must have
    # coalesced into (far) fewer than 12 batches
    assert batches < 13


@pytest.mark.parametrize("mode", MODES)
def test_fairness_saturating_producer_does_not_starve(mode):
    svc = _svc(mode, max_batch=8)
    rng = np.random.default_rng(9)
    flood_block = _rand_block(rng, 64 << 10)
    stop = threading.Event()

    def flood():
        pend = []
        while not stop.is_set():
            pend.append(svc.submit_parity(flood_block))
            if len(pend) > 8:
                pend.pop(0).result()
        for f in pend:
            f.result()

    threads = [threading.Thread(target=flood) for _ in range(3)]
    for t in threads:
        t.start()
    stages = [EC_SERVICE_STAGE.labels(st)
              for st in ("build", "compute", "readback")]
    batches = EC_SERVICE_BATCH_JOBS.labels()
    try:
        time.sleep(0.1)  # let the flood saturate the queue
        plan = _plan((1,))
        block = _rand_block(rng, 2048)
        busy0, n0 = sum(c.total for c in stages), batches.count
        t0 = time.perf_counter()
        got = svc.submit_apply(plan, block).result(120)
        latency = time.perf_counter() - t0
        per_batch = ((sum(c.total for c in stages) - busy0)
                     / max(batches.count - n0, 1))
        assert np.array_equal(
            _as2d(got), np.stack(ReedSolomon().apply_rows(plan, list(block))))
        # head-of-queue batching bounds the odd job's wait to the batches
        # ahead of it (at most 3 producers x 9 pending / 8 per batch, plus
        # the one running), not the flood's duration.  The reference
        # states this as 2 s for its native codec; the plain torch
        # version's batch time varies 100x with the host's load, so the
        # bound is in this service's own measured batch time.
        assert latency < 2.0 + 8 * per_batch
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        svc.close()
    assert not any(t.is_alive() for t in threads)


@pytest.mark.parametrize("mode", MODES)
def test_clean_shutdown_delivers_inflight_jobs(mode):
    svc = _svc(mode)
    rng = np.random.default_rng(10)
    datas = [_rand_block(rng, 100_000) for _ in range(24)]
    futs = svc.submit_parity_many(datas)
    svc.close()  # drain: every already-accepted job still completes
    rs = ReedSolomon()
    for fut, data in zip(futs, datas):
        assert np.array_equal(_as2d(fut.result(60)), rs.parity_of(data))
    with pytest.raises(RuntimeError):
        svc.submit_parity(datas[0])


@pytest.mark.parametrize("mode", MODES)
def test_compute_failure_fails_jobs_not_hangs(monkeypatch, mode):
    svc = _svc(mode)

    def boom(batch):
        raise RuntimeError("injected compute failure")

    monkeypatch.setattr(
        svc, "_compute_host" if mode[0] == "host" else "_dispatch_device",
        boom)
    fut = svc.submit_parity(_rand_block(np.random.default_rng(11), 1024))
    with pytest.raises(RuntimeError, match="injected"):
        fut.result(30)
    svc.close()


@pytest.mark.parametrize("mode", MODES)
def test_validation_errors_raise_in_caller(mode):
    svc = _svc(mode)
    rng = np.random.default_rng(12)
    with pytest.raises(ValueError):
        svc.submit_parity(rng.integers(0, 256, (9, 64), dtype=np.uint8))
    with pytest.raises(ValueError):
        svc.submit_parity(
            [rng.integers(0, 256, w, dtype=np.uint8)
             for w in (64,) * 9 + (65,)])
    with pytest.raises(ValueError):
        svc.submit_parity(_rand_block(rng, 64),
                          out=np.zeros((4, 63), np.uint8))
    with pytest.raises(ValueError):
        svc.submit_apply(np.zeros(10, np.uint8), _rand_block(rng, 64))
    with pytest.raises(ValueError):
        CodecService(mode="fast")
    svc.close()


@pytest.mark.parametrize("mode", MODES)
def test_results_survive_later_batches(mode):
    """A delivered result stays valid while later batches run: the
    device mode's buffers are reused every second batch, and a result
    viewing one would be overwritten under its caller."""
    svc = _svc(mode, max_batch=4)
    rng = np.random.default_rng(16)
    rs = ReedSolomon()
    first = [_rand_block(rng, 3000) for _ in range(3)]
    held = [f.result(60) for f in svc.submit_parity_many(first)]
    held_out = np.zeros((4, 3000), np.uint8)
    svc.parity_into(first[0], held_out)
    for _ in range(2):  # batches k+1 and k+2, same shapes, other bytes
        later = [_rand_block(rng, 3000) for _ in range(3)]
        for f, d in zip(svc.submit_parity_many(later), later):
            assert np.array_equal(_as2d(f.result(60)), rs.parity_of(d))
    for got, d in zip(held, first):
        assert np.array_equal(_as2d(got), rs.parity_of(d))
    assert np.array_equal(held_out, rs.parity_of(first[0]))
    svc.close()


@pytest.mark.parametrize("mode", MODES)
def test_many_submitters_each_get_their_own_result(mode):
    """16 threads (more than this host's cores) submit jobs of mixed
    widths and matrices with a tiny switch interval; every job must get
    exactly its own bytes back."""
    svc = _svc(mode, max_batch=8, max_queue=16)
    rs = ReedSolomon()
    plan = _plan((0, 5, 12))
    errors: list[str] = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def worker(seed):
        rng = np.random.default_rng(seed)
        for i in range(12):
            block = _rand_block(rng, int(rng.integers(1, 5000)))
            if i % 3:
                fut = svc.submit_parity(block)
                want = rs.parity_of(block)
            else:
                fut = svc.submit_apply(plan, block)
                want = np.stack(rs.apply_rows(plan, list(block)))
            if not np.array_equal(_as2d(fut.result(60)), want):
                errors.append(f"worker {seed} job {i}")

    threads = [threading.Thread(target=worker, args=(100 + n,))
               for n in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
        svc.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_metrics_registry_and_service_families_match_reference():
    """The port's copy of the registry renders what the reference's does,
    and its service families carry the reference's names, labels and
    buckets."""
    from seaweedfs_tpu.stats import metrics as jm
    from seaweedfs_tpu_torch.stats import metrics as tm

    texts = []
    for mod in (jm, tm):
        reg = mod.Registry()
        c = reg.counter("x_total", "a counter", ("kind", "result"))
        c.labels("parity", "ok").inc()
        c.labels("apply", 'e"r\\r').inc(2.5)
        reg.gauge("x_depth", "a gauge").set(7)
        h = reg.histogram("x_seconds", "a histogram", ("stage",),
                          buckets=(0.1, 1.0))
        h.labels("build").observe(0.05)
        h.labels("compute").observe(0.5)
        h.labels("compute").observe(3.0)
        with pytest.raises(ValueError):
            reg.gauge("x_total", "clash", ("kind", "result"))
        texts.append(reg.render())
        timed = h.labels("readback")
        with timed.time():
            pass
        assert timed.count == 1 and timed.total >= 0
    assert texts[0] == texts[1]
    names = [n for n in dir(tm) if n.startswith("EC_SERVICE_")]
    assert len(names) == 8
    for n in names:
        ref, port = getattr(jm, n), getattr(tm, n)
        assert (port.name, port.kind, port.label_names, port.help) == \
            (ref.name, ref.kind, ref.label_names, ref.help)
        assert getattr(port, "buckets", None) == getattr(ref, "buckets", None)


# -- singletons + env gating ------------------------------------------------


def test_get_service_disabled_by_env(monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SERVICE", "0")
    assert codec_service.get_service("torch_cpu") is None
    assert codec_service.service_for_codec("cuda") is None
    assert codec_service.service_for_degraded() is None
    assert ref_service.get_service("cpu") is None


def test_get_service_shared_and_recreated_after_shutdown(monkeypatch):
    monkeypatch.delenv("SEAWEEDFS_TPU_EC_SERVICE", raising=False)
    a = codec_service.get_service("torch_cpu")
    assert a is codec_service.get_service("torch_cpu")
    assert a.mode == "host"
    codec_service.shutdown_all()
    b = codec_service.get_service("torch_cpu")
    assert b is not a and not b.closed
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SERVICE_DEGRADED", "1")
    assert codec_service.service_for_degraded() is b


def test_service_for_codec_requires_accelerator(monkeypatch):
    # no card: the probe answers on the CPU, so the bulk pipelines keep
    # their direct dispatch paths, as the reference does on cpu-jax
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    monkeypatch.delenv("SEAWEEDFS_TPU_EC_SERVICE", raising=False)
    device_probe.reset_cache()
    assert codec_service.service_for_codec("cuda") is None
    assert codec_service.service_for_codec("torch_cpu") is None
    ref_probe.reset_cache()
    assert ref_service.service_for_codec("tpu") is None


def test_no_card_entry_points_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_codec("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        CodecService(mode="device")
    base = str(tmp_path / "v")
    with open(base + ".dat", "wb") as f:
        f.write(bytes(4096))
    with pytest.raises(RuntimeError, match="CUDA"):
        tenc.write_ec_files(base, codec_name="cuda")
    assert not os.path.exists(base + to_ext(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tenc.rebuild_ec_files(base, codec_name="cuda")


def test_port_imports_neither_jax_nor_the_reference():
    code = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'seaweedfs_tpu'):
            raise ImportError('blocked: ' + name)
        return None

sys.meta_path.insert(0, Block())
import seaweedfs_tpu_torch
for m in pkgutil.walk_packages(seaweedfs_tpu_torch.__path__,
                               'seaweedfs_tpu_torch.'):
    importlib.import_module(m.name)
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'jaxlib', 'seaweedfs_tpu')]
assert not bad, bad
print('imported', len([m for m in sys.modules
                       if m.startswith('seaweedfs_tpu_torch')]))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=root, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 15


# -- pipeline integration ---------------------------------------------------


def _write_dat(path, nbytes, seed=13):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        f.write(rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes())


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode", MODES)
def test_generate_and_rebuild_via_service_byte_identical(tmp_path, mode):
    from seaweedfs_tpu.storage.ec.encoder import generate_ec_files

    ref_base = str(tmp_path / "ref")
    base = str(tmp_path / "v")
    large, small = 1 << 20, 64 << 10
    _write_dat(ref_base + ".dat", 11 * (1 << 20) + 4321)
    os.link(ref_base + ".dat", base + ".dat")
    generate_ec_files(ref_base, large_block_size=large,
                      small_block_size=small, codec_name="cpu",
                      slice_size=256 << 10)
    ref = {i: _read(ref_base + to_ext(i)) for i in range(14)}

    svc = _svc(mode)
    # mixed slice sizes through the service: batched segments coalesce
    for slice_size in (64 << 10, 192 << 10):
        tenc.generate_ec_files(base, large, small, codec_name="torch_cpu",
                               slice_size=slice_size, service=svc)
        for i in range(14):
            assert _read(base + to_ext(i)) == ref[i], \
                f"shard {i} differs at slice_size={slice_size}"
    # rebuild through the service: worst-case data loss + one parity
    for sid in (0, 1, 2, 13):
        os.remove(base + to_ext(sid))
    rebuilt = tenc.rebuild_ec_files(base, codec_name="torch_cpu",
                                    slice_size=128 << 10, service=svc)
    assert sorted(rebuilt) == [0, 1, 2, 13]
    for i in range(14):
        assert _read(base + to_ext(i)) == ref[i]
    svc.close()


def test_generate_device_mode_service_with_ecx(tmp_path):
    """A needle volume encoded through a device-mode service (on CPU
    tensors) from two concurrent pipelines: .ecNN and .ecx equal the
    reference's generate_ec_files + write_sorted_file_from_idx."""
    import shutil

    from seaweedfs_tpu.storage.ec import encoder as jenc

    (tmp_path / "src").mkdir()
    vol = make_volume(str(tmp_path / "src"), n_needles=90, seed=17,
                      max_size=3000)
    src = vol.file_name()
    vol.close()
    bases = []
    for side in ("jax", "a", "b"):
        (tmp_path / side).mkdir()
        base = str(tmp_path / side / "1")
        for ext in (".dat", ".idx"):
            shutil.copyfile(src + ext, base + ext)
        bases.append(base)
    jbase, abase, bbase = bases
    jenc.generate_ec_files(jbase, large_block_size=10000,
                           small_block_size=100, codec_name="cpu")
    jenc.write_sorted_file_from_idx(jbase)

    svc = CodecService(mode="device", device="cpu")
    errs: list[BaseException] = []

    def encode(base, slice_size):
        try:
            tenc.generate_ec_files(base, 10000, 100, codec_name="torch_cpu",
                                   slice_size=slice_size, service=svc)
            tenc.write_sorted_file_from_idx(base)
        except BaseException as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=encode, args=(abase, 4096)),
               threading.Thread(target=encode, args=(bbase, 333))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    svc.close()
    assert not errs and not any(t.is_alive() for t in threads)
    for base in (abase, bbase):
        for i in range(TOTAL_SHARDS):
            assert _read(base + to_ext(i)) == _read(jbase + to_ext(i)), i
        assert _read(base + ".ecx") == _read(jbase + ".ecx")


def test_degraded_read_via_service(tmp_path, monkeypatch):
    """With SEAWEEDFS_TPU_EC_SERVICE_DEGRADED=1 the port's EcVolume decodes
    each lost interval as an apply job of the shared host-mode service (the
    native cpu codec), and the needles read back whole."""
    from seaweedfs_tpu.storage.needle import FLAG_HAS_NAME, Needle
    from seaweedfs_tpu.storage.super_block import SuperBlock
    from seaweedfs_tpu.storage.volume import Volume
    from seaweedfs_tpu_torch.stats.metrics import EC_SERVICE_JOBS
    from seaweedfs_tpu_torch.storage.ec.volume import EcVolume

    rng = np.random.default_rng(14)
    vol = Volume(str(tmp_path), "", 1, super_block=SuperBlock())
    payloads = {}
    for i in range(1, 21):
        n = Needle(cookie=int(rng.integers(0, 2**32)), id=i,
                   data=rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
        n.set(FLAG_HAS_NAME)
        n.name = f"svc-{i}.bin".encode()
        payloads[i] = n.data
        vol.append_needle(n)
    base = vol.file_name()
    vol.close()
    tenc.generate_ec_files(base, codec_name="cpu")
    tenc.write_sorted_file_from_idx(base)
    for sid in (0, 1, 2, 3):
        os.remove(base + to_ext(sid))

    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SERVICE_DEGRADED", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_INTERVAL_CACHE_MB", "0")
    codec_service.shutdown_all()
    jobs = EC_SERVICE_JOBS.labels("apply", "ok")
    before = jobs.value
    ev = EcVolume(base, volume_id=1, codec_name="cpu")
    try:
        for i in (1, 5, 9, 20):
            assert ev.read_needle(i).data == payloads[i]
    finally:
        ev.close()
    assert jobs.value > before
