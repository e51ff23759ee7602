"""The port's GF(2^8) codec held against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages:
the port's plain PyTorch version of the CUDA kernel (the path a CPU tensor
takes) against the Pallas kernel in interpret mode, and ReedSolomonTorch
against ReedSolomonTPU(impl="pallas").  GF arithmetic is exact, so every
comparison is byte equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as jgf
from seaweedfs_tpu.ops.rs_jax import ReedSolomonTPU
from seaweedfs_tpu.ops.rs_pallas import make_apply_pallas
from seaweedfs_tpu_torch.ops import gf256 as tgf
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.ops.codec import get_codec
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch, matrix_from_numpy

from torch_threads import one_torch_thread  # noqa: F401

WIDTHS = (1, 100, 511, 513, 1000, 4096)
# the loss sets chip_smoke.py also runs: one data shard, two data shards,
# all four leading data shards (worst case), all parity, and mixed
LOSSES = ((0,), (2, 3), (0, 1, 2, 3), (10, 11, 12, 13), (2, 3, 11, 12))


def _plan(lost):
    present = [i for i in range(14) if i not in lost]
    return jgf.decode_plan_for(jgf.rs_matrix(10, 14), 10, present, lost)


def _rows(m):
    return tuple(tuple(int(c) for c in r) for r in m)


def test_tables_and_matrices_equal_reference():
    assert np.array_equal(tgf.EXP_TABLE, jgf.EXP_TABLE)
    assert np.array_equal(tgf.LOG_TABLE, jgf.LOG_TABLE)
    assert np.array_equal(tgf.mul_table(), jgf.mul_table())
    assert np.array_equal(tgf.rs_matrix(10, 14), jgf.rs_matrix(10, 14))
    assert np.array_equal(tgf.rs_parity_matrix(10, 4),
                          jgf.rs_parity_matrix(10, 4))
    m = jgf.rs_matrix(10, 14)[[0, 3, 5, 7, 8, 9, 10, 11, 12, 13]]
    assert np.array_equal(tgf.mat_inv(m), jgf.mat_inv(m))
    assert np.array_equal(tgf.bit_matrix(tgf.rs_parity_matrix(10, 4)),
                          jgf.bit_matrix(jgf.rs_parity_matrix(10, 4)))


@pytest.mark.parametrize("lost", LOSSES)
def test_decode_plans_equal_reference(lost):
    present = [i for i in range(14) if i not in lost]
    before = dict(tgf.PLAN_STATS)
    plan = tgf.decode_plan_for(tgf.rs_matrix(10, 14), 10, present, lost)
    assert np.array_equal(plan, _plan(lost))
    again = tgf.decode_plan_for(tgf.rs_matrix(10, 14), 10, present, lost)
    assert again is plan  # served from the LRU
    assert tgf.PLAN_STATS["hit"] > before["hit"]


def test_matrix_from_numpy_carries_jax_matrices():
    for m in [jgf.rs_matrix(10, 14), jgf.rs_parity_matrix(10, 4)] + [
            _plan(lost) for lost in LOSSES]:
        got = matrix_from_numpy(m)
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        assert not got.flags.writeable
        assert np.array_equal(got, m)
    assert np.array_equal(matrix_from_numpy(np.array([[1, 255]], np.int64)),
                          [[1, 255]])
    with pytest.raises(ValueError):
        matrix_from_numpy(np.zeros((17, 10), np.uint8))
    with pytest.raises(ValueError):
        matrix_from_numpy(np.array([[256]], np.int64))


@pytest.mark.parametrize("which", ["parity"] + [str(lost) for lost in LOSSES])
def test_reference_matches_pallas_interpret(which):
    if which == "parity":
        m = jgf.rs_parity_matrix(10, 4)
    else:
        m = _plan(dict((str(lost), lost) for lost in LOSSES)[which])
    pallas = make_apply_pallas(_rows(m), interpret=True)
    rng = np.random.default_rng(len(which))
    for b in WIDTHS:
        data = rng.integers(0, 256, (10, b), dtype=np.uint8)
        want = np.asarray(pallas(jnp.asarray(data)))
        got = rs_cuda.gf_apply_reference(matrix_from_numpy(m),
                                          torch.from_numpy(data))
        assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
        assert np.array_equal(got.numpy(), want), (which, b)
        # a CPU tensor takes the plain version through the public wrapper
        assert np.array_equal(rs_cuda.gf_apply(m, torch.from_numpy(data))
                              .numpy(), want), (which, b)


def test_gf_apply_rejects_bad_inputs():
    m = tgf.rs_parity_matrix(10, 4)
    with pytest.raises(ValueError):
        rs_cuda.gf_apply(m, torch.zeros((9, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        rs_cuda.gf_apply(m, torch.zeros((10, 8), dtype=torch.int32))
    with pytest.raises(TypeError):
        rs_cuda.gf_apply(m, np.zeros((10, 8), np.uint8))
    before = rs_cuda.gf_apply.launches
    rs_cuda.gf_apply(m, torch.zeros((10, 8), dtype=torch.uint8))
    assert rs_cuda.gf_apply.launches == before  # the CPU path launches nothing


def _shards(rng, b):
    data = [rng.integers(0, 256, b, dtype=np.uint8) for _ in range(10)]
    return data + [np.zeros(b, np.uint8) for _ in range(4)]


def test_codec_matches_reed_solomon_tpu():
    rng = np.random.default_rng(7)
    port = ReedSolomonTorch(device="cpu")
    ref = ReedSolomonTPU(impl="pallas")
    for b in (1, 513):
        a = _shards(rng, b)
        r = [s.copy() for s in a]
        port.encode(a)
        ref.encode(r)
        for i in range(14):
            assert np.array_equal(a[i], r[i]), (b, i)
        assert port.verify(a) and ref.verify(r)
    bad = [s.copy() for s in a]
    bad[12][0] ^= 1
    assert not port.verify(bad)
    for lost in LOSSES:
        holed = [None if i in lost else s for i, s in enumerate(a)]
        got = port.reconstruct(list(holed))
        want = ref.reconstruct(list(holed))
        for i in range(14):
            assert np.array_equal(np.asarray(got[i]), a[i]), (lost, i)
            assert np.array_equal(np.asarray(got[i]),
                                  np.asarray(want[i])), (lost, i)
        got_d = port.reconstruct_data(list(holed))
        want_d = ref.reconstruct_data(list(holed))
        for i in range(10):
            assert np.array_equal(np.asarray(got_d[i]),
                                  np.asarray(want_d[i])), (lost, i)
    with pytest.raises(ValueError):
        port.reconstruct([None] * 5 + a[5:])


def test_parity_of_and_parity_fn_match_reference():
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, (10, 777), dtype=np.uint8)
    want = np.asarray(ReedSolomonTPU(impl="pallas").parity_of(data))
    assert np.array_equal(get_codec("torch_cpu").parity_of(data), want)
    assert np.array_equal(
        rs_cuda.parity_fn()(torch.from_numpy(data)).numpy(), want)


def test_cuda_codec_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_codec("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ReedSolomonTorch(device="cuda")
    with pytest.raises(ValueError):
        get_codec("tpu")


# -- the batched launch and bench.py:104's sweep ------------------------------


def _bench_sweep_pallas(rows, host_u32, g, k, tile):
    """bench.py:104's pallas_call, built the same way at a small tile: a
    (K, G) grid where sweep kk reads input block gg + kk and writes output
    block gg, so the output keeps the parity of window K-1."""
    import functools

    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from seaweedfs_tpu.ops.rs_pallas import LANES, _kernel_body

    fn = pl.pallas_call(
        functools.partial(_kernel_body, rows),
        out_shape=jax.ShapeDtypeStruct((4, g * tile, LANES), jnp.uint32),
        grid=(k, g),
        in_specs=[pl.BlockSpec((10, tile, LANES),
                               lambda kk, gg: (0, gg + kk, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((4, tile, LANES), lambda kk, gg: (0, gg, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )
    return np.asarray(fn(jnp.asarray(host_u32)))


@pytest.mark.parametrize("g,k", [(1, 3), (2, 4)])
def test_sweep_matches_bench_pallas_grid(g, k):
    from seaweedfs_tpu.ops.rs_pallas import LANES

    tile = 8  # bench.py runs 256 rows of 128 lanes; the grid is the same
    rng = np.random.default_rng(100 + g * k)
    host = rng.integers(0, 2**32, (10, (g + k) * tile, LANES),
                        dtype=np.uint32)
    m = jgf.rs_parity_matrix(10, 4)
    want_last = _bench_sweep_pallas(_rows(m), host, g, k, tile)
    buf = host.view(np.uint8).reshape(10, -1)  # little-endian lane bytes
    shift = tile * LANES * 4  # one block per sweep
    width = g * shift
    got = rs_cuda.gf_sweep_reference(m, torch.from_numpy(buf), width, k,
                                     shift)
    assert tuple(got.shape) == (k, 4, width)
    assert np.array_equal(got[k - 1].numpy(),
                          want_last.view(np.uint8).reshape(4, -1))
    # every sweep's own entry is the Pallas kernel over its window
    pallas = make_apply_pallas(_rows(m), interpret=True)
    for kk in range(k):
        window = buf[:, kk * shift: kk * shift + width]
        assert np.array_equal(got[kk].numpy(),
                              np.asarray(pallas(jnp.asarray(window)))), kk
    # the public wrapper on a CPU tensor takes the plain version
    assert torch.equal(rs_cuda.gf_sweep(m, torch.from_numpy(buf), width, k,
                                        shift), got)


@pytest.mark.parametrize("which", ["parity", "(0, 1, 2, 3)", "(2, 3, 11, 12)"])
def test_batched_reference_matches_pallas_interpret(which):
    m = (jgf.rs_parity_matrix(10, 4) if which == "parity"
         else _plan(dict((str(lost), lost) for lost in LOSSES)[which]))
    pallas = make_apply_pallas(_rows(m), interpret=True)
    rng = np.random.default_rng(len(which) + 50)
    for v, b in ((1, 513), (3, 100), (5, 1)):
        data = rng.integers(0, 256, (v, 10, b), dtype=np.uint8)
        got = rs_cuda.gf_apply_batched_reference(m, torch.from_numpy(data))
        assert tuple(got.shape) == (v, m.shape[0], b)
        for e in range(v):
            want = np.asarray(pallas(jnp.asarray(data[e])))
            assert np.array_equal(got[e].numpy(), want), (which, v, b, e)
        assert torch.equal(
            rs_cuda.gf_apply_batched(m, torch.from_numpy(data)), got)
    # overlapping entries (a sweep's windows) read the same bytes
    buf = rng.integers(0, 256, (10, 700), dtype=np.uint8)
    t = torch.from_numpy(buf)
    windows = t.as_strided((4, 10, 400), (100, 700, 1))
    got = rs_cuda.gf_apply_batched_reference(m, windows)
    for e in range(4):
        want = np.asarray(pallas(jnp.asarray(buf[:, 100 * e: 100 * e + 400])))
        assert np.array_equal(got[e].numpy(), want), e


def test_batched_and_sweep_reject_bad_inputs():
    m = tgf.rs_parity_matrix(10, 4)
    with pytest.raises(ValueError):
        rs_cuda.gf_apply_batched(m, torch.zeros((2, 9, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        rs_cuda.gf_apply_batched(m, torch.zeros((10, 8), dtype=torch.uint8))
    with pytest.raises(TypeError):
        rs_cuda.gf_apply_batched(m, np.zeros((1, 10, 8), np.uint8))
    buf = torch.zeros((10, 100), dtype=torch.uint8)
    with pytest.raises(ValueError):
        rs_cuda.gf_sweep(m, buf, 60, 3, 30)  # reads 120 of 100 columns
    with pytest.raises(ValueError):
        rs_cuda.gf_sweep_reference(m, buf, 10, 0, 5)
    assert tuple(rs_cuda.gf_sweep(m, buf, 40, 3, 30).shape) == (3, 4, 40)
    assert tuple(rs_cuda.gf_apply_batched(
        m, torch.zeros((0, 10, 8), dtype=torch.uint8)).shape) == (0, 4, 8)
    before = rs_cuda.gf_apply_batched.launches
    rs_cuda.gf_apply_batched(m, torch.zeros((2, 10, 8), dtype=torch.uint8))
    assert rs_cuda.gf_apply_batched.launches == before  # no launch on CPU
