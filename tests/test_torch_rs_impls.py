"""The port's two other GF(2^8) codecs held against the JAX package, on the
CPU: `impl="xor"` (the XOR network of the doubling chain,
csrc/gf_xor.cu) against ReedSolomonTPU(impl="xor"), and
`impl="bitplane"` (bit-planes through an int8 product on the tensor
cores, csrc/gf_bitplane.cu) against ReedSolomonTPU(impl="mxu").

Inputs come from numpy with a fixed seed.  On the CPU each wrapper runs
its plain PyTorch version; the CUDA sources are also compiled with the
host C++ compiler, their CUDA keywords defined away, and run thread by
thread (the bit-plane kernel's product for a warpgroup at once, with a
plain emulation of wgmma's operand layouts) against those plain
versions.
GF arithmetic is exact, so every comparison is byte equality: the
tolerance is zero.
"""

import ctypes
import itertools
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as jgf
from seaweedfs_tpu.ops.rs_jax import ReedSolomonTPU, _multiples, make_apply_mxu
from seaweedfs_tpu.parallel import mesh as jmesh
from seaweedfs_tpu_torch.ops import _build, rs_bitplane, rs_cuda, rs_xor
from seaweedfs_tpu_torch.ops.codec import (
    DEVICE_CODEC_NAMES,
    available_codecs,
    effective_codec,
    get_codec,
)
from seaweedfs_tpu_torch.ops.rs_torch import IMPLS, ReedSolomonTorch

from torch_threads import one_torch_thread  # noqa: F401

# port impl -> the reference's
REF_IMPL = {"xor": "xor", "bitplane": "mxu"}
WIDTH = 203
# a seeded sample of the 1001 four-loss patterns of RS(10,4)
FOUR_LOSSES = [tuple(p) for p in np.random.default_rng(11).permutation(
    np.array(list(itertools.combinations(range(14), 4))))[:4]]


def _shards(seed: int, width: int = WIDTH) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, width, dtype=np.uint8) for _ in range(10)] \
        + [np.zeros(width, np.uint8) for _ in range(4)]


@pytest.mark.parametrize("impl", ["xor", "bitplane"])
def test_encode_matches_reference(impl):
    ref = ReedSolomonTPU(impl=REF_IMPL[impl])
    port = ReedSolomonTorch(device="cpu", impl=impl)
    want, got = _shards(1), _shards(1)
    ref.encode(want)
    port.encode(got)
    for i in range(14):
        assert np.array_equal(got[i], want[i]), i
    assert port.verify(got) and port.impl == f"torch_cpu_{impl}"


@pytest.mark.parametrize("impl", ["xor", "bitplane"])
@pytest.mark.parametrize("lost", FOUR_LOSSES, ids=str)
def test_reconstruct_four_losses_matches_reference(impl, lost):
    ref = ReedSolomonTPU(impl=REF_IMPL[impl])
    port = ReedSolomonTorch(device="cpu", impl=impl)
    full = _shards(sum(lost))
    ref.encode(full)
    holed = [None if i in lost else s for i, s in enumerate(full)]
    for method in ("reconstruct", "reconstruct_data"):
        want = getattr(ref, method)(list(holed))
        got = getattr(port, method)(list(holed))
        for i in range(14):
            if want[i] is None:
                assert got[i] is None, (method, i)
            else:
                assert np.array_equal(np.asarray(got[i]),
                                      np.asarray(want[i])), (method, i)
        for i in range(10):  # the data rows are the originals
            assert np.array_equal(np.asarray(got[i]), full[i]), (method, i)


def test_impls_are_named_and_unknown_raises():
    assert set(IMPLS) == {"bitslice", "xor", "bitplane"}
    with pytest.raises(ValueError, match="impl"):
        ReedSolomonTorch(device="cpu", impl="mxu")


@pytest.mark.parametrize("b", [1, 7, 16, 33, 4099])
def test_xor_plain_version_is_the_reference_network(b):
    m = jgf.rs_parity_matrix(10, 4)
    data = np.random.default_rng(b).integers(0, 256, (10, b), dtype=np.uint8)
    t = torch.from_numpy(data)
    # the doubling chain, step by step
    for got, want in zip(rs_xor._multiples(t), _multiples(jnp.asarray(data))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    want = rs_cuda.gf_apply_reference(m, t)
    assert torch.equal(rs_xor.gf_apply_xor_reference(m, t), want)
    assert torch.equal(rs_xor.gf_apply_xor(m, t), want)
    batch = torch.from_numpy(np.stack([data, data[::-1].copy()]))
    assert torch.equal(rs_xor.gf_apply_xor_batched(m, batch),
                       rs_cuda.gf_apply_batched_reference(m, batch))


def test_xor_ops_counts_the_side_the_kernel_takes():
    """rs_xor.xor_ops: for RS(10,4) parity the chains on the outputs
    (Horner's rule: 7 doublings of 16 words, the 3 groups' tables, 4 XORs
    for each of the 96 reads, 952 operations per 16 columns, as
    csrc/gf_xor.cu's header counts), and the chains on the sources (7
    doublings of 4 words a source, a test and 4 XORs for each coefficient
    bit); rs_xor.horner_side picks the side that counts fewer."""
    m = jgf.rs_parity_matrix(10, 4)
    horner = 7 * 16 * 4 + (14 + 14 + 2) * 4 + 96 * 4
    assert rs_xor.xor_ops(m, 16) == rs_xor.xor_ops(m, 16, horner=True) \
        == horner
    assert rs_xor.xor_ops(m, 17, entries=3) == 2 * 3 * 952
    assert rs_xor.xor_ops(m, 16, horner=False) == (10 * 7 * 4 * 4
                                                   + 8 * 4 * 10 * 5)
    tall = np.ones((10, 1), np.uint8)
    sources = 1 * 7 * 4 * 4 + 8 * 10 * 1 * 5
    assert rs_xor.xor_ops(tall, 16) == sources
    assert rs_xor.xor_ops(tall, 16, horner=True) == 10 * 7 * 16 + 8 * 10 * 4
    assert [rs_xor.horner_side(r, s) for r, s in (
        (4, 10), (3, 10), (10, 10), (16, 16), (16, 4), (1, 1), (1, 2),
        (10, 1), (16, 2), (4, 2), (4, 1))] == [True] * 7 + [False] * 4


@pytest.mark.parametrize("b", [1, 7, 16, 33, 4099])
def test_bitplane_unpack_and_pack_match_the_mesh_reference(b):
    """The plain version's pieces against parallel/mesh.py's."""
    rng = np.random.default_rng(b + 1)
    data = rng.integers(0, 256, (10, b), dtype=np.uint8)
    want = np.asarray(jmesh._bit_unpack(jnp.asarray(data)))
    got = rs_bitplane.bit_unpack_reference(torch.from_numpy(data))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    planes = rng.integers(0, 2, (32, b)).astype(np.int32)
    want = np.asarray(jmesh._bit_pack(jnp.asarray(planes)))
    got = rs_bitplane.bit_pack_reference(torch.from_numpy(planes))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    # sums, not just bits: the pack takes their parity
    sums = planes + 2 * rng.integers(0, 40, planes.shape).astype(np.int32)
    assert np.array_equal(rs_bitplane.bit_pack_reference(
        torch.from_numpy(sums)).numpy(), want)


_PRESENT = [1, 3, 4, 5, 6, 7, 8, 9, 10, 12]
MXU_PLANS = {
    "parity": jgf.rs_parity_matrix(10, 4),
    "decode1": jgf.decode_plan_for(jgf.rs_matrix(10, 14), 10, _PRESENT,
                                   (2,)),
    "decode2": jgf.decode_plan_for(jgf.rs_matrix(10, 14), 10, _PRESENT,
                                   (0, 13)),
    "decode4": jgf.decode_plan_for(jgf.rs_matrix(10, 14), 10, _PRESENT,
                                   (0, 2, 11, 13)),
}


@pytest.mark.parametrize("plan", sorted(MXU_PLANS))
def test_bitplane_apply_matches_make_apply_mxu(plan):
    """gf_apply_bitplane on the CPU against rs_jax.make_apply_mxu's XLA
    program, byte for byte, on the parity plan and 1-, 2- and 4-row
    decode plans."""
    m = MXU_PLANS[plan]
    apply = make_apply_mxu(tuple(tuple(int(c) for c in row) for row in m))
    for b in (1, 63, 65, 4099):
        data = np.random.default_rng(b).integers(0, 256, (10, b),
                                                 dtype=np.uint8)
        want = np.asarray(apply(jnp.asarray(data)))
        got = rs_bitplane.gf_apply_bitplane(m, torch.from_numpy(data))
        assert got.dtype == torch.uint8 and np.array_equal(got.numpy(),
                                                           want), b


@pytest.mark.parametrize("rows", [1, 2, 4, 16])
def test_bitplane_route_pads_small_plans(rows):
    """The kernel's operand rounds a plan's rows up to a multiple of 4 with
    zero columns, which never reach the output: the route gives the
    reference's bytes for plans of every size."""
    m = np.random.default_rng(rows).integers(0, 256, (rows, 10),
                                             dtype=np.uint8)
    ngroups = -(-rows // 4)
    # 3 source groups (10 rows, the last two zero) x the output groups
    tiles = rs_bitplane.operand_tiles(m).reshape(3, ngroups, 1024)
    # operand column N of output group r4 is output row 4 r4 + (N % 8) // 2,
    # its 32 bytes at (N // 8) * 256 + (N % 8) * 16 + (K // 16) * 128 + K % 16
    for r4 in range(ngroups):
        for n in range(32):
            col = [(n // 8) * 256 + (n % 8) * 16 + (k // 16) * 128 + k % 16
                   for k in range(32)]
            if 4 * r4 + (n % 8) // 2 >= rows:
                assert not tiles[:, r4, col].any(), (r4, n)
    # source rows 10 and 11 (K 4u + 2, 4u + 3 of the third group) are zero
    assert not tiles[2][:, [(n // 8) * 256 + (n % 8) * 16 + (k // 16) * 128
                            + k % 16 for n in range(32) for k in range(32)
                            if k % 4 >= 2]].any()
    data = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (10, 77), dtype=np.uint8))
    assert torch.equal(rs_bitplane.gf_apply_bitplane(m, data),
                       rs_cuda.gf_apply_reference(m, data))


def test_codec_names_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    assert {"cuda", "cuda_xor", "cuda_bitplane"} == DEVICE_CODEC_NAMES
    assert not DEVICE_CODEC_NAMES & set(available_codecs())
    for name in ("cuda_xor", "cuda_bitplane"):
        with pytest.raises(RuntimeError, match="CUDA"):
            get_codec(name)
        assert effective_codec(name)[0] == "cpu"
    # the host versions of the three impls give the same bytes
    block = _shards(5)
    outs = []
    for impl in IMPLS:
        shards = [s.copy() for s in block]
        ReedSolomonTorch(device="cpu", impl=impl).encode(shards)
        outs.append(shards[10:])
    assert all(np.array_equal(a, b) for o in outs[1:]
               for a, b in zip(o, outs[0]))


# -- the CUDA sources on the host compiler ----------------------------------

_PRELUDE = r"""
// the CUDA sources on the host: one thread at a time, in grid order
#include <stdint.h>
#include <string.h>
#define GF_HOST_TEST
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
struct D3 { unsigned x, y, z; };
static D3 blockIdx, threadIdx, gridDim;
#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __restrict__
#define __grid_constant__
#define __shared__ static
static void __syncthreads() {}
"""

_XOR_HARNESS = _PRELUDE + r"""
#include "gf_xor.cu"
// gx blocks across the columns (0: as many as they need), gy across the
// entries; each thread runs to its end before the next starts (the
// output-side kernel's shared-memory entries are the thread's own)
template <int R, bool H>
static void grid(const u8* in, i64 is, i64 ib, u8* out, i64 os, i64 ob,
                 i64 B, i64 V, int S, int mode, const GfCoef& c,
                 unsigned gx, unsigned gy) {
  const unsigned threads = H ? XOR_HORNER_THREADS : XOR_THREADS;
  const i64 per = (i64)threads * XOR_CHUNK;
  const unsigned need = (unsigned)((B + per - 1) / per);
  gridDim = {gx && gx < need ? gx : need, gy, 1};
  for (unsigned y = 0; y < gy; ++y)
    for (unsigned x = 0; x < gridDim.x; ++x)
      for (unsigned t = 0; t < threads; ++t) {
        blockIdx = {x, y, 0};
        threadIdx = {t, 0, 0};
        if (H)
          gf_xor_horner<R>(in, is, ib, out, os, ob, B, V, S, mode, c);
        else
          gf_xor_sources<R>(in, is, ib, out, os, ob, B, V, S, mode, c);
      }
}
// h: 1 runs the chains on the outputs (Horner), 0 on the sources, as the
// launcher's `horner`; -> the access path
extern "C" int run(const u8* in, i64 is, i64 ib, u8* out, i64 os, i64 ob,
                   i64 B, i64 V, int R, int S, const u8* coef, int h,
                   unsigned gx, unsigned gy) {
  const GfCoef c = pack_coef(R, S, coef);
  const int mode = access_mode(in, is, ib, out, os, ob);
  switch (R) {
#define SIDE(n)                                                          \
    case n:                                                              \
      if (h)                                                             \
        grid<n, true>(in, is, ib, out, os, ob, B, V, S, mode, c, gx, gy); \
      else                                                               \
        grid<n, false>(in, is, ib, out, os, ob, B, V, S, mode, c, gx, gy); \
      break;
    SIDE(1) SIDE(3) SIDE(4) SIDE(14) SIDE(15) SIDE(16)
#undef SIDE
    default: return -1;
  }
  return mode;
}
extern "C" int chunk_columns() { return XOR_CHUNK; }
"""

_BITPLANE_HARNESS = _PRELUDE + r"""
#include "gf_bitplane.cu"
// the kernel's loop for each block, step by step: each thread's part of a
// step before any thread's part of the next (the barriers), the product
// for the warpgroup's 128 threads at once (NL = 128)
extern "C" int run(const u8* in, i64 is, u8* out, i64 os, int S, int R,
                   i64 B, const u32* tiles_b, unsigned grid) {
  static u8 smem[16 * 1024 + BPM_STAGES * BPM_MAX * BPM_TILE +
                 BPM_MAX * BPM_TILE + BPM_MAX * BPM_OUT_PITCH];
  const Smem m = carve(smem, S, R);
  const int in_mode = access_mode(in, is), out_mode = access_mode(out, os);
  const i64 tiles = (B + BPM_TILE - 1) / BPM_TILE;
  for (unsigned blk = 0; blk < grid; ++blk) {
    memset(smem, 0xA5, sizeof smem);
    memcpy(m.bop, tiles_b, (S + 3) / 4 * ((R + 3) / 4) * BPM_B_TILE);
    for (int k = 0; k < BPM_STAGES - 1; ++k) {
      const i64 tile = blk + (i64)k * grid;
      if (tile < tiles)
        for (int t = 0; t < BPM_THREADS; ++t)
          fetch(m.ring + k * S * BPM_TILE, in, is, S, B, tile * BPM_TILE,
                in_mode, t);
    }
    int slot = 0;
    for (i64 tile = blk; tile < tiles; tile += grid) {
      const i64 ahead = tile + (i64)(BPM_STAGES - 1) * grid;
      if (ahead < tiles)
        for (int t = 0; t < BPM_THREADS; ++t)
          fetch(m.ring + (slot + BPM_STAGES - 1) % BPM_STAGES * S * BPM_TILE,
                in, is, S, B, ahead * BPM_TILE, in_mode, t);
      for (int t = 0; t < BPM_THREADS; ++t)
        transpose(m.ring + slot * S * BPM_TILE, m.grp, S, t);
      product(m.grp, m.bop, m.outs, S, R, 0);
      for (int t = 0; t < BPM_THREADS; ++t)
        store_out(m.outs, out, os, R, B, tile * BPM_TILE, out_mode, t);
      slot = (slot + 1) % BPM_STAGES;
    }
  }
  return 4 * in_mode + out_mode;
}
"""


def _host_lib(tmp_path, harness: str) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    (tmp_path / "harness.cpp").write_text(harness)
    so = tmp_path / "kernel_host.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-w",
                    "-fno-strict-aliasing", "-I",
                    _build.CSRC_DIR, "-o", str(so),
                    str(tmp_path / "harness.cpp")], check=True)
    return ctypes.CDLL(str(so))


def _aligned(rng, shape, offset: int) -> np.ndarray:
    """Random uint8 rows whose start is `offset` bytes past 16-byte
    alignment, row stride the last dimension + offset."""
    *lead, b = shape
    n = int(np.prod(lead)) if lead else 1
    buf = np.zeros(n * (b + offset) + 64, np.uint8)
    start = (-buf.ctypes.data) % 16 + offset
    rows = buf[start:start + n * (b + offset)].reshape(n, b + offset)[:, :b]
    rows[...] = rng.integers(0, 256, rows.shape, dtype=np.uint8)
    return rows.reshape(*lead, b) if lead else rows[0]


def test_xor_kernel_on_the_host_compiler(tmp_path):
    """gf_xor.cu on the host compiler against the plain version, each
    matrix on both sides (the chains on the outputs, Horner, and on the
    sources): RS(10,4) parity, a (3, 10) decode plan, a (1, 10) row,
    (16, 16), (16, 1), (14, 10) and (15, 16); widths about the chunk and
    the block, each access path, and the batched entry with fewer grid
    rows than entries.  rs_xor's operation count uses the kernel's
    chunk."""
    lib = _host_lib(tmp_path, _XOR_HARNESS)
    ll, p = ctypes.c_longlong, ctypes.c_void_p
    lib.run.argtypes = [p, ll, ll, p, ll, ll, ll, ll, ctypes.c_int,
                        ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                        ctypes.c_uint, ctypes.c_uint]
    assert lib.chunk_columns() == rs_xor.CHUNK_COLUMNS
    rng = np.random.default_rng(3)
    plan = jgf.decode_plan_for(jgf.rs_matrix(10, 14), 10,
                               [1, 3, 4, 5, 6, 7, 8, 9, 10, 12], (0, 2, 11))
    mats = [jgf.rs_parity_matrix(10, 4), plan,
            rng.integers(0, 256, (1, 10), dtype=np.uint8),
            rng.integers(0, 256, (16, 16), dtype=np.uint8),
            rng.integers(0, 256, (16, 1), dtype=np.uint8),
            rng.integers(0, 256, (14, 10), dtype=np.uint8),
            rng.integers(0, 256, (15, 16), dtype=np.uint8)]
    # widths about the chunk and the 256-thread block, each access path:
    # row starts 16-aligned (2), word-aligned (1), odd (0)
    for m in mats:
        r, s = m.shape
        coef = np.ascontiguousarray(m).tobytes()
        for b in (1, 7, 16, 33, 4099):
            for offset, mode in ((0, 2), (4, 1), (1, 0)):
                data = _aligned(rng, (s, b), offset)
                want = rs_cuda.gf_apply_reference(
                    m, torch.from_numpy(np.ascontiguousarray(data)))
                stride = data.strides[0] if s > 1 else b
                for h in (1, 0):
                    out = np.full((r, b), 0xA5, np.uint8)
                    got = lib.run(data.ctypes.data, stride, 0,
                                  out.ctypes.data, b, r * b, b, 1, r, s,
                                  coef, h, 2, 1)
                    assert np.array_equal(out, want.numpy()), (
                        m.shape, b, mode, h)
                    if b == 16 and out.ctypes.data % 16 == 0:
                        assert got == mode, (m.shape, offset)
    # batched: entries at a stride, fewer grid rows than entries
    for m in (mats[0], mats[5]):
        r, s = m.shape
        v, b = 5, 4099
        batch = rng.integers(0, 256, (v, s, b), dtype=np.uint8)
        want = rs_cuda.gf_apply_batched_reference(m, torch.from_numpy(batch))
        for h in (1, 0):
            out = np.zeros((v, r, b), np.uint8)
            lib.run(batch.ctypes.data, b, s * b, out.ctypes.data, b, r * b,
                    b, v, r, s, np.ascontiguousarray(m).tobytes(), h, 2, 2)
            assert np.array_equal(out, want.numpy()), (m.shape, h)


@pytest.mark.parametrize("s", [1, 2, 5, 10, 14, 16])
def test_bitplane_mma_kernel_on_the_host_compiler(tmp_path, s):
    """gf_bitplane_mma on the host compiler against the plain version for
    plans of S sources and R in {1, 2, 3, 4, 10, 14} rows, widths about
    the 16-byte copies and the 256-column tile, rows 16-byte aligned, 4
    bytes past and 1 byte past (each access path), 2 blocks looping over
    the tiles through the copy ring: the planes, the operand tiles'
    layout, the padding, the merge of each byte, the masks and the
    stores."""
    lib = _host_lib(tmp_path, _BITPLANE_HARNESS)
    ll, p = ctypes.c_longlong, ctypes.c_void_p
    lib.run.argtypes = [p, ll, p, ll, ctypes.c_int, ctypes.c_int, ll, p,
                        ctypes.c_uint]
    rng = np.random.default_rng(s)
    for r in (1, 2, 3, 4, 10, 14):
        m = rng.integers(0, 256, (r, s), dtype=np.uint8)
        tiles = rs_bitplane.operand_tiles(m).view(np.uint32).copy()
        for b in (1, 7, 16, 33, 1024, 4099):
            for offset, mode in ((0, 2), (4, 1), (1, 0)):
                data = _aligned(rng, (s, b), offset)
                out = _aligned(rng, (r, b), offset)
                got_modes = lib.run(
                    data.ctypes.data, data.strides[0] if s > 1 else b,
                    out.ctypes.data, out.strides[0] if r > 1 else b, s, r,
                    b, tiles.ctypes.data, 2)
                want = rs_bitplane.gf_apply_bitplane_reference(
                    m, torch.from_numpy(np.ascontiguousarray(data)))
                assert np.array_equal(out, want.numpy()), (r, b, offset)
                if b == 16:
                    assert got_modes == 4 * mode + mode, (r, offset)


def test_gf_xor_source_is_built_by_name():
    """The two sources build with nvcc by name into their own libraries
    (ops/_build.py), each keyed by its own hash."""
    paths = {n: _build.library_path(n) for n in
             ("gf_launch", "gf_xor", "gf_bitplane")}
    assert len(set(paths.values())) == 3
    for name, path in paths.items():
        assert os.path.basename(path).startswith(f"lib{name}-")
