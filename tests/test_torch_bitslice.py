"""The bit-sliced XOR network of the port's GF(2^8) kernel, on the CPU.

`gf_network.plain_apply` runs the network as the CUDA kernel
(csrc/gf_bitslice.cu) does: 32-byte groups of 8 words, the delta-swap
transpose into bit-planes, the generated XORs, the transpose back.  Inputs
come from numpy with a fixed seed and are held byte-equal against the JAX
package's Pallas kernel in interpret mode and against the port's plain
version, `rs_cuda.gf_apply_reference`.  The kernel template itself is also
compiled with the host C++ compiler, its CUDA keywords defined away, and
run thread by thread over every access path.
"""

import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as jgf
from seaweedfs_tpu.ops.rs_pallas import make_apply_pallas
from seaweedfs_tpu_torch.ops import _build, gf256, gf_network, rs_cuda

WIDTHS = (1, 31, 32, 33, 100, 513, 4097)
LOSSES = ((0,), (2, 3), (0, 1, 2, 3), (10, 11, 12, 13), (2, 3, 11, 12))


def _plan(lost):
    present = [i for i in range(14) if i not in lost]
    return jgf.decode_plan_for(jgf.rs_matrix(10, 14), 10, present, lost)


def _random(seed, r, s):
    return np.random.default_rng(seed).integers(0, 256, (r, s), dtype=np.uint8)


MATRICES = {
    "parity": lambda: jgf.rs_parity_matrix(10, 4),
    **{f"plan{list(lost)}": (lambda lost=lost: _plan(lost)) for lost in LOSSES},
    "identity": lambda: np.eye(10, dtype=np.uint8),
    "zero_row": lambda: np.vstack([np.zeros((1, 10), np.uint8),
                                   _random(1, 2, 10)]),
    "random_3x5": lambda: _random(2, 3, 5),
    "random_16x16": lambda: _random(3, 16, 16),
    "random_1x16": lambda: _random(4, 1, 16),
    "random_16x1": lambda: _random(5, 16, 1),
}


def _rows(m):
    return tuple(tuple(int(c) for c in r) for r in m)


@pytest.mark.parametrize("name", list(MATRICES))
def test_plain_apply_matches_pallas_and_reference(name):
    m = MATRICES[name]()
    net = gf_network.network_for(m)
    rng = np.random.default_rng(sum(map(ord, name)))
    # columns are independent: one interpret-mode Pallas call (one trace)
    # over all widths side by side, each width's own slice compared
    data = rng.integers(0, 256, (m.shape[1], sum(WIDTHS)), dtype=np.uint8)
    pallas = np.asarray(make_apply_pallas(_rows(m), interpret=True)(
        jnp.asarray(data)))
    start = 0
    for b in WIDTHS:
        part = torch.from_numpy(np.ascontiguousarray(data[:, start:start + b]))
        got = gf_network.plain_apply(net, part)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (m.shape[0], b)
        assert np.array_equal(got.numpy(), pallas[:, start:start + b]), b
        assert torch.equal(got, rs_cuda.gf_apply_reference(m, part)), b
        start += b


def test_zero_row_gives_zero_planes():
    m = MATRICES["zero_row"]()
    net = gf_network.network_for(m)
    assert all(p == () for p in net.planes[:8])
    assert all(p for p in net.planes[8:])
    data = torch.from_numpy(_random(9, 10, 77))
    assert not gf_network.plain_apply(net, data)[0].any()


@pytest.mark.parametrize("which", ["parity", "plan[0, 1, 2, 3]"])
def test_plain_apply_batched_and_sweep_match_pallas(which):
    m = MATRICES[which]()
    net = gf_network.network_for(m)
    pallas = make_apply_pallas(_rows(m), interpret=True)
    rng = np.random.default_rng(len(which))
    data = rng.integers(0, 256, (3, 10, 513), dtype=np.uint8)
    want = rs_cuda.gf_apply_batched_reference(m, torch.from_numpy(data))
    for v in range(3):
        got = gf_network.plain_apply(net, torch.from_numpy(data[v]))
        assert torch.equal(got, want[v]), v
        assert np.array_equal(got.numpy(),
                              np.asarray(pallas(jnp.asarray(data[v])))), v
    # bench.py:104's sweep: windows shifted by `shift` columns of one buffer
    width, k, shift = 300, 4, 33
    buf = rng.integers(0, 256, (10, width + (k - 1) * shift), dtype=np.uint8)
    sweep = rs_cuda.gf_sweep_reference(m, torch.from_numpy(buf), width, k,
                                       shift)
    for kk in range(k):
        window = np.ascontiguousarray(buf[:, kk * shift: kk * shift + width])
        got = gf_network.plain_apply(net, torch.from_numpy(window))
        assert torch.equal(got, sweep[kk]), kk
        assert np.array_equal(got.numpy(),
                              np.asarray(pallas(jnp.asarray(window)))), kk


def _terms(block: str) -> int:
    return len(re.findall(r"p\[[0-7]\]", block))


@pytest.mark.parametrize("name", ["parity", "plan[0, 1, 2, 3]", "identity",
                                  "random_16x16"])
def test_generated_block_names_the_ones_of_bit_matrix(name):
    m = MATRICES[name]()
    bits = gf256.bit_matrix(m)
    block = gf_network.network_block(gf_network.network_for(m))
    assert _terms(block) == int(bits.sum())
    # each statement names exactly the ones of its output plane and source;
    # the first source to feed a plane assigns it, later ones XOR into it
    fed = set()
    for j, body in re.findall(r"case (\d+):\n(.*?)break;", block, re.S):
        for o, op, expr in re.findall(r"acc\[(\d+)\] (\^?=) (.*?);", body):
            ls = [int(x) for x in re.findall(r"p\[(\d)\]", expr)]
            want = [l for l in range(8) if bits[int(o), 8 * int(j) + l]]
            assert ls == want, (name, j, o)
            assert (op == "=") == (o not in fed), (name, j, o)
            fed.add(o)
    if name == "parity":
        assert _terms(block) == 1224
        assert block.count("case ") == 10


def test_network_ops_hand_counts():
    t = gf_network.TRANSPOSE_OPS
    assert t == 60
    # x1: each output plane takes one input plane, moves only
    assert gf_network.network_ops(np.array([[1]], np.uint8)) == 2 * t
    # x2: planes 2, 3 and 4 take two terms (bit l-1 and bit 7): one op each
    assert gf_network.network_ops(np.array([[2]], np.uint8)) == 2 * t + 3
    # all zero: nothing to XOR, the transposes remain
    assert gf_network.network_ops(np.array([[0]], np.uint8)) == 2 * t
    # [1 1]: plane k = a_k (a move) then ^= b_k (one op each)
    assert gf_network.network_ops(np.array([[1, 1]], np.uint8)) == 3 * t + 8
    ops = gf_network.network_ops(gf256.rs_parity_matrix(10, 4))
    assert 14 * t < ops < 14 * t + 1224  # fused: fewer than the ones


def test_cache_key_follows_matrix_and_template_only():
    text = gf_network.template()
    flags = _build.NVRTC_FLAGS

    def key(m, t=text, f=flags):
        return gf_network.cache_key(
            t, gf_network.generated_part(gf_network.network_for(m)), f)
    parity = gf256.rs_parity_matrix(10, 4)
    k = key(parity)
    assert len(k) == 64
    assert key(np.array(parity, dtype=np.int64)) == k  # same matrix
    assert key(np.asfortranarray(parity)) == k
    other = parity.copy()
    other[0, 0] ^= 1
    assert key(other) != k
    assert key(_plan((0, 1, 2, 3))) != k
    assert key(parity, t=text + "\n// edited\n") != k
    assert key(parity, f=flags + ("-lineinfo",)) != k


def test_kernel_source_splices_the_block_once():
    net = gf_network.network_for(gf256.rs_parity_matrix(10, 4))
    src = gf_network.kernel_source(net)
    assert src.startswith("#define GF_ROWS 4\n#define GF_SRCS 10\n")
    assert gf_network.BLOCK_MARKER not in src
    assert gf_network.network_block(net) in src
    assert "#include" not in src  # NVRTC compiles it without headers
    with pytest.raises(ValueError):
        gf_network.kernel_source(net, template_text="no marker here")
    with pytest.raises(ValueError):
        gf_network.network_for(np.zeros((17, 2), np.uint8))


_HARNESS = r"""
// the CUDA template on the host: one thread at a time, in grid order
struct uint4 { unsigned x, y, z, w; };
struct D3 { unsigned x, y, z; };
static D3 blockIdx, threadIdx, gridDim;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#include "kernel.cu"
extern "C" void run(const u8* in, i64 in_stride, i64 in_bstride, u8* out,
                    i64 out_stride, i64 out_bstride, i64 B, i64 V, int mode,
                    unsigned grid_y) {
  gridDim = {(unsigned)((B + GF_TILE - 1) / GF_TILE), grid_y, 1};
  for (unsigned y = 0; y < grid_y; ++y)
    for (unsigned x = 0; x < gridDim.x; ++x)
      for (unsigned t = 0; t < GF_THREADS; ++t) {
        blockIdx = {x, y, 0};
        threadIdx = {t, 0, 0};
        gf_bitslice(in, in_stride, in_bstride, out, out_stride, out_bstride,
                    B, V, mode);
      }
}
"""


@pytest.mark.parametrize("name", ["parity", "plan[2, 3, 11, 12]"])
def test_kernel_template_on_the_host_compiler(name, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    m = MATRICES[name]()
    (tmp_path / "kernel.cu").write_text(
        gf_network.kernel_source(gf_network.network_for(m)))
    (tmp_path / "harness.cpp").write_text(_HARNESS)
    so = tmp_path / "kernel_host.so"
    subprocess.run([gxx, "-O1", "-shared", "-fPIC", "-w", "-o", str(so),
                    str(tmp_path / "harness.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    ll = ctypes.c_longlong
    lib.run.argtypes = [ctypes.c_void_p, ll, ll, ctypes.c_void_p, ll, ll, ll,
                        ll, ctypes.c_int, ctypes.c_uint]
    r = m.shape[0]
    rng = np.random.default_rng(len(name))
    # widths about the 32-byte group and the 8192-column tile, each access
    # path (2: 16-byte vectors, 1: words, 0: bytes); the byte path also
    # takes rows at odd offsets
    for b in (1, 31, 32, 33, 4097, 8192, 8193):
        for mode in (2, 1, 0):
            base = rng.integers(0, 256, (10, b + 1), dtype=np.uint8)
            data = base[:, 1:] if mode == 0 else base[:, :b]
            out = np.full((r, b), 0xA5, np.uint8)
            lib.run(data.ctypes.data, base.shape[1], 0, out.ctypes.data, b,
                    r * b, b, 1, mode, 1)
            want = rs_cuda.gf_apply_reference(
                m, torch.from_numpy(np.ascontiguousarray(data)))
            assert np.array_equal(out, want.numpy()), (b, mode)
    # overlapping input entries, and fewer grid rows than entries
    v, b, shift = 5, 8193, 100
    buf = rng.integers(0, 256, (10, b + (v - 1) * shift), dtype=np.uint8)
    out = np.zeros((v, r, b), np.uint8)
    lib.run(buf.ctypes.data, buf.shape[1], shift, out.ctypes.data, b, r * b,
            b, v, 0, 2)
    want = rs_cuda.gf_sweep_reference(m, torch.from_numpy(buf), b, v, shift)
    assert np.array_equal(out, want.numpy())


def test_compile_cubin_reads_the_disk_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    key = gf_network.cache_key("template", "block", _build.NVRTC_FLAGS)
    image = b"\x7fELF" + bytes(range(60))
    (tmp_path / f"{key[:16]}.cubin").write_bytes(image)
    before = dict(_build.STATS)
    # a cached image is read back without calling the compiler
    assert _build.compile_cubin("not even C++", key, "x.cu") == image
    assert _build.STATS["disk_hits"] == before["disk_hits"] + 1
    assert _build.STATS["compiles"] == before["compiles"]
    stats = rs_cuda.cache_stats()
    assert {"compiles", "disk_hits", "memory_hits", "loads",
            "evictions"} <= set(stats)


def test_compile_cubin_compiles_once_and_keeps_its_log(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    calls = []

    def fake_compile(source, name):
        calls.append(name)
        return (b"\x7fELF cubin of " + source.encode(),
                "ptxas info: Used 64 registers")
    monkeypatch.setattr(_build, "_nvrtc_compile", fake_compile)
    key = gf_network.cache_key("template", "block 2", _build.NVRTC_FLAGS)
    before = dict(_build.STATS)
    image = _build.compile_cubin("src", key, "k.cu")
    assert image == b"\x7fELF cubin of src" and calls == ["k.cu"]
    assert _build.STATS["compiles"] == before["compiles"] + 1
    assert _build.COMPILE_SECONDS[key] >= 0
    assert "Used 64 registers" in _build.COMPILE_LOGS[key]
    assert (tmp_path / f"{key[:16]}.cubin").read_bytes() == image
    # the second call reads the image the first one wrote
    assert _build.compile_cubin("src", key, "k.cu") == image
    assert calls == ["k.cu"]
    assert _build.STATS["disk_hits"] == before["disk_hits"] + 1


def test_compile_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    key = gf_network.cache_key("template", "other", _build.NVRTC_FLAGS)
    before = dict(_build.STATS)
    try:
        _build.nvrtc_path()
    except RuntimeError:
        # no toolkit on this host: the build raises, nothing falls back
        with pytest.raises(RuntimeError, match="nvrtc"):
            _build.compile_cubin("__global__ void k() {}", key, "k.cu")
    else:
        with pytest.raises(RuntimeError, match="NVRTC compile failed"):
            _build.compile_cubin("this is not C++", key, "k.cu")
    assert _build.STATS == before
    assert not list(tmp_path.iterdir())  # no image left behind
