"""GF(2^8) matrix apply in bit-planes on the GPU — the port of
ops/rs_jax.py::make_apply_mxu and of the per-device step of
parallel/mesh.py::distributed_reconstruct (`_bit_unpack`, `_bit_pack`).

Over GF(2) the codec is linear in bits: unpack the (S, B) bytes into
(8S, B) 0/1 planes, multiply by the (8R, 8S) 0/1 matrix
`gf256.bit_matrix` with integer sums, take each sum's parity (& 1) and
pack the (8R, B) planes back into (R, B) bytes.

* `gf_apply_bitplane` on a CUDA tensor is ONE launch of the hand-written
  kernel of csrc/gf_bitplane.cu (gf_bitplane_mma: the planes made in
  registers, the product on the int8 tensor cores by wgmma, the parities
  packed in the epilogue; neither planes nor sums reach device memory),
  or raises.  On a CPU tensor it runs the plain version.
* `gf_apply_bitplane_reference` is that plain version, a transcription of
  make_apply_mxu (:81-103) from its pieces `bit_unpack_reference` and
  `bit_pack_reference`.
* `operand_tiles` lays the bit matrix out as the kernel's tensor-core
  operand; `operand_tensor` caches it on a device.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..stats.metrics import CUDA_KERNEL_LAUNCHES as _LAUNCHES_METRIC
from . import gf256
from ._build import load
from .rs_cuda import _check_data, coefficients

_LIB: "ctypes.CDLL | None" = None
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
# the weight of output plane k in the kernel's operand: the sum for plane k
# is 2^k times an integer, so bit k is its parity (-128 = 2^7 in int8)
_PLANE_WEIGHTS = np.array([1, 2, 4, 8, 16, 32, 64, -128], dtype=np.int32)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = load("gf_bitplane")
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.gf_bitplane_mma_launch.argtypes = [p, ll, p, ll, i, i, ll, p,
                                                   i, p]
            lib.gf_bitplane_mma_launch.restype = i
            _LIB = lib
        return _LIB


def build_kernel() -> None:
    """Build (nvcc) and load the kernel's library now, not at first use."""
    _lib()


# -- the plain version -------------------------------------------------------


def bit_unpack_reference(data: torch.Tensor) -> torch.Tensor:
    """(S, B) uint8 -> (8S, B) int8: plane 8j + l holds bit l of row j
    (rs_jax.py:88-90)."""
    if data.dtype != torch.uint8 or data.ndim != 2:
        raise ValueError(
            f"data must be 2-D uint8, got {data.dtype} {tuple(data.shape)}")
    s, b = data.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((data[:, None, :] >> shifts[None, :, None]) & 1).to(torch.int8)
    return bits.reshape(8 * s, b)


def bit_pack_reference(acc: torch.Tensor) -> torch.Tensor:
    """(8R, B) sums -> (R, B) uint8 of their parities: bit k of byte (i, c)
    is acc[8i + k, c] & 1 (rs_jax.py:97-101)."""
    if acc.ndim != 2 or acc.shape[0] % 8:
        raise ValueError(f"sums must be (8R, B), got {tuple(acc.shape)}")
    r8, b = acc.shape
    p = (acc & 1).to(torch.uint8).reshape(r8 // 8, 8, b)
    out = p[:, 0, :].clone()
    for k in range(1, 8):
        out |= p[:, k, :] << k
    return out


def gf_apply_bitplane_reference(matrix, data: torch.Tensor) -> torch.Tensor:
    """The plain version (rs_jax.py:81-103): unpack, the 0/1 product with
    int32 sums, & 1, pack.  On a card the product runs in float32 (sums of
    at most 8S <= 128 ones are exact), since CUDA has no int32 matmul."""
    m = coefficients(matrix)
    _check_data(m, data)
    a = torch.from_numpy(gf256.bit_matrix(m).astype(np.int8)).to(data.device)
    bits = bit_unpack_reference(data)
    if data.device.type == "cpu":
        acc = a.to(torch.int32) @ bits.to(torch.int32)
    else:
        acc = (a.float() @ bits.float()).round().to(torch.int32)
    return bit_pack_reference(acc)


# -- the kernel's operand ------------------------------------------------------


def operand_tiles(matrix) -> np.ndarray:
    """The (R, S) matrix as the kernel's B operand (csrc/gf_bitplane.cu):
    int8, one 1024-byte tile per (source group q, output group r4) of 4
    rows each, q-major, in wgmma's K-major layout without swizzle.

    In tile (q, r4), K index 4u + m is bit u of source row 4q + m, and N
    index 8c + n is plane k = 2c + n % 2 of output row 4 r4 + n // 2,
    weighted 2^k (-128 for k = 7); rows past S and R are zero.  Element
    (N, K) sits at byte (N // 8) * 256 + (K // 16) * 128 + (N % 8) * 16 +
    K % 16."""
    m = coefficients(matrix)
    r, s = m.shape
    bits = gf256.bit_matrix(m).astype(np.int32)  # (8R, 8S)
    groups, ngroups = -(-s // 4), -(-r // 4)
    kk, nn = np.arange(32), np.arange(32)
    src_row = 4 * np.arange(groups)[:, None] + kk[None, :] % 4   # (q, K)
    src_bit = np.broadcast_to(kk // 4, src_row.shape)
    plane = 2 * (nn // 8) + nn % 2
    out_row = 4 * np.arange(ngroups)[:, None] + (nn % 8)[None, :] // 2
    valid = ((src_row < s)[:, None, None, :]
             & (out_row < r)[None, :, :, None])  # (q, r4, N, K)
    op = bits[np.minimum(8 * out_row + plane, 8 * r - 1)[None, :, :, None],
              np.minimum(8 * src_row + src_bit, 8 * s - 1)[:, None, None, :]]
    op = np.where(valid, op * _PLANE_WEIGHTS[plane][None, None, :, None],
                  0).astype(np.int8)
    offset = ((nn // 8) * 256 + (nn % 8) * 16)[:, None] \
        + ((kk // 16) * 128 + kk % 16)[None, :]
    tiles = np.zeros((groups, ngroups, 1024), dtype=np.int8)
    tiles[:, :, offset] = op
    return tiles.reshape(-1)


_TILES: dict = {}  # (matrix bytes, shape, device) -> int8 operand tiles
_TILES_LOCK = threading.Lock()


def operand_tensor(matrix, device) -> torch.Tensor:
    """operand_tiles(matrix) on `device`; cached.  The upload is a
    synchronous copy, so any stream may read the tensor at once."""
    m = coefficients(matrix)
    device = torch.device(device)
    key = (m.shape, m.tobytes(), str(device))
    with _TILES_LOCK:
        t = _TILES.get(key)
    if t is None:
        t = torch.from_numpy(operand_tiles(m)).to(device)
        with _TILES_LOCK:
            if len(_TILES) > 1024:
                _TILES.clear()
            _TILES[key] = t
    return t


# -- the kernel ----------------------------------------------------------------


def _row_stride(t: torch.Tensor, what: str) -> int:
    """-> t's row stride; raises unless each row is contiguous."""
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"each {what} row must be contiguous")
    stride = t.stride(0) if t.shape[0] > 1 else t.shape[1]
    if stride < t.shape[1]:
        raise ValueError(f"{what} row stride {stride} < width {t.shape[1]}")
    return stride


def gf_apply_bitplane(matrix, data: torch.Tensor) -> torch.Tensor:
    """(R, S) GF matrix x (S, B) uint8 -> (R, B) uint8 through the
    bit-plane route: one launch of gf_bitplane_mma on a CUDA tensor (rows
    contiguous, their stride and alignment free), the plain version on a
    CPU tensor.  Anything else raises, as does a failed build or launch."""
    m = coefficients(matrix)
    _check_data(m, data)
    if data.device.type == "cpu":
        return gf_apply_bitplane_reference(m, data)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    r, s = m.shape
    b = data.shape[1]
    stride = _row_stride(data, "data")
    out = torch.empty((r, b), dtype=torch.uint8, device=data.device)
    if b == 0:
        return out
    tiles = operand_tensor(m, data.device)
    stream = torch.cuda.current_stream(data.device)
    tiles.record_stream(stream)  # the cache may drop it while queued
    err = _lib().gf_bitplane_mma_launch(
        data.data_ptr(), stride, out.data_ptr(), b, s, r, b,
        tiles.data_ptr(), data.device.index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"gf_bitplane_mma launch failed: cudaError {err}")
    with _COUNT_LOCK:
        gf_apply_bitplane.launches += 1
    _LAUNCHES_METRIC.labels("gf_bitplane_mma").inc()
    return out


gf_apply_bitplane.launches = 0  # kernel launches since the last reset
