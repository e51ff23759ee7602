"""GF(2^8) matrix apply as an XOR network on the GPU — the port of
ops/rs_jax.py::make_apply_xor (`_multiples`, `_xor_network`).

`gf_apply_xor_batched(matrix, data)` computes out[v][i] = XOR_j
matrix[i][j] * data[v][j] over GF(2^8) for an (R, S) uint8 matrix and each
(S, B) entry of a (V, S, B) uint8 tensor in one launch; `gf_apply_xor` is
its V = 1 case.  On a CUDA tensor it launches the hand-written kernel of
csrc/gf_xor.cu (the doubling chain x*2^k and the XOR of the multiples each
coefficient's bits select, the coefficients passed as a kernel argument,
so one nvcc build serves every matrix), or raises; on a CPU tensor it runs
the plain PyTorch version, `gf_apply_xor_reference`, a transcription of
`_multiples` and `_xor_network`, which the tests and chip_smoke.py also
hold the kernel against.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..stats.metrics import CUDA_KERNEL_LAUNCHES as _LAUNCHES_METRIC
from ._build import load
from .rs_cuda import _check_batched, _check_data, coefficients

_REDUCE = 0x1D  # low byte of the field polynomial 0x11D
_LIB: "ctypes.CDLL | None" = None
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _multiples(data: torch.Tensor) -> list[torch.Tensor]:
    """[data * 2^k for k in 0..7], the doubling chain (rs_jax.py:40)."""
    ms = [data]
    x = data
    for _ in range(7):
        x = (x << 1) ^ ((x >> 7) * _REDUCE)
        ms.append(x)
    return ms


def gf_apply_xor_reference(matrix, data: torch.Tensor) -> torch.Tensor:
    """The plain version (rs_jax.py:54): (S, B) uint8 -> (R, B) uint8, the
    XOR of the multiples each coefficient's bits select."""
    m = coefficients(matrix)
    _check_data(m, data)
    ms = _multiples(data)
    outs = []
    for row in m:
        acc = None
        for j, c in enumerate(row):
            for k in range(8):
                if (int(c) >> k) & 1:
                    term = ms[k][j]
                    acc = term.clone() if acc is None else acc ^ term
        outs.append(acc if acc is not None else torch.zeros_like(data[0]))
    return torch.stack(outs)


def gf_apply_xor_batched_reference(matrix, data: torch.Tensor
                                   ) -> torch.Tensor:
    """The plain version of gf_apply_xor_batched, entry by entry."""
    m = coefficients(matrix)
    _check_batched(m, data)
    if data.shape[0] == 0:
        return torch.empty((0, m.shape[0], data.shape[2]), dtype=torch.uint8,
                           device=data.device)
    return torch.stack([gf_apply_xor_reference(m, data[v])
                        for v in range(data.shape[0])])


def xor_ops(matrix, width: int, entries: int = 1) -> int:
    """The 32-bit operations the kernel issues for `entries` (S, width)
    entries: per source row and 16 columns, 7 doublings of 4 words (5
    operations each), a test of each of the 8R coefficient bits, and 4
    XORs per set bit of the row's coefficients."""
    m = coefficients(matrix)
    r, s = m.shape
    set_bits = sum(bin(int(c)).count("1") for c in m.flat)
    per_chunk = s * (7 * 4 * 5 + 8 * r) + 4 * set_bits
    return per_chunk * -(-width // 16) * entries


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = load("gf_xor")
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.gf_xor_launch.argtypes = [p, ll, ll, p, ll, ll, ll, ll, i, i,
                                          ctypes.c_char_p, i, p]
            lib.gf_xor_launch.restype = i
            _LIB = lib
        return _LIB


def build_kernel() -> None:
    """Build (nvcc) and load the kernel's library now, not at first use."""
    _lib()


def gf_apply_xor_batched(matrix, data: torch.Tensor) -> torch.Tensor:
    """(R, S) GF matrix x each (S, B) entry of a (V, S, B) uint8 tensor ->
    (V, R, B) uint8, in ONE launch of csrc/gf_xor.cu on a CUDA tensor.

    Rows must be contiguous; row and entry strides and alignment are
    free.  CPU tensors go through the plain version; anything else
    raises, as does a failed build or launch."""
    m = coefficients(matrix)
    _check_batched(m, data)
    if data.device.type == "cpu":
        return gf_apply_xor_batched_reference(m, data)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    v, s, b = data.shape
    if b > 1 and data.stride(2) != 1:
        raise ValueError("each data row must be contiguous (stride(2) == 1)")
    row_stride = data.stride(1) if s > 1 else b
    if row_stride < b:
        raise ValueError(f"row stride {row_stride} < width {b}")
    entry_stride = data.stride(0) if v > 1 else 0
    r = m.shape[0]
    out = torch.empty((v, r, b), dtype=torch.uint8, device=data.device)
    if b == 0 or v == 0:
        return out
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = _lib().gf_xor_launch(
        data.data_ptr(), row_stride, entry_stride, out.data_ptr(), b, r * b,
        b, v, r, s, m.tobytes(), data.device.index, stream)
    if err != 0:
        raise RuntimeError(f"gf_xor launch failed: cudaError {err}")
    with _COUNT_LOCK:
        gf_apply_xor_batched.launches += 1
    _LAUNCHES_METRIC.labels("gf_xor").inc()
    return out


gf_apply_xor_batched.launches = 0  # kernel launches since the last reset


def gf_apply_xor(matrix, data: torch.Tensor) -> torch.Tensor:
    """(R, S) GF matrix x (S, B) uint8 tensor -> (R, B) uint8: the batched
    entry with one entry (one launch on a CUDA tensor)."""
    m = coefficients(matrix)
    _check_data(m, data)
    return gf_apply_xor_batched(m, data.unsqueeze(0))[0]

