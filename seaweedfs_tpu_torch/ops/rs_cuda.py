"""GF(2^8) matrix apply on the GPU — the port of ops/rs_pallas.py.

`gf_apply(matrix, data)` computes out[i] = XOR_j matrix[i][j] * data[j] over
GF(2^8) for an (R, S) uint8 coefficient matrix and an (S, B) uint8 tensor.
On a CUDA tensor it launches the hand-written kernel csrc/gf_matmul.cu
(built for sm_90a at first use) or raises; on a CPU tensor it runs the
plain PyTorch version, `gf_apply_reference`, which the tests and
chip_smoke.py also hold the kernel against.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import gf256
from ._build import load

MAX_ROWS = 16  # the kernel's limits on R and S
MAX_SRCS = 16
_REDUCE = 0x1D  # low byte of the field polynomial 0x11D

_LIB: "ctypes.CDLL | None" = None
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def coefficients(matrix) -> np.ndarray:
    """Validate an (R, S) GF(2^8) matrix and return it as a C-contiguous
    uint8 numpy array — the form every entry point of this module takes."""
    m = np.asarray(matrix)
    if m.ndim != 2 or not 1 <= m.shape[0] <= MAX_ROWS \
            or not 1 <= m.shape[1] <= MAX_SRCS:
        raise ValueError(
            f"GF matrix must be (R<={MAX_ROWS}, S<={MAX_SRCS}), got {m.shape}")
    if m.dtype != np.uint8:
        if np.issubdtype(m.dtype, np.integer) and m.size \
                and (m.min() < 0 or m.max() > 255):
            raise ValueError("GF(2^8) coefficients must lie in 0..255")
        if not np.issubdtype(m.dtype, np.integer):
            raise ValueError(f"GF matrix dtype {m.dtype} is not integer")
        m = m.astype(np.uint8)
    return np.ascontiguousarray(m)


def gf_apply_reference(matrix, data: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the doubling chain of rs_jax._multiples
    and the XOR network of rs_jax._xor_network, on uint8 tensors of any
    device.  (S, B) uint8 -> (R, B) uint8, computed source by source so the
    working set is one row plus the outputs."""
    m = coefficients(matrix)
    _check_data(m, data)
    out = torch.zeros((m.shape[0], data.shape[1]), dtype=torch.uint8,
                      device=data.device)
    for j in range(m.shape[1]):
        col = [int(c) for c in m[:, j]]
        top = max((c.bit_length() for c in col), default=0)
        x = data[j]
        for k in range(top):
            if k:
                x = (x << 1) ^ ((x >> 7) * _REDUCE)
            for i, c in enumerate(col):
                if (c >> k) & 1:
                    out[i] ^= x
    return out


def _check_data(m: np.ndarray, data: torch.Tensor) -> None:
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"data must be a torch.Tensor, got {type(data)}")
    if data.dtype != torch.uint8 or data.ndim != 2:
        raise ValueError(
            f"data must be 2-D uint8, got {data.dtype} {tuple(data.shape)}")
    if data.shape[0] != m.shape[1]:
        raise ValueError(
            f"matrix has {m.shape[1]} columns but data has {data.shape[0]} rows")


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = load("gf_matmul")
            lib.gf_matmul.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_void_p,
            ]
            lib.gf_matmul.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def build_kernel() -> None:
    """Build (or load) the kernel's library now instead of at first launch."""
    _lib()


def gf_apply(matrix, data: torch.Tensor) -> torch.Tensor:
    """(R, S) GF matrix x (S, B) uint8 tensor -> (R, B) uint8 tensor.

    CUDA tensors go through the kernel on the current stream; rows may have
    any row stride >= B and any alignment, but each row must be contiguous.
    CPU tensors go through gf_apply_reference.  Anything else raises.
    """
    m = coefficients(matrix)
    _check_data(m, data)
    if data.device.type == "cpu":
        return gf_apply_reference(m, data)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    b = data.shape[1]
    if b > 1 and data.stride(1) != 1:
        raise ValueError("each data row must be contiguous (stride(1) == 1)")
    row_stride = data.stride(0) if m.shape[1] > 1 else b
    if row_stride < b:
        raise ValueError(f"row stride {row_stride} < width {b}")
    out = torch.empty((m.shape[0], b), dtype=torch.uint8, device=data.device)
    if b == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = lib.gf_matmul(
        m.ctypes.data, m.shape[0], m.shape[1],
        data.data_ptr(), row_stride, out.data_ptr(), b, b,
        data.device.index, stream)
    if err != 0:
        raise RuntimeError(f"gf_matmul launch failed: cudaError {err}")
    with _COUNT_LOCK:
        gf_apply.launches += 1
    return out


gf_apply.launches = 0  # kernel launches since the last reset to 0


def parity_fn(data_shards: int = 10, parity_shards: int = 4):
    """The RS parity instance: (data_shards, B) -> (parity_shards, B)."""
    m = gf256.rs_parity_matrix(data_shards, parity_shards)
    return lambda data: gf_apply(m, data)
