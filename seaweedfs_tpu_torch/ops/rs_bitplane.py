"""GF(2^8) matrix apply in bit-planes on the GPU — the port of
ops/rs_jax.py::make_apply_mxu and of parallel/mesh.py's `_bit_unpack` /
`_bit_pack`.

Over GF(2) the codec is linear in bits: unpack the (S, B) bytes into
(8S, B) 0/1 int8 planes, multiply by the (8R, 8S) 0/1 matrix
`gf256.bit_matrix` with int32 sums, take each sum's parity (& 1) and pack
the (8R, B) planes back into (R, B) bytes.  The int32 sums may be added
across devices before the parity (XOR is addition mod 2), which is how
parallel/mesh.py::distributed_reconstruct splits the shard axis.

* `bit_unpack` and `bit_pack` are hand-written kernels (csrc/gf_bitplane.cu,
  one nvcc build) on CUDA tensors, or raise; on CPU tensors they run
  their plain versions, `bit_unpack_reference` and `bit_pack_reference`.
* `bit_matmul` is the product between them: `torch._int_mm` on the int8
  tensor cores on a card (the reference leaves its `dot_general` to XLA,
  outside any Pallas kernel), an int32 matrix product on the CPU.
  `_int_mm` on CUDA wants more than 16 rows and a width that is a
  multiple of 8: a one- or two-row plan is padded with zero rows, and the
  unpack pads the width with zero columns, both trimmed by the pack.  Its
  cuBLASLt product refuses a row-major second operand on the H100
  (CUBLAS_STATUS_NOT_SUPPORTED), so the unpack writes the planes column
  by column.
* `gf_apply_bitplane` is the whole route; `gf_apply_bitplane_reference`
  its plain version, a transcription of make_apply_mxu (:81-103).

This route moves ~30x the bytes of the function it computes (the planes
and the int32 sums pass through device memory): it is there for the
reference's formulation and its distributed decode, not for speed.
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
# torch._int_mm on CUDA wants more than 16 rows: a plan of 1 or 2 rows
# (8 or 16 planes) is padded with zero rows to 24, a multiple of 8
_INT_MM_MIN_ROWS = 24


def padded_width(width: int) -> int:
    """The product's width for `width` columns: a multiple of 8."""
    return -(-width // 8) * 8


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = load("gf_bitplane")
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.bit_unpack_launch.argtypes = [p, ll, p, ll, ll, ll, i, p]
            lib.bit_pack_launch.argtypes = [p, ll, p, ll, ll, ll, i, p]
            lib.bit_unpack_launch.restype = i
            lib.bit_pack_launch.restype = i
            _LIB = lib
        return _LIB


def build_kernel() -> None:
    """Build (nvcc) and load the kernels' library now, not at first use."""
    _lib()


def _count(fn, label: str) -> None:
    with _COUNT_LOCK:
        fn.launches += 1
    _LAUNCHES_METRIC.labels(label).inc()


def _rows_contiguous(t: torch.Tensor, what: str) -> int:
    """-> t's row stride; raises unless each row is contiguous."""
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"each {what} row must be contiguous")
    stride = t.stride(0) if t.shape[0] > 1 else t.shape[1]
    if stride < t.shape[1]:
        raise ValueError(f"{what} row stride {stride} < width {t.shape[1]}")
    return stride


# -- unpack -----------------------------------------------------------------


def _check_unpack(data: torch.Tensor, width) -> int:
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"data must be a torch.Tensor, got {type(data)}")
    if data.dtype != torch.uint8 or data.ndim != 2:
        raise ValueError(
            f"data must be 2-D uint8, got {data.dtype} {tuple(data.shape)}")
    b = data.shape[1]
    w = b if width is None else int(width)
    if w < b:
        raise ValueError(f"width {w} < the data's {b} columns")
    return w


def bit_unpack_reference(data: torch.Tensor, width: "int | None" = None
                         ) -> torch.Tensor:
    """(S, B) uint8 -> (8S, width) int8: plane 8j + l holds bit l of row
    j (rs_jax.py:88-90), columns past B zero."""
    w = _check_unpack(data, width)
    s, b = data.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((data[:, None, :] >> shifts[None, :, None]) & 1).to(torch.int8)
    out = torch.zeros((8 * s, w), dtype=torch.int8, device=data.device)
    out[:, :b] = bits.reshape(8 * s, b)
    return out


def bit_unpack(data: torch.Tensor, width: "int | None" = None
               ) -> torch.Tensor:
    """(S, B) uint8 -> (8S, width) int8 bit-planes (width >= B, the extra
    columns zero), one launch of csrc/gf_bitplane.cu on a CUDA tensor.
    There the planes are stored column by column (the transpose of a
    (width, 8S) tensor): the layout torch._int_mm's cuBLASLt product takes
    for its second operand."""
    w = _check_unpack(data, width)
    if data.device.type == "cpu":
        return bit_unpack_reference(data, w)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    s, b = data.shape
    stride = _rows_contiguous(data, "data")
    out = torch.empty((w, 8 * s), dtype=torch.int8, device=data.device)
    if s == 0 or w == 0:
        return out.t()
    err = _lib().bit_unpack_launch(
        data.data_ptr(), stride, out.data_ptr(), s, b, w,
        data.device.index, torch.cuda.current_stream(data.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bit_unpack launch failed: cudaError {err}")
    _count(bit_unpack, "bit_unpack")
    return out.t()


bit_unpack.launches = 0  # kernel launches since the last reset


# -- pack -------------------------------------------------------------------


def _check_pack(acc: torch.Tensor, width) -> int:
    if not isinstance(acc, torch.Tensor):
        raise TypeError(f"sums must be a torch.Tensor, got {type(acc)}")
    if acc.ndim != 2 or acc.dtype not in (torch.int32, torch.int8,
                                          torch.uint8):
        raise ValueError(f"sums must be 2-D int32, got {acc.dtype} "
                         f"{tuple(acc.shape)}")
    if acc.shape[0] % 8:
        raise ValueError(f"{acc.shape[0]} planes is not a multiple of 8")
    b = acc.shape[1] if width is None else int(width)
    if not 0 <= b <= acc.shape[1]:
        raise ValueError(f"width {b} outside the sums' {acc.shape[1]}")
    return b


def bit_pack_reference(acc: torch.Tensor, width: "int | None" = None
                       ) -> torch.Tensor:
    """(8R, W) sums -> (R, width) uint8 of their parities: bit k of byte
    (i, c) is acc[8i + k, c] & 1 (rs_jax.py:97-101)."""
    b = _check_pack(acc, width)
    r8 = acc.shape[0]
    p = (acc[:, :b] & 1).to(torch.uint8).reshape(r8 // 8, 8, b)
    out = p[:, 0, :].clone()
    for k in range(1, 8):
        out |= p[:, k, :] << k
    return out


def bit_pack(acc: torch.Tensor, width: "int | None" = None) -> torch.Tensor:
    """(8R, W) int32 sums -> (R, width) uint8 of their parities (the first
    `width` columns), one launch of csrc/gf_bitplane.cu on a CUDA tensor;
    rows must be contiguous, their stride is free."""
    b = _check_pack(acc, width)
    if acc.device.type == "cpu":
        return bit_pack_reference(acc, b)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    if acc.dtype != torch.int32:
        raise ValueError(f"the kernel packs int32 sums, got {acc.dtype}")
    r = acc.shape[0] // 8
    stride = acc.stride(0) if acc.shape[0] > 1 else acc.shape[1]
    if acc.shape[1] > 1 and acc.stride(1) != 1:
        raise ValueError("each row of sums must be contiguous")
    out = torch.empty((r, b), dtype=torch.uint8, device=acc.device)
    if r == 0 or b == 0:
        return out
    err = _lib().bit_pack_launch(
        acc.data_ptr(), stride, out.data_ptr(), b, r, b, acc.device.index,
        torch.cuda.current_stream(acc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bit_pack launch failed: cudaError {err}")
    _count(bit_pack, "bit_pack")
    return out


bit_pack.launches = 0  # kernel launches since the last reset


# -- the product ------------------------------------------------------------

_BITS: dict = {}  # (matrix bytes, shape, device, rows) -> int8 bit matrix
_BITS_LOCK = threading.Lock()


def bit_matrix_tensor(matrix, device, min_rows: int = 0) -> torch.Tensor:
    """gf256.bit_matrix(matrix) as an (max(8R, min_rows), 8S) int8 tensor
    on `device`, zero rows below the 8R real ones; cached."""
    m = coefficients(matrix)
    device = torch.device(device)
    key = (m.shape, m.tobytes(), str(device), min_rows)
    with _BITS_LOCK:
        t = _BITS.get(key)
    if t is None:
        a = gf256.bit_matrix(m).astype(np.int8)
        rows = max(a.shape[0], min_rows)
        full = np.zeros((rows, a.shape[1]), dtype=np.int8)
        full[:a.shape[0]] = a
        t = torch.from_numpy(full).to(device)
        with _BITS_LOCK:
            if len(_BITS) > 1024:
                _BITS.clear()
            _BITS[key] = t
    return t


def bit_matmul(a: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 0/1 x (K, N) int8 0/1 -> (M, N) int32 sums.  On a card
    `torch._int_mm` (M > 16, K and N multiples of 8: pad with
    bit_matrix_tensor's min_rows and padded_width; `bits` column-major, as
    bit_unpack gives it); on the CPU an int32 matrix product."""
    if a.device.type == "cpu":
        return a.to(torch.int32) @ bits.to(torch.int32)
    return torch._int_mm(a, bits)


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


def gf_apply_bitplane(matrix, data: torch.Tensor) -> torch.Tensor:
    """(R, S) GF matrix x (S, B) uint8 -> (R, B) uint8 through the
    bit-plane route: bit_unpack, bit_matmul, bit_pack (two kernel launches
    and one `_int_mm` on a CUDA tensor; on a CPU tensor each step runs its
    plain version)."""
    m = coefficients(matrix)
    _check_data(m, data)
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    b = data.shape[1]
    r = m.shape[0]
    if b == 0:
        return torch.empty((r, 0), dtype=torch.uint8, device=data.device)
    on_card = data.device.type == "cuda"
    bits = bit_unpack(data, padded_width(b))
    acc = bit_matmul(bit_matrix_tensor(
        m, data.device, _INT_MM_MIN_ROWS if on_card else 0), bits)
    return bit_pack(acc[:8 * r], b)
