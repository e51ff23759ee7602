"""GF(2^8) matrix apply as an XOR network on the GPU — the port of
ops/rs_jax.py::make_apply_xor (`_multiples`, `_xor_network`).

`gf_apply_xor_batched(matrix, data)` computes out[v][i] = XOR_j
matrix[i][j] * data[v][j] over GF(2^8) for an (R, S) uint8 matrix and each
(S, B) entry of a (V, S, B) uint8 tensor in one launch; `gf_apply_xor` is
its V = 1 case.  On a CUDA tensor it launches the hand-written kernel of
csrc/gf_xor.cu (the doubling chains x*2^k on the side of the matrix
where the kernel issues fewer operations: Horner's rule on the outputs
for every RS(10,4) plan, the chains on the sources for a tall matrix of
one to three sources; and the XOR of the multiples each coefficient's bits
select; the
coefficients passed as a kernel argument, so one nvcc build serves every
matrix), or raises; on a CPU tensor it runs
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
# the kernel's columns per thread (XOR_CHUNK in csrc/gf_xor.cu; the host
# test checks it) and the operations of one word's doubling (gf_double4)
CHUNK_COLUMNS = 16
DOUBLE_OPS = 4
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


def xor_ops(matrix, width: int, entries: int = 1,
            horner: "bool | None" = None) -> int:
    """The 32-bit operations the kernel issues for `entries` (S, width)
    entries on the side `horner` names (None: the side horner_side
    picks): _chunk_ops per chunk of CHUNK_COLUMNS columns."""
    r, s = coefficients(matrix).shape
    if horner is None:
        horner = horner_side(r, s)
    return _chunk_ops(r, s, horner) * -(-width // CHUNK_COLUMNS) * entries


def _chunk_ops(r: int, s: int, horner: bool) -> int:
    """The operations of one chunk (CHUNK_COLUMNS / 4 words) of an (R, S)
    matrix.  The chains on the outputs (Horner's rule): 7 doublings of
    each output word (DOUBLE_OPS operations each); the XOR combinations of
    each group of 4 sources, one XOR a word an entry (2^n - 1 entries for
    a group of n sources, the first one free); and for each step k and
    output, one XOR a word for each group's entry, read from shared
    memory (8 R G reads of 16 bytes).  The chains on the sources: 7
    doublings of each source word, a test of each of the 8 R S
    coefficient bits, and an XOR a word for each, issued whether the bit
    is set or not (a predicated XOR)."""
    words = CHUNK_COLUMNS // 4
    if horner:
        groups = [min(4, s - 4 * g) for g in range(-(-s // 4))]
        build = sum(2 ** n - 2 for n in groups) * words
        return (r * 7 * words * DOUBLE_OPS + build
                + 8 * r * len(groups) * words)
    return s * 7 * words * DOUBLE_OPS + 8 * r * s * (1 + words)


def horner_side(rows: int, srcs: int) -> bool:
    """Whether the kernel runs the doubling chains on the outputs
    (Horner's rule, gf_xor_horner) rather than on the sources
    (gf_xor_sources): the side of fewer operations (_chunk_ops), the
    outputs' on a tie.  On the card (chip_smoke.py's gf_xor_sides, R in
    {1, 4, 10, 16} x S in {1, 2, 4, 10, 16}) it picked the faster kernel
    at 18 of the 20 shapes in each run; the misses, at R <= 4 and S <= 2,
    within 6 %, where both kernels sit at the launch's floor (PERF.md).
    The one place the choice is made."""
    return _chunk_ops(rows, srcs, True) <= _chunk_ops(rows, srcs, False)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = load("gf_xor")
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.gf_xor_launch.argtypes = [p, ll, ll, p, ll, ll, ll, ll, i, i,
                                          ctypes.c_char_p, i, i, p]
            lib.gf_xor_launch.restype = i
            _LIB = lib
        return _LIB


def build_kernel() -> None:
    """Build (nvcc) and load the kernel's library now, not at first use."""
    _lib()


def gf_apply_xor_batched(matrix, data: torch.Tensor,
                         horner: "bool | None" = None) -> torch.Tensor:
    """(R, S) GF matrix x each (S, B) entry of a (V, S, B) uint8 tensor ->
    (V, R, B) uint8, in ONE launch of csrc/gf_xor.cu on a CUDA tensor.

    Rows must be contiguous; row and entry strides and alignment are
    free.  `horner`: the side the kernel runs the chains on (None: the
    side horner_side picks; True or False to time or check one side).
    CPU tensors go through the plain version; anything else raises, as
    does a failed build or launch."""
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
    if horner is None:
        horner = horner_side(r, s)
    out = torch.empty((v, r, b), dtype=torch.uint8, device=data.device)
    if b == 0 or v == 0:
        return out
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = _lib().gf_xor_launch(
        data.data_ptr(), row_stride, entry_stride, out.data_ptr(), b, r * b,
        b, v, r, s, m.tobytes(), int(horner), data.device.index, stream)
    if err != 0:
        raise RuntimeError(f"gf_xor launch failed: cudaError {err}")
    with _COUNT_LOCK:
        gf_apply_xor_batched.launches += 1
    _LAUNCHES_METRIC.labels("gf_xor").inc()
    return out


gf_apply_xor_batched.launches = 0  # kernel launches since the last reset


def gf_apply_xor(matrix, data: torch.Tensor,
                 horner: "bool | None" = None) -> torch.Tensor:
    """(R, S) GF matrix x (S, B) uint8 tensor -> (R, B) uint8: the batched
    entry with one entry (one launch on a CUDA tensor)."""
    m = coefficients(matrix)
    _check_data(m, data)
    return gf_apply_xor_batched(m, data.unsqueeze(0), horner)[0]

