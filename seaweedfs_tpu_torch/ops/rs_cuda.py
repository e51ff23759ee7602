"""GF(2^8) matrix apply on the GPU — the port of ops/rs_pallas.py and of
the sweep kernel of bench.py:104.

`gf_apply(matrix, data)` computes out[i] = XOR_j matrix[i][j] * data[j] over
GF(2^8) for an (R, S) uint8 coefficient matrix and an (S, B) uint8 tensor.
`gf_apply_batched(matrix, data)` does the same for each entry of a
(V, S, B) tensor in one launch, and `gf_sweep` runs it over K windows of one
(S, B + (K-1)*shift) buffer, each shifted by `shift` columns.  On a CUDA
tensor each launches the matrix's own hand-written kernel, the bit-sliced
XOR network of csrc/gf_bitslice.cu built for sm_90a at the matrix's first
use (gf_network.py generates it, _build.py compiles and caches it,
`kernel_for` holds it loaded), or raises; on a CPU tensor it runs the plain
PyTorch version (`gf_apply_reference`, `gf_apply_batched_reference`,
`gf_sweep_reference`), which the tests and chip_smoke.py also hold the
kernel against.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..stats.metrics import CUDA_KERNEL_LAUNCHES as _LAUNCHES_METRIC
from . import _build, gf256, gf_network
from ._build import load

MAX_ROWS = gf_network.MAX_ROWS  # the kernel's limits on R and S
MAX_SRCS = gf_network.MAX_SRCS
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
            lib = load("gf_launch")
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            for fn, args in (
                    ("gf_bs_load", [p, ctypes.c_char_p, i,
                                    ctypes.POINTER(p), ctypes.POINTER(p)]),
                    ("gf_bs_unload", [p, i]),
                    ("gf_bs_launch", [p, i, i, p, ll, ll, p, ll, ll, ll, ll,
                                      i, p])):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = i
            _LIB = lib
        return _LIB


class _Kernel:
    """One matrix's compiled kernel, loaded: its library and kernel
    handles."""

    def __init__(self, m: np.ndarray, device: int):
        net = gf_network.network_for(m)
        text = gf_network.template()
        self.key = gf_network.cache_key(
            text, gf_network.generated_part(net), _build.NVRTC_FLAGS)
        self.device = device
        image = _build.compile_cubin(gf_network.kernel_source(net, text),
                                     self.key, "gf_bitslice.cu")
        lib, kernel = ctypes.c_void_p(), ctypes.c_void_p()
        err = _lib().gf_bs_load(image, gf_network.KERNEL_NAME.encode(),
                                device, ctypes.byref(lib),
                                ctypes.byref(kernel))
        if err != 0:
            raise RuntimeError(f"loading the {m.shape} GF kernel failed: "
                               f"cudaError {err}")
        self.library, self.kernel = lib.value, kernel.value
        self.image = image  # held while the library may read it


_KERNELS: "OrderedDict[tuple, _Kernel]" = OrderedDict()
_KERNELS_MAX = 256  # loaded kernels held in process, least recently used out
_KERNEL_LOCK = threading.Lock()
_BUILD_LOCK = threading.Lock()
KERNEL_STATS = {"memory_hits": 0, "loads": 0, "evictions": 0}


def kernel_for(matrix, device: int = 0) -> _Kernel:
    """The loaded kernel of an (R, S) matrix on CUDA device `device`: from
    memory, else from the disk cache or NVRTC (see _build), then loaded.
    Raises if it does not compile or load."""
    m = coefficients(matrix)
    while True:
        key = _ensure(m, device)
        with _KERNEL_LOCK:
            k = _KERNELS.get(key)
        if k is not None:
            return k


def _ensure(m: np.ndarray, device: int) -> tuple:
    """Load m's kernel into the table unless it is there; -> its key.  A
    kernel pushed out of the table is unloaded under the table's lock, so
    no launch of it is under way (launches hold the lock)."""
    key = (device, m.shape, m.tobytes())
    with _KERNEL_LOCK:
        if key in _KERNELS:
            _KERNELS.move_to_end(key)
            KERNEL_STATS["memory_hits"] += 1
            return key
    with _BUILD_LOCK:  # one build per matrix, even when threads race
        with _KERNEL_LOCK:
            if key in _KERNELS:
                KERNEL_STATS["memory_hits"] += 1
                return key
        k = _Kernel(m, device)  # compiles outside the table's lock
        with _KERNEL_LOCK:
            _KERNELS[key] = k
            KERNEL_STATS["loads"] += 1
            while len(_KERNELS) > _KERNELS_MAX:
                old = _KERNELS.popitem(last=False)[1]
                _lib().gf_bs_unload(old.library, old.device)
                KERNEL_STATS["evictions"] += 1
    return key


def _launch(m: np.ndarray, data: torch.Tensor, row_stride: int,
            entry_stride: int, out: torch.Tensor, out_stride: int,
            out_entry_stride: int, b: int, v: int) -> None:
    """One launch of m's kernel on the current stream of data's device."""
    device = data.device.index
    stream = torch.cuda.current_stream(data.device).cuda_stream
    while True:
        key = _ensure(m, device)
        with _KERNEL_LOCK:
            k = _KERNELS.get(key)
            if k is None:  # pushed out by other threads' builds meanwhile
                continue
            err = _lib().gf_bs_launch(
                k.kernel, m.shape[0], m.shape[1], data.data_ptr(),
                row_stride, entry_stride, out.data_ptr(), out_stride,
                out_entry_stride, b, v, device, stream)
        break
    if err != 0:
        raise RuntimeError(f"gf_bitslice launch failed: cudaError {err}")


def cache_stats() -> dict:
    """The kernel cache's counters: compiles and disk hits (_build.STATS),
    then loads, memory hits and evictions of the loaded-kernel table."""
    with _KERNEL_LOCK:
        return {**_build.STATS, **KERNEL_STATS, "loaded": len(_KERNELS)}


def build_kernel(device: int = 0) -> None:
    """Build the host library and the RS(10,4) parity kernel, which every
    encode runs, now instead of at first launch."""
    kernel_for(gf256.rs_parity_matrix(10, 4), device)


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
    _launch(m, data, row_stride, 0, out, b, 0, b, 1)
    with _COUNT_LOCK:
        gf_apply.launches += 1
    _LAUNCHES_METRIC.labels("gf_matmul").inc()
    return out


gf_apply.launches = 0  # kernel launches since the last reset to 0


def _check_batched(m: np.ndarray, data: torch.Tensor) -> None:
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"data must be a torch.Tensor, got {type(data)}")
    if data.dtype != torch.uint8 or data.ndim != 3:
        raise ValueError(
            f"data must be 3-D uint8, got {data.dtype} {tuple(data.shape)}")
    if data.shape[1] != m.shape[1]:
        raise ValueError(
            f"matrix has {m.shape[1]} columns but data entries have "
            f"{data.shape[1]} rows")


def gf_apply_batched_reference(matrix, data: torch.Tensor) -> torch.Tensor:
    """The plain version of gf_apply_batched: gf_apply_reference on each
    entry.  (V, S, B) uint8 -> (V, R, B) uint8."""
    m = coefficients(matrix)
    _check_batched(m, data)
    out = torch.empty((data.shape[0], m.shape[0], data.shape[2]),
                      dtype=torch.uint8, device=data.device)
    for v in range(data.shape[0]):
        out[v] = gf_apply_reference(m, data[v])
    return out


def gf_apply_batched(matrix, data: torch.Tensor) -> torch.Tensor:
    """(R, S) GF matrix x each (S, B) entry of a (V, S, B) uint8 tensor ->
    (V, R, B) uint8, in ONE kernel launch on a CUDA tensor.

    Rows must be contiguous; row and entry strides are free, and entries
    may overlap (gf_sweep's windows do).  Every output entry is its own
    slice of a fresh (V, R, B) tensor, so no two entries share an output
    byte.  CPU tensors go through gf_apply_batched_reference."""
    m = coefficients(matrix)
    _check_batched(m, data)
    if data.device.type == "cpu":
        return gf_apply_batched_reference(m, data)
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
    _launch(m, data, row_stride, entry_stride, out, b, r * b, b, v)
    with _COUNT_LOCK:
        gf_apply_batched.launches += 1
    _LAUNCHES_METRIC.labels("gf_matmul_batched").inc()
    return out


gf_apply_batched.launches = 0  # batched launches since the last reset to 0


def _sweep_windows(m: np.ndarray, buf: torch.Tensor, width: int,
                   sweeps: int, shift: int) -> torch.Tensor:
    """Validate a sweep and return its (K, S, width) window view of buf."""
    _check_data(m, buf)
    if width < 0 or sweeps < 1 or shift < 0:
        raise ValueError(
            f"need width >= 0, sweeps >= 1, shift >= 0; got {width}, "
            f"{sweeps}, {shift}")
    need = width + (sweeps - 1) * shift
    if buf.shape[1] < need:
        raise ValueError(f"buffer has {buf.shape[1]} columns, the sweep "
                         f"reads {need}")
    if buf.shape[1] > 1 and buf.stride(1) != 1:
        raise ValueError("each buffer row must be contiguous")
    return buf.as_strided((sweeps, buf.shape[0], width),
                          (shift, buf.stride(0), 1), buf.storage_offset())


def gf_sweep_reference(matrix, buf: torch.Tensor, width: int, sweeps: int,
                       shift: int) -> torch.Tensor:
    """The plain version of gf_sweep: gf_apply_reference on each window."""
    m = coefficients(matrix)
    _sweep_windows(m, buf, width, sweeps, shift)
    return torch.stack([gf_apply_reference(m, buf[:, k * shift:
                                                  k * shift + width])
                        for k in range(sweeps)])


def gf_sweep(matrix, buf: torch.Tensor, width: int, sweeps: int,
             shift: int) -> torch.Tensor:
    """K full matrix applies over shifted windows of one buffer, in ONE
    launch: (S, width + (K-1)*shift) -> (K, R, width), where entry k is the
    product with buf[:, k*shift : k*shift + width].  This is the kernel of
    bench.py:104, whose (K, G) grid read the input window shifted by k
    blocks on sweep k; there one output was rewritten K times and kept
    window K-1, here each sweep has its own output entry (entry K-1 is what
    bench.py leaves), because CUDA blocks run in no order."""
    m = coefficients(matrix)
    return gf_apply_batched(m, _sweep_windows(m, buf, width, sweeps, shift))


def parity_fn(data_shards: int = 10, parity_shards: int = 4):
    """The RS parity instance: (data_shards, B) -> (parity_shards, B)."""
    m = gf256.rs_parity_matrix(data_shards, parity_shards)
    return lambda data: gf_apply(m, data)
