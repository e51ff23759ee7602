"""ctypes binding of the native library (CRC32-C, the GF(2^8) SIMD codec) —
the port's copy of seaweedfs_tpu/native/lib.py.

The library is built by ``build.py`` at first use.  The port's CRC32-C and
its ``cpu`` codec run on it; a host where it does not build raises with
g++'s output instead of falling back to a slower path.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import build as _build

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:  # settled: a GIL-atomic read
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build.build())
            lib.sw_crc32c_update.restype = ctypes.c_uint32
            lib.sw_crc32c_update.argtypes = [
                ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]
            lib.sw_gf_apply.restype = None
            lib.sw_gf_apply.argtypes = [
                ctypes.c_char_p,  # matrix rows (R*S bytes)
                ctypes.c_int,  # R
                ctypes.c_int,  # S
                ctypes.POINTER(ctypes.c_void_p),  # inputs
                ctypes.POINTER(ctypes.c_void_p),  # outputs
                ctypes.c_size_t,  # row length
            ]
            lib.sw_gf_impl.restype = ctypes.c_int
            lib.sw_gf_impl.argtypes = []
            _lib = lib
    return _lib


def simd_tier() -> int:
    """The GF path the loaded library runs: 3 GFNI, 1 SSSE3, 0 scalar."""
    return int(_load().sw_gf_impl())


def crc32c_update(crc: int, data) -> int:
    """Unmasked CRC32-C update over any buffer (bytes, bytearray,
    memoryview, contiguous numpy array), without copying it."""
    lib = _load()
    if isinstance(data, bytes):
        return int(lib.sw_crc32c_update(crc, data, len(data)))
    arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data).view(np.uint8)
    arr = arr.reshape(-1)
    if arr.size == 0:
        return crc & 0xFFFFFFFF
    return int(lib.sw_crc32c_update(crc, arr.ctypes.data, arr.size))


def gf_apply_fast(mbytes: bytes, r: int, s: int, inputs, outs, n: int) -> None:
    """The per-job hot path of the codec service: the caller guarantees
    C-contiguous uint8 rows of length `n` and the (r, s) matrix's raw
    bytes; no checks here."""
    lib = _load()
    in_ptrs = (ctypes.c_void_p * s)(*[a.ctypes.data for a in inputs])
    out_ptrs = (ctypes.c_void_p * r)(*[o.ctypes.data for o in outs])
    lib.sw_gf_apply(mbytes, r, s, in_ptrs, out_ptrs, n)


def gf_apply_arrays(matrix_rows, inputs, out=None):
    """GF matrix apply over equal-length 1-D uint8 arrays (validated),
    zero-copy: -> a list of fresh rows, or fills `out` when given."""
    m = np.ascontiguousarray(matrix_rows, dtype=np.uint8)
    r, s = m.shape
    if len(inputs) != s:
        raise ValueError(f"matrix has {s} cols, got {len(inputs)} inputs")
    n = len(inputs[0])
    arrs = []
    for x in inputs:
        a = np.ascontiguousarray(x, dtype=np.uint8)
        if a.ndim != 1 or len(a) != n:
            raise ValueError("inputs must be equal-length 1-D u8 arrays")
        arrs.append(a)
    if out is None:
        out = [np.empty(n, dtype=np.uint8) for _ in range(r)]
    else:
        for o in out:
            if not (isinstance(o, np.ndarray) and o.dtype == np.uint8
                    and o.ndim == 1 and len(o) == n
                    and o.flags["C_CONTIGUOUS"] and o.flags["WRITEABLE"]):
                raise ValueError("outputs must be writable contiguous 1-D "
                                 "u8 arrays of the inputs' length")
    if r == 0 or n == 0:
        return out
    gf_apply_fast(m.tobytes(), r, s, arrs, out, n)
    return out
