"""GF(2^8) arithmetic and Reed-Solomon generator-matrix construction.

The field is GF(2^8) with the reduction polynomial x^8+x^4+x^3+x^2+1 (0x11D)
and generator element 2 — the field of the klauspost/reedsolomon codec that
SeaweedFS calls from weed/storage/erasure_coding/ec_encoder.go.  The
generator matrix is built with the same algorithm (Vandermonde rows `r^c`,
normalised so the top square is the identity), so parity is byte-identical
to the reference codec and to `seaweedfs_tpu.ops.gf256`, of which this is
the port's own copy.

Everything here is plain numpy on the host: matrices hold at most 16x16
entries.  The bulk byte work is the CUDA kernel in rs_cuda.py.  The one
function a degraded-read storm or a rebuild hammers, decode_plan_for, keeps
its per-survivor-set LRU.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict

import numpy as np

POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1


def _generate_tables() -> tuple[np.ndarray, np.ndarray]:
    """Build exp/log tables for GF(2^8) with generator 2."""
    exp = np.zeros(255, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    log[0] = -1  # undefined; never read for 0
    return exp, log


EXP_TABLE, LOG_TABLE = _generate_tables()


@functools.cache
def mul_table() -> np.ndarray:
    """Full 256x256 GF multiplication table (64KB), uint8."""
    la = LOG_TABLE[np.arange(256, dtype=np.int32)]
    s = (la[:, None] + la[None, :]) % 255
    t = EXP_TABLE[s]
    t[0, :] = 0
    t[:, 0] = 0
    return t


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(EXP_TABLE[(int(LOG_TABLE[a]) - int(LOG_TABLE[b])) % 255])


def gf_inv(a: int) -> int:
    return gf_div(1, a)


def gf_exp(a: int, n: int) -> int:
    """a**n in GF(2^8) with the reference codec's galExp semantics:
    n==0 -> 1 (even for a==0); a==0 -> 0 otherwise."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(int(LOG_TABLE[a]) * n) % 255])


# ---------------------------------------------------------------------------
# Matrix algebra over GF(2^8).  Matrices are small numpy uint8 2-D arrays.
# ---------------------------------------------------------------------------


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF matrix product (small matrices, host side)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} x {b.shape}")
    t = mul_table()
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        out[i] = np.bitwise_xor.reduce(t[a[i][:, None], b], axis=0)
    return out


def mat_identity(n: int) -> np.ndarray:
    m = np.zeros((n, n), dtype=np.uint8)
    np.fill_diagonal(m, 1)
    return m


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan elimination."""
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"not square: {m.shape}")
    work = np.concatenate([m.astype(np.uint8), mat_identity(n)], axis=1)
    t = mul_table()
    for col in range(n):
        if work[col, col] == 0:
            for r in range(col + 1, n):
                if work[r, col] != 0:
                    work[[col, r]] = work[[r, col]]
                    break
            else:
                raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        pivot = int(work[col, col])
        if pivot != 1:
            work[col] = t[gf_inv(pivot), work[col]]
        for r in range(n):
            if r != col and work[r, col] != 0:
                work[r] ^= t[int(work[r, col]), work[col]]
    return work[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """vm[r, c] = r**c in GF(2^8) — the reference codec's starting matrix."""
    vm = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            vm[r, c] = gf_exp(r, c)
    return vm


@functools.cache
def rs_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """The (total x data) encoding matrix whose top square is the identity
    (Vandermonde normalised by the inverse of its top square)."""
    vm = vandermonde(total_shards, data_shards)
    m = mat_mul(vm, mat_inv(vm[:data_shards]))
    m.setflags(write=False)
    return m


@functools.cache
def rs_parity_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """Just the parity rows: (parity x data)."""
    p = rs_matrix(data_shards, data_shards + parity_shards)[data_shards:].copy()
    p.setflags(write=False)
    return p


def decode_matrix_for(
    matrix: np.ndarray, data_shards: int, present: list[int]
) -> np.ndarray:
    """The (data x data) matrix that maps the first `data_shards` present
    shards back to the data shards (rows of `matrix` are shard ids): the
    plan whose wanted set is every data shard."""
    return decode_plan_for(
        matrix, data_shards, present, tuple(range(data_shards)))


def decode_plan_for(
    matrix: np.ndarray,
    data_shards: int,
    present: "list[int] | tuple[int, ...]",
    wanted: "list[int] | tuple[int, ...]",
) -> np.ndarray:
    """The (len(wanted) x data_shards) GF matrix mapping the FIRST
    `data_shards` present shards to the `wanted` shard ids — the whole
    decode program for one survivor set, inversion and parity-row
    composition included.

    Cached per (matrix, survivor set, wanted set) in a bounded LRU behind
    one lock: a rebuild or a degraded-read storm decodes many slices
    against the SAME missing shards, and the 10x10 inversion is the
    costly part.  PLAN_STATS counts hits and misses.
    """
    if len(present) < data_shards:
        raise ValueError(
            f"need {data_shards} shards to decode, have {len(present)}")
    sources = tuple(present[:data_shards])
    key = (matrix.shape, matrix.tobytes(), sources, tuple(wanted))
    with _PLAN_LOCK:
        cached = _PLAN_CACHE.get(key)
        if cached is not None:
            _PLAN_CACHE.move_to_end(key)
            PLAN_STATS["hit"] += 1
            return cached
        PLAN_STATS["miss"] += 1
    dec = mat_inv(matrix[np.asarray(sources, dtype=np.int64)])
    plan = np.empty((len(wanted), data_shards), dtype=np.uint8)
    for i, w in enumerate(wanted):
        if w < data_shards:
            plan[i] = dec[w]
        else:
            # parity row composed through the decode matrix (GF product)
            plan[i] = mat_mul(matrix[w:w + 1, :data_shards], dec)[0]
    plan.setflags(write=False)
    with _PLAN_LOCK:
        _PLAN_CACHE[key] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
    return plan


# >= C(14,10)=1001 survivor sets x the few wanted-sets each sees in
# practice; LRU so exotic geometries can never grow it without bound
_PLAN_CACHE_MAX = 4096
_PLAN_CACHE: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
_PLAN_LOCK = threading.Lock()
PLAN_STATS = {"hit": 0, "miss": 0}


def bit_matrix(matrix: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) matrix (R, C) into its GF(2) bit form (8R, 8C):
    A[8i+k, 8j+l] = bit k of (matrix[i, j] * 2^l)."""
    r, c = matrix.shape
    t = mul_table()
    a = np.zeros((8 * r, 8 * c), dtype=np.uint8)
    for i in range(r):
        for j in range(c):
            g = int(matrix[i, j])
            for l in range(8):
                prod = int(t[g, (1 << l)])
                for k in range(8):
                    a[8 * i + k, 8 * j + l] = (prod >> k) & 1
    return a
