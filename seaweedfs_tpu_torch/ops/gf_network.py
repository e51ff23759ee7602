"""The GF(2^8) matrix apply as a bit-sliced XOR network, device-free.

A GF(2^8) product is linear over GF(2): `gf256.bit_matrix` expands an
(R, S) matrix into its (8R, 8S) 0/1 form, whose row 8i+k says which input
bit-planes 8j+l XOR into bit k of output row i.  The CUDA kernel
(csrc/gf_bitslice.cu) works on that form.  Each thread holds 32 bytes of a
source row as 8 uint32 words, transposes them in registers into 8
bit-planes (plane l = bit l of each of the 32 bytes), XORs planes into the
8R output planes by a straight-line block generated here for one matrix,
and transposes the output planes back into bytes.  The doubling chain of
the SWAR design is folded into the constant matrix, as the TPU kernel
folds its matrix in when it is traced (rs_pallas.make_apply_pallas, one
kernel per `rows` tuple): one kernel is built per matrix.

This module holds what the kernel's arithmetic is made of, with no device:
  * `network_for(matrix)`: for each output plane, the input planes it XORs;
  * `network_block(net)`: the kernel's generated XOR block;
  * `kernel_source(net)`: the template with that block spliced in, and
    `cache_key`, the name of its compiled image;
  * `network_ops(matrix)`: the operations the design issues per 32-column
    group, for the operations bound;
  * `plain_apply(net, data)`: the network run on a CPU or CUDA tensor
    exactly as the kernel runs it (32-byte groups of 8 words, the same
    delta-swap transpose, the same XORs), the design's plain version.
"""

from __future__ import annotations

import functools
import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from . import gf256
from ._build import CSRC_DIR

TEMPLATE_PATH = os.path.join(CSRC_DIR, "gf_bitslice.cu")
KERNEL_NAME = "gf_bitslice"
BLOCK_MARKER = "// @network@"
MAX_ROWS = 16  # the kernel's limits on R and S
MAX_SRCS = 16
GROUP_BYTES = 32  # columns per thread and source: 8 uint32 words
# one 8x8 bit transpose of the byte lanes of 8 words: 3 rounds of 4
# delta swaps, each a shift, a LOP3 ((a ^ b) & m), an XOR, a shift, an XOR
TRANSPOSE_OPS = 3 * 4 * 5
# (words apart, mask) of the three rounds; pairs (a, a + d) with bit d of a
# clear
_ROUNDS = ((4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555))


@dataclass(frozen=True)
class Network:
    """planes[8i+k]: the input planes 8j+l XORed into bit k of output row
    i, ascending; an empty tuple is a zero plane."""
    rows: int
    srcs: int
    planes: tuple[tuple[int, ...], ...]


def _matrix(matrix) -> np.ndarray:
    m = np.asarray(matrix)
    if m.ndim != 2 or not 1 <= m.shape[0] <= MAX_ROWS \
            or not 1 <= m.shape[1] <= MAX_SRCS:
        raise ValueError(
            f"GF matrix must be (R<={MAX_ROWS}, S<={MAX_SRCS}), got {m.shape}")
    return np.ascontiguousarray(m, dtype=np.uint8)


def network_for(matrix) -> Network:
    """The XOR network of an (R <= 16, S <= 16) uint8 GF(2^8) matrix, read
    from gf256.bit_matrix."""
    m = _matrix(matrix)
    bits = gf256.bit_matrix(m)
    planes = tuple(tuple(int(x) for x in np.flatnonzero(row)) for row in bits)
    return Network(rows=m.shape[0], srcs=m.shape[1], planes=planes)


def _terms_by_source(net: Network):
    """-> [(j, [(o, first, [l, ...]), ...]), ...]: for source j, each output
    plane o it feeds, whether j is the first source to feed o (the kernel
    assigns instead of XORing), and the planes l of source j it takes."""
    seen = set()
    out = []
    for j in range(net.srcs):
        feeds = []
        for o, plane in enumerate(net.planes):
            ls = [p - 8 * j for p in plane if p // 8 == j]
            if ls:
                feeds.append((o, o not in seen, ls))
                seen.add(o)
        out.append((j, feeds))
    return out


def network_block(net: Network) -> str:
    """The kernel's generated block: one `case j:` of the source loop's
    switch per source, `acc[o] = p[l] ^ ...` for the source that first
    feeds output plane o and `acc[o] ^= p[l] ^ ...` for the others."""
    lines = []
    for j, feeds in _terms_by_source(net):
        lines.append(f"      case {j}:")
        for o, first, ls in feeds:
            expr = " ^ ".join(f"p[{l}]" for l in ls)
            lines.append(f"        acc[{o}] {'=' if first else '^='} {expr};")
        lines.append("        break;")
    return "\n".join(lines)


@functools.cache
def template() -> str:
    with open(TEMPLATE_PATH) as f:
        return f.read()


def _defines(net: Network) -> str:
    return f"#define GF_ROWS {net.rows}\n#define GF_SRCS {net.srcs}\n"


def generated_part(net: Network) -> str:
    """What is generated for one matrix: its shape and its XOR block."""
    return _defines(net) + network_block(net)


def kernel_source(net: Network, template_text: str | None = None) -> str:
    """The template with the matrix's shape defined ahead of it and its
    XOR block in place of the marker line."""
    text = template() if template_text is None else template_text
    if text.count(BLOCK_MARKER) != 1:
        raise ValueError(f"the template must hold {BLOCK_MARKER!r} once")
    return _defines(net) + text.replace(BLOCK_MARKER, network_block(net))


def cache_key(template_text: str, generated: str, flags) -> str:
    """sha256 of (template, generated part, compiler flags): the name of a
    compiled kernel on disk."""
    h = hashlib.sha256()
    for part in (template_text, generated, " ".join(flags)):
        h.update(part.encode())
        h.update(b"\0")
    return h.hexdigest()


def network_ops(matrix) -> int:
    """Operations the kernel issues per 32-column group: one transpose per
    source row in and per output row out, and the XOR block counted as
    nvcc fuses it, three inputs to a LOP3 (`acc ^= a ^ b` is one; a first
    `acc = a` is a register move and costs none)."""
    net = network_for(matrix)
    xors = 0
    for _, feeds in _terms_by_source(net):
        for _, first, ls in feeds:
            # n terms: ceil((n - 1) / 2) LOP3s after `acc =`, ceil(n / 2)
            # after `acc ^=`
            xors += len(ls) // 2 if first else (len(ls) + 1) // 2
    return TRANSPOSE_OPS * (net.srcs + net.rows) + xors


def _transpose8(w: list[torch.Tensor]) -> list[torch.Tensor]:
    """The kernel's transpose8 on int64 tensors holding uint32 words: an
    8x8 bit transpose of each byte lane across the 8 words (an
    involution)."""
    w = list(w)
    for d, mask in _ROUNDS:
        for a in range(8):
            if a & d:
                continue
            t = ((w[a] >> d) ^ w[a + d]) & mask
            w[a + d] = w[a + d] ^ t
            w[a] = w[a] ^ (t << d)
    return w


def plain_apply(net: Network, data: torch.Tensor) -> torch.Tensor:
    """(S, B) uint8 -> (R, B) uint8, on the tensor's device, as the kernel
    computes it: 32-byte groups of 8 little-endian words per source row,
    transposed into planes, the network's XORs, transposed back."""
    if data.dtype != torch.uint8 or data.ndim != 2 \
            or data.shape[0] != net.srcs:
        raise ValueError(f"data must be ({net.srcs}, B) uint8, got "
                         f"{data.dtype} {tuple(data.shape)}")
    s, b = data.shape
    groups = -(-b // GROUP_BYTES)
    padded = torch.zeros((s, groups * GROUP_BYTES), dtype=torch.uint8,
                         device=data.device)
    padded[:, :b] = data
    by = padded.reshape(s, groups, 8, 4).to(torch.int64)
    words = by[..., 0] | (by[..., 1] << 8) | (by[..., 2] << 16) \
        | (by[..., 3] << 24)  # (S, G, 8)
    planes = []
    for j in range(s):
        planes += _transpose8([words[j, :, w] for w in range(8)])
    zero = torch.zeros((groups,), dtype=torch.int64, device=data.device)
    acc = []
    for plane in net.planes:
        x = zero
        for p in plane:
            x = x ^ planes[p]
        acc.append(x)
    out = torch.empty((net.rows, groups, 8, 4), dtype=torch.uint8,
                      device=data.device)
    for i in range(net.rows):
        ys = _transpose8(acc[8 * i: 8 * i + 8])
        for w in range(8):
            for q in range(4):
                out[i, :, w, q] = ((ys[w] >> (8 * q)) & 0xFF).to(torch.uint8)
    return out.reshape(net.rows, groups * GROUP_BYTES)[:, :b]
