"""Multi-device EC: sharded batch encode and the split-shard decode over a
mesh of torch devices — the port of seaweedfs_tpu/parallel/mesh.py.

* `batch_encode_sharded` / `batch_apply_sharded`: (V, S, B) inputs with V
  split over the mesh's ``dp`` axis and the columns B over ``sp``.  Parity
  is columnwise, so each mesh entry computes its own block with no
  collective: one `rs_cuda.gf_apply_batched` launch per entry (the
  batched bit-sliced kernel; the counterpart of the reference's
  `jax.vmap(make_apply_xor(rows))` under a NamedSharding).
* `distributed_reconstruct`: the decode with the SHARD axis S split over
  ``dp`` and B over ``sp``.  In bit-planes GF addition is addition mod 2,
  and the parity of a sum is the XOR of its terms' parities: each entry
  computes the packed partial of its S/dp shards and B/sp columns, (R,
  B/sp) bytes, in one launch of the bit-plane kernel
  (rs_bitplane.gf_apply_bitplane), and the partials of a column block are
  XORed onto the block's first device.  The reference sums int32 partials
  there (its `psum` over ``dp``) and takes the parity after: the same
  bytes, for R bytes a column handed over instead of 32R.

One process drives every device of the mesh, as JAX's single controller
does: the partitioning, the uploads and the cross-device XOR are torch
copies between the entries' devices, each entry's work on its own CUDA
stream.  A mesh may name one device many times (a virtual mesh: the one
card repeated, or the CPU for tests), which runs the same partitioning,
padding and XOR combine on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gf256
from ..ops.rs_bitplane import gf_apply_bitplane
from ..ops.rs_cuda import coefficients, gf_apply_batched
from ..ops.rs_torch import resolve_device


class Mesh:
    """A (dp, sp) grid of torch devices with the axis names ("dp", "sp"):
    `shape["dp"]`, `shape["sp"]` and `devices[d][s]`, as a
    jax.sharding.Mesh of two axes."""

    def __init__(self, devices: list, dp: int, sp: int):
        if len(devices) != dp * sp:
            raise ValueError(f"{len(devices)} devices for a {dp}x{sp} mesh")
        self.devices = [list(devices[d * sp:(d + 1) * sp]) for d in range(dp)]
        self.shape = {"dp": dp, "sp": sp}
        self._streams: dict = {}

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["sp"]

    @property
    def first(self) -> torch.device:
        """The device that holds gathered results."""
        return self.devices[0][0]

    def entries(self):
        """(d, s, device) for every entry, row by row."""
        for d, row in enumerate(self.devices):
            for s, dev in enumerate(row):
                yield d, s, dev

    def stream(self, d: int, s: int) -> "torch.cuda.Stream | None":
        """Entry (d, s)'s own CUDA stream (made at first use), None on the
        CPU."""
        dev = self.devices[d][s]
        if dev.type != "cuda":
            return None
        st = self._streams.get((d, s))
        if st is None:
            st = self._streams[(d, s)] = torch.cuda.Stream(dev)
        return st

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[[str(x) for x in row] for row in self.devices]})")


def make_mesh(devices=None, dp: "int | None" = None,
              shard_axis: int = 10) -> Mesh:
    """2-D mesh: dp (volumes / shard-splitting) x sp (block columns).

    ``dp`` must divide both the device count and the GF shard axis
    (``distributed_reconstruct`` splits S=10 shards over dp).  When not
    given, pick the largest valid dp <= sqrt(n) so the mesh stays balanced:
    n=8 -> (2, 4); n=4 -> (2, 2); n=16 -> (2, 8); odd n -> (1, n).

    The default devices are every visible CUDA card; with none, this
    raises (a CPU mesh is asked for by name: ``[torch.device("cpu")] *
    n``).  A device may appear more than once: a virtual mesh.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA card (torch.cuda.is_available() is "
                "False); pass devices=[torch.device('cpu')] * n to run the "
                "mesh on the host")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("make_mesh: no devices")
    if dp is None:
        dp = 1
        for cand in range(2, int(n**0.5) + 1):
            if n % cand == 0 and shard_axis % cand == 0:
                dp = cand
    elif n % dp or shard_axis % dp:
        raise ValueError(
            f"dp={dp} must divide both device count {n} and "
            f"shard axis {shard_axis}")
    sp = n // dp
    return Mesh(devices[:dp * sp], dp, sp)


def _split(n: int, parts: int) -> list[tuple[int, int]]:
    """[start, stop) of each of `parts` blocks of an axis of n: blocks of
    ceil(n / parts), the last ones shorter or empty (JAX's layout of an
    axis that does not divide evenly)."""
    step = -(-n // parts)
    return [(min(i * step, n), min((i + 1) * step, n)) for i in range(parts)]


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


class _OnEntry:
    """Run a block of work on entry (d, s): its device and its stream,
    which first waits for the work already queued on the device's current
    stream (the inputs may have been written there)."""

    def __init__(self, mesh: Mesh, d: int, s: int):
        self.stream = mesh.stream(d, s)
        self.device = mesh.devices[d][s]
        self._ctx = []

    def __enter__(self):
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            self._ctx = [torch.cuda.device(self.device),
                         torch.cuda.stream(self.stream)]
            for c in self._ctx:
                c.__enter__()
        return self

    def __exit__(self, *exc):
        for c in reversed(self._ctx):
            c.__exit__(*exc)
        return False


def _join_entries(mesh: Mesh, out: torch.Tensor) -> None:
    """Make `out`'s device's current stream wait for every entry's stream."""
    if out.device.type != "cuda":
        return
    current = torch.cuda.current_stream(out.device)
    for d, s, _dev in mesh.entries():
        st = mesh.stream(d, s)
        if st is not None:
            current.wait_stream(st)


# ---------------------------------------------------------------------------
# Batch encode: pure data/sequence parallel, no collectives.
# ---------------------------------------------------------------------------


def apply_per_entry(mesh: Mesh, matrix, v: int, b: int, fill, take
                    ) -> list:
    """The one per-entry dispatch of a (V, S, B) batch over the mesh: V
    splits over ``dp``, B over ``sp`` (an axis that does not divide evenly
    gives its last entries less, or none), and each entry makes one
    gf_apply_batched launch on its own device and stream.

    ``fill(device, v0, v1, b0, b1)`` returns the entry's (v1-v0, S, b1-b0)
    uint8 block on ``device``; ``take(v0, b0, y)`` receives the entry's
    (v1-v0, R, b1-b0) result, still on the entry's stream.  -> one event
    per entry that ran, recorded after its ``take`` ([] on the CPU)."""
    m = coefficients(matrix)
    vs, bs = _split(v, mesh.shape["dp"]), _split(b, mesh.shape["sp"])
    events = []
    for d, sc, dev in mesh.entries():
        (v0, v1), (b0, b1) = vs[d], bs[sc]
        if v0 == v1 or b0 == b1:
            continue
        with _OnEntry(mesh, d, sc) as entry:
            take(v0, b0, gf_apply_batched(m, fill(dev, v0, v1, b0, b1)))
            if entry.stream is not None:
                done = torch.cuda.Event()
                done.record()
                events.append(done)
    return events


def batch_apply_sharded(mesh: Mesh, matrix: np.ndarray, batch
                        ) -> torch.Tensor:
    """Apply one (R, S) GF matrix to (V, S, B) batched inputs (numpy or a
    tensor) over the mesh (`apply_per_entry`).  -> the (V, R, B) uint8
    result, gathered on the mesh's first device."""
    m = coefficients(matrix)
    batch = _as_tensor(batch)
    if batch.ndim != 3:
        raise ValueError(f"batch must be (V, S, B), got {tuple(batch.shape)}")
    v, _s, b = batch.shape
    if mesh.size == 1:
        return gf_apply_batched(m, batch.to(mesh.first, non_blocking=True))
    out = torch.empty((v, m.shape[0], b), dtype=torch.uint8,
                      device=mesh.first)

    def fill(dev, v0, v1, b0, b1):
        return batch[v0:v1, :, b0:b1].to(dev, non_blocking=True)

    def take(v0, b0, y):
        out[v0:v0 + y.shape[0], :, b0:b0 + y.shape[2]].copy_(
            y, non_blocking=True)

    apply_per_entry(mesh, m, v, b, fill, take)
    _join_entries(mesh, out)
    return out


def batch_encode_sharded(mesh: Mesh, volumes, data_shards: int = 10,
                         parity_shards: int = 4) -> torch.Tensor:
    """Encode (V, data_shards, B) -> (V, parity_shards, B) over the mesh:
    V over ``dp``, B over ``sp``; the stripe axis stays local."""
    return batch_apply_sharded(
        mesh, gf256.rs_parity_matrix(data_shards, parity_shards), volumes)


# ---------------------------------------------------------------------------
# Distributed decode: shard axis split over dp, packed partials XORed.
# ---------------------------------------------------------------------------


def distributed_reconstruct(mesh: Mesh, matrix: np.ndarray, inputs
                            ) -> torch.Tensor:
    """Apply an (R, S) GF matrix to (S, B) inputs with S split over ``dp``
    and B over ``sp``: each entry's packed partial, one gf_apply_bitplane
    of its S/dp rows and B/sp columns on its own stream, the partials of a
    column block XORed on the block's first device.  -> (R, B) uint8 on
    the mesh's first device.  S must divide by dp (10 and 2 in practice);
    B that does not divide by sp gives its last entries less."""
    m = coefficients(matrix)
    inputs = _as_tensor(inputs)
    r, s = m.shape
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if s % dp:
        raise ValueError(f"shard axis {s} not divisible by dp={dp}")
    if inputs.ndim != 2 or inputs.shape[0] != s:
        raise ValueError(f"inputs must be ({s}, B), got "
                         f"{tuple(inputs.shape)}")
    b = inputs.shape[1]
    sl = s // dp
    out = torch.empty((r, b), dtype=torch.uint8, device=mesh.first)
    for sc, (b0, b1) in enumerate(_split(b, sp)):
        if b0 == b1:
            continue
        total = None
        for d in range(dp):
            dev = mesh.devices[d][sc]
            with _OnEntry(mesh, d, sc):
                x = inputs[d * sl:(d + 1) * sl, b0:b1]
                partial = gf_apply_bitplane(m[:, d * sl:(d + 1) * sl],
                                            x.to(dev, non_blocking=True))
                if total is None:
                    total = partial
                    root = (d, sc)
                    continue
            # the combine: this entry's partial joins the block's first
            # one, on that entry's stream, after this entry's work
            with _OnEntry(mesh, *root):
                stream = mesh.stream(d, sc)
                if stream is not None:
                    torch.cuda.current_stream(total.device).wait_stream(
                        stream)
                    partial.record_stream(
                        torch.cuda.current_stream(total.device))
                total ^= partial.to(total.device, non_blocking=True)
        with _OnEntry(mesh, *root):
            out[:, b0:b1].copy_(total, non_blocking=True)
    _join_entries(mesh, out)
    return out


# ---------------------------------------------------------------------------
# The "full training step" analogue: encode a sharded batch of volumes AND
# run a distributed decode — exercises dp, sp shardings and the dp sum.
# ---------------------------------------------------------------------------


def train_step(mesh: Mesh, volumes, decode_inputs, decode_matrix
               ) -> tuple[torch.Tensor, torch.Tensor]:
    parity = batch_encode_sharded(mesh, volumes)
    rebuilt = distributed_reconstruct(mesh, decode_matrix, decode_inputs)
    return parity, rebuilt
