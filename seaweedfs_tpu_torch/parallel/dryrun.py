"""The multi-device dry run — the port of
`__graft_entry__.py::dryrun_multichip`: one sharded step over an n-entry
mesh (volumes over ``dp``, columns over ``sp``, and the distributed decode
whose shard axis splits over ``dp``, its partials XORed), then the file
flows on the same mesh (a 16-volume batch encode of uneven sizes and a
4-data-shard rebuild), every result checked against the host `cpu`
codec.

It runs on n visible cards when there are n; otherwise on a virtual mesh
of the one card named n times, or of the CPU when the caller asks for it
(`device="cpu"`).  Without a card it raises unless the CPU was asked for:
it never moves from the card to the host on its own.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..ops import gf256
from ..ops.rs_cpu import ReedSolomon
from ..ops.rs_torch import resolve_device
from ..storage.ec.constants import TOTAL_SHARDS, to_ext
from ..storage.ec.encoder import generate_ec_files
from .batch import batch_generate_ec_files, mesh_rebuild_ec_files
from .mesh import make_mesh, train_step

# the reference's 16 volumes of deliberately uneven sizes: the dp padding,
# per-volume tail trimming and shared-step geometry all engage
_SIZES = (5000, 1777, 9010, 64, 4097, 12288, 333, 7000,
          2048, 10001, 512, 6149, 3333, 8191, 1500, 11111)


def mesh_devices(n_devices: int, device=None) -> tuple[list, bool]:
    """-> (the n devices of the dry run's mesh, whether it is virtual).
    `device` None: n cards if visible, else the one card n times (raises
    without a card); otherwise that device n times."""
    if device is not None:
        return [resolve_device(device)] * n_devices, True
    if not torch.cuda.is_available():
        raise RuntimeError(
            "dryrun_multidevice: no CUDA card (torch.cuda.is_available() "
            "is False); pass device='cpu' for a virtual CPU mesh")
    count = torch.cuda.device_count()
    if count >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)], False
    return [resolve_device("cuda")] * n_devices, True


def dryrun_multidevice(n_devices: int, device=None) -> dict:
    """Run the full sharded step and the file flows over an n-entry mesh
    and verify them against the `cpu` codec; -> a summary (mesh shape,
    devices, virtual).  Raises AssertionError on a wrong byte."""
    devices, virtual = mesh_devices(n_devices, device)
    mesh = make_mesh(devices)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]

    rng = np.random.default_rng(42)
    v = 2 * dp  # volumes axis divisible by dp
    b = 128 * sp  # block axis divisible by sp
    volumes = rng.integers(0, 256, (v, 10, b)).astype(np.uint8)

    # decode: shards 0..3 lost; the decode matrix over survivors 4..13
    matrix = gf256.rs_matrix(10, 14)
    present = list(range(4, 14))
    dec = gf256.decode_matrix_for(matrix, 10, present)

    rs = ReedSolomon()
    full = [volumes[0, i] for i in range(10)] + [
        np.zeros(b, dtype=np.uint8) for _ in range(4)]
    rs.encode(full)
    survivors = np.stack([full[i] for i in present])

    parity, rebuilt = train_step(mesh, volumes, survivors, dec)
    parity = parity.cpu().numpy()
    rebuilt = rebuilt.cpu().numpy()
    assert parity.shape == (v, 4, b)
    for i in range(4):
        assert np.array_equal(parity[0, i], full[10 + i]), f"parity {i}"
    for i in range(10):
        assert np.array_equal(rebuilt[i], volumes[0, i]), f"rebuilt {i}"

    with tempfile.TemporaryDirectory() as td:
        bases = []
        for i, size in enumerate(_SIZES):
            base = f"{td}/v{i}"
            with open(base + ".dat", "wb") as f:
                f.write(rng.integers(0, 256, size).astype(np.uint8)
                        .tobytes())
            bases.append(base)
        expect = {}
        for base in bases:
            generate_ec_files(base, large_block_size=4096,
                              small_block_size=64, slice_size=256,
                              codec_name="cpu")
            for i in range(TOTAL_SHARDS):
                p = base + to_ext(i)
                with open(p, "rb") as fh:
                    expect[p] = fh.read()
                os.remove(p)
        batch_generate_ec_files(bases, mesh=mesh, large_block_size=4096,
                                small_block_size=64, slice_size=3 * 256)
        for p, want in expect.items():
            with open(p, "rb") as fh:
                assert fh.read() == want, f"batch shard {p} differs"

        # lose the 4 FIRST data shards of one volume (a full decode-matrix
        # inversion) and rebuild them through the distributed decode
        lost = [0, 1, 2, 3]
        for i in lost:
            os.remove(bases[2] + to_ext(i))
        got = mesh_rebuild_ec_files(bases[2], mesh=mesh, slice_size=256)
        assert got == lost, got
        for i in lost:
            p = bases[2] + to_ext(i)
            with open(p, "rb") as fh:
                assert fh.read() == expect[p], f"rebuilt shard {p} differs"

    return {"mesh": dict(mesh.shape), "devices": [str(d) for d in devices],
            "virtual": virtual, "encode": [v, 10, b],
            "file_volumes": len(_SIZES), "rebuilt": lost}
