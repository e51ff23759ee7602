"""File-level batch EC encode and mesh rebuild — the port of
seaweedfs_tpu/parallel/batch.py.

BASELINE config 4 ("batch ec.encode of 64 volumes sharded across a
slice") as a user-facing flow: N volumes are encoded by concurrent
per-volume `generate_ec_files` runs that share one device-mode codec
service on the mesh.  The service stacks the slices that the volumes
have in flight at once into one (V, 10, W) batch and dispatches it over
the mesh (V over ``dp``, columns over ``sp``, no collective: parity is
columnwise); on a 1x1 mesh a batch is one batched launch.  The shard
files are the per-volume encoder's, byte for byte, whatever the sizes.

``slice_size`` is the TOTAL per-shard budget of the volumes encoded at
once: each volume's slice is that over the volumes in flight, as the
reference narrows its per-volume slice as the batch widens.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops import gf256
from ..ops.codec_service import CodecService
from ..storage.ec.constants import (
    DATA_SHARDS,
    LARGE_BLOCK_SIZE,
    SMALL_BLOCK_SIZE,
    TOTAL_SHARDS,
    to_ext,
)
from ..storage.ec.encoder import DEFAULT_SLICE, _read_at, generate_ec_files
from .mesh import distributed_reconstruct, make_mesh

# volumes encoded at once: enough in flight for the service to fill a
# batch, few enough to bound the page-locked slice buffers
VOLUMES_AT_ONCE = 8


def batch_generate_ec_files(
    bases: list[str],
    mesh=None,
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
    slice_size: int = DEFAULT_SLICE,
    progress=None,
) -> None:
    """Encode every `<base>.dat` into `<base>.ec00`..`.ec13`, batched.

    `progress(volume_bytes_done_total)` fires after each volume's slice
    hits its output files (real bytes only, padding excluded).
    """
    if not bases:
        return
    if not any(os.path.getsize(b + ".dat") for b in bases):
        # all volumes empty: empty shard files, no device touch
        for base in bases:
            for i in range(TOTAL_SHARDS):
                open(base + to_ext(i), "wb").close()
        return
    if mesh is None:
        # the mesh must exist BEFORE the shard files open 'wb': a device
        # failure here must not truncate existing shards
        mesh = make_mesh()
    at_once = min(len(bases), VOLUMES_AT_ONCE)
    # total budget -> per-volume slice, floored to one small block so row
    # batching still engages
    per_vol_slice = max(slice_size // at_once, small_block_size)
    codec_name = "cuda" if mesh.first.type == "cuda" else "torch_cpu"
    lock = threading.Lock()
    done = dict.fromkeys(bases, 0)

    def encode(base: str) -> None:
        def on_progress(volume_done: int) -> None:
            with lock:
                done[base] = volume_done
                if progress is not None:
                    progress(sum(done.values()))

        generate_ec_files(base, large_block_size, small_block_size,
                          codec_name=codec_name, slice_size=per_vol_slice,
                          service=service, progress=on_progress)

    service = CodecService(mode="device", mesh=mesh)
    try:
        with ThreadPoolExecutor(at_once,
                                thread_name_prefix="batch-ec") as pool:
            futures = [pool.submit(encode, base) for base in bases]
        for fut in futures:
            fut.result()  # the first volume's failure, in volume order
    finally:
        service.close()


def mesh_rebuild_ec_files(
    base_name: str,
    mesh=None,
    slice_size: int = DEFAULT_SLICE,
    progress=None,
) -> list[int]:
    """Regenerate missing `.ecNN` files with the decode sharded over the
    mesh: the survivors' shard axis splits over ``dp`` (packed partial
    bit-plane products XORed over ``dp``), columns over ``sp``.

    The same file semantics as storage.ec.encoder.rebuild_ec_files and
    byte-identical output, but the GF work runs as one distributed decode
    per slice.  Missing parity rows are composed into the same
    survivor->wanted matrix (parity = generator row x decode matrix over
    GF), so data and parity shards rebuild in a single dispatch.

    `progress(shard_bytes_done)` mirrors the serial rebuild's callback.
    """
    present = [i for i in range(TOTAL_SHARDS)
               if os.path.exists(base_name + to_ext(i))]
    missing = [i for i in range(TOTAL_SHARDS) if i not in present]
    if not missing:
        return []
    if len(present) < DATA_SHARDS:
        raise ValueError(
            f"cannot rebuild: only {len(present)} of {TOTAL_SHARDS} "
            "shards present")
    if mesh is None:
        mesh = make_mesh()
    sp = mesh.shape["sp"]

    sub = present[:DATA_SHARDS]  # survivors actually read, in shard order
    matrix = gf256.rs_matrix(DATA_SHARDS, TOTAL_SHARDS)
    dec = gf256.decode_matrix_for(matrix, DATA_SHARDS, present)
    # survivor -> wanted rows: data rows straight from the decode matrix,
    # parity rows composed through it (GF matrix product)
    rows = np.stack([
        dec[i] if i < DATA_SHARDS
        else gf256.mat_mul(matrix[i:i + 1, :DATA_SHARDS], dec)[0]
        for i in missing
    ]).astype(np.uint8)

    shard_size = os.path.getsize(base_name + to_ext(sub[0]))
    ins = {i: open(base_name + to_ext(i), "rb") for i in sub}
    outs = {i: open(base_name + to_ext(i), "wb") for i in missing}
    try:
        for off in range(0, shard_size, slice_size):
            width = min(slice_size, shard_size - off)
            # columns must split evenly over sp
            w_pad = -(-width // sp) * sp
            inputs = np.zeros((DATA_SHARDS, w_pad), dtype=np.uint8)
            for row, i in enumerate(sub):
                inputs[row, :width] = _read_at(ins[i], off, width)
            rebuilt = distributed_reconstruct(mesh, rows, inputs).cpu()
            rebuilt = rebuilt.numpy()
            for row, i in enumerate(missing):
                outs[i].write(np.ascontiguousarray(rebuilt[row, :width]))
            if progress is not None:
                progress(off + width)
    finally:
        for h in ins.values():
            h.close()
        for h in outs.values():
            h.close()
    return missing
