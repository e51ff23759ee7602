"""The port's multi-device EC (seaweedfs_tpu_torch/parallel/) held against
the JAX package's on its virtual 8-device CPU mesh.

Mirrors tests/test_parallel.py:16-60 and :110-215.  The port runs on
virtual meshes of CPU entries of the shapes (1, 1), (2, 4), (5, 1) and
(10, 1): the partitioning, the padding and the XOR of the packed
partials over ``dp`` run as on a card, through the kernels' plain
versions.  The reference runs on its own 8-device mesh.  GF arithmetic is
exact, so every comparison is byte equality: the tolerance is zero.
"""

import os

import jax
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as jgf
from seaweedfs_tpu.parallel import batch as jbatch
from seaweedfs_tpu.parallel import mesh as jmesh
from seaweedfs_tpu.storage.ec import encoder as jenc
from seaweedfs_tpu_torch.ops import gf256
from seaweedfs_tpu_torch.parallel import batch as tbatch
from seaweedfs_tpu_torch.parallel import mesh as tmesh
from seaweedfs_tpu_torch.parallel.dryrun import dryrun_multidevice
from seaweedfs_tpu_torch.storage.ec import constants as ecc
from seaweedfs_tpu_torch.storage.ec import encoder as tenc

from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(1, 1), (2, 4), (5, 1), (10, 1)]
CPU = torch.device("cpu")


def _mesh(shape):
    dp, sp = shape
    return tmesh.make_mesh([CPU] * (dp * sp), dp=dp)


@pytest.fixture(scope="module")
def ref_mesh():
    return jmesh.make_mesh()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_make_mesh_picks_dp_as_the_reference():
    for n in range(1, 9):
        want = jmesh.make_mesh(jax.devices()[:n]).shape
        got = tmesh.make_mesh([CPU] * n).shape
        assert (got["dp"], got["sp"]) == (want["dp"], want["sp"]), n
    for n in (10, 16, 9):
        shape = tmesh.make_mesh([CPU] * n).shape
        assert shape == {"dp": {10: 2, 16: 2, 9: 1}[n],
                         "sp": {10: 5, 16: 8, 9: 9}[n]}, n
    assert tmesh.make_mesh([CPU] * 10, dp=10).shape == {"dp": 10, "sp": 1}
    with pytest.raises(ValueError, match="dp=3"):
        tmesh.make_mesh([CPU] * 6, dp=3)


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh([torch.device("cuda")] * 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multidevice(8)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_batch_encode_and_apply_sharded_match_reference(shape, ref_mesh):
    mesh = _mesh(shape)
    rng = np.random.default_rng(0)
    v, b = 4, 512  # the reference's shapes (divisible by its dp=2, sp=4)
    volumes = rng.integers(0, 256, (v, 10, b)).astype(np.uint8)
    want = np.asarray(jmesh.batch_encode_sharded(ref_mesh, volumes))
    got = tmesh.batch_encode_sharded(mesh, volumes)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    # an arbitrary matrix (a decode plan), and axes that split unevenly
    plan = jgf.decode_plan_for(jgf.rs_matrix(10, 14), 10,
                               list(range(3, 13)), (0, 1, 2, 13))
    odd = rng.integers(0, 256, (7, 10, 301)).astype(np.uint8)
    padded = np.zeros((8, 10, 304), np.uint8)  # the reference's shardings
    padded[:7, :, :301] = odd
    want = np.asarray(jmesh.batch_apply_sharded(ref_mesh, plan,
                                                padded))[:7, :, :301]
    got = tmesh.batch_apply_sharded(mesh, plan, torch.from_numpy(odd))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_distributed_reconstruct_psum_matches_reference(shape, ref_mesh):
    mesh = _mesh(shape)
    rng = np.random.default_rng(1)
    b = 256
    full = [rng.integers(0, 256, b).astype(np.uint8) for _ in range(10)]
    parity = np.asarray(jmesh.batch_encode_sharded(
        ref_mesh, np.stack([np.stack(full)] * 2)))[0]
    shards = full + list(parity)
    # lose shards 0, 2, 11, 13 -> decode the data from 10 survivors
    present = [1, 3, 4, 5, 6, 7, 8, 9, 10, 12]
    dec = jgf.decode_matrix_for(jgf.rs_matrix(10, 14), 10, present)
    assert np.array_equal(gf256.decode_matrix_for(
        gf256.rs_matrix(10, 14), 10, present), dec)
    survivors = np.stack([shards[i] for i in present])
    want = np.asarray(jmesh.distributed_reconstruct(ref_mesh, dec,
                                                    survivors))
    got = tmesh.distributed_reconstruct(mesh, dec, survivors)
    assert np.array_equal(got.numpy(), want)
    for i in range(10):
        assert np.array_equal(got[i].numpy(), full[i]), i
    # a one-row plan (padded to 4 rows in the kernel's operand on a card)
    # and a width that neither sp nor 8 divides
    row = jgf.decode_plan_for(jgf.rs_matrix(10, 14), 10, present, (2,))
    x = rng.integers(0, 256, (10, 77)).astype(np.uint8)
    got = tmesh.distributed_reconstruct(mesh, row, x)
    want = np.asarray(jmesh.distributed_reconstruct(
        jmesh.make_mesh(jax.devices()[:1]), row, x))
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="shard axis"):
        tmesh.distributed_reconstruct(_mesh((2, 1)), row[:, :9], x[:9])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_train_step_matches_reference(shape, ref_mesh):
    mesh = _mesh(shape)
    rng = np.random.default_rng(2)
    volumes = rng.integers(0, 256, (4, 10, 512)).astype(np.uint8)
    dec = jgf.decode_matrix_for(jgf.rs_matrix(10, 14), 10,
                                list(range(4, 14)))
    inputs = rng.integers(0, 256, (10, 512)).astype(np.uint8)
    wp, wr = jmesh.train_step(ref_mesh, volumes, inputs, dec)
    gp, gr = tmesh.train_step(mesh, volumes, inputs, dec)
    assert np.array_equal(gp.numpy(), np.asarray(wp))
    assert np.array_equal(gr.numpy(), np.asarray(wr))


def _dat(path, size, rng):
    with open(path, "wb") as f:
        f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_batch_generate_ec_files_byte_identical(shape, tmp_path, ref_mesh):
    """BASELINE config 4 as a file flow: three volumes of different sizes
    batch-encode through one sharded dispatch per step, and every shard
    file equals the serial per-volume encoder's and the reference's batch
    flow's."""
    LARGE, SMALL = 10000, 100
    rng = np.random.default_rng(5)
    bases = []
    for i, size in enumerate((25_000, 7_333, 41_017)):  # deliberately odd
        base = str(tmp_path / f"v{i}")
        _dat(base + ".dat", size, rng)
        bases.append(base)
    serial = {}
    for base in bases:
        tenc.generate_ec_files(base, large_block_size=LARGE,
                               small_block_size=SMALL, slice_size=512,
                               codec_name="cpu")
        for i in range(ecc.TOTAL_SHARDS):
            p = base + ecc.to_ext(i)
            serial[p] = _read(p)
            os.remove(p)
    jbatch.batch_generate_ec_files(bases, mesh=ref_mesh,
                                   large_block_size=LARGE,
                                   small_block_size=SMALL, slice_size=512)
    ref = {p: _read(p) for p in serial}
    assert ref == serial
    seen = []
    tbatch.batch_generate_ec_files(
        bases, mesh=_mesh(shape), large_block_size=LARGE,
        small_block_size=SMALL, slice_size=512, progress=seen.append)
    assert seen and seen[-1] == sum(
        os.path.getsize(b + ".dat") for b in bases), seen[-3:]
    for p, want in serial.items():
        assert _read(p) == want, f"{p} differs"


def test_batch_generate_opens_no_shard_without_a_mesh(tmp_path):
    """The mesh is made before any shard file opens 'wb': without a card
    the flow raises and an existing shard file keeps its bytes."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    base = str(tmp_path / "v")
    _dat(base + ".dat", 5000, np.random.default_rng(6))
    with open(base + ".ec00", "wb") as f:
        f.write(b"kept")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbatch.batch_generate_ec_files([base])
    assert _read(base + ".ec00") == b"kept"
    # all volumes empty: empty shard files and no device touched
    empty = str(tmp_path / "e")
    open(empty + ".dat", "wb").close()
    tbatch.batch_generate_ec_files([empty])
    assert all(os.path.getsize(empty + ecc.to_ext(i)) == 0
               for i in range(ecc.TOTAL_SHARDS))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mesh_rebuild_ec_files_byte_identical(shape, tmp_path, ref_mesh):
    """Lose the 4 FIRST data shards (a full decode-matrix inversion), then
    a data and parity mix, rebuild through the distributed decode, and
    every regenerated file equals the original; the reference's rebuild
    of the same loss gives the same bytes."""
    rng = np.random.default_rng(9)
    base = str(tmp_path / "v")
    _dat(base + ".dat", 33_077, rng)
    tenc.generate_ec_files(base, large_block_size=10000,
                           small_block_size=100, slice_size=512,
                           codec_name="cpu")
    mesh = _mesh(shape)
    original = {i: _read(base + ecc.to_ext(i))
                for i in range(ecc.TOTAL_SHARDS)}
    for lost in ([0, 1, 2, 3], [7, 11, 13]):
        expect = {base + ecc.to_ext(i): original[i] for i in lost}
        for p in expect:
            os.remove(p)
        seen = []
        rebuilt = tbatch.mesh_rebuild_ec_files(base, mesh=mesh,
                                               slice_size=511,
                                               progress=seen.append)
        assert rebuilt == lost
        shard_size = os.path.getsize(base + ecc.to_ext(4))
        assert seen and seen[-1] == shard_size
        for p, want in expect.items():
            assert _read(p) == want, f"{p} differs"
    if shape == (2, 4):  # the reference's rebuild, once
        for i in (0, 1, 2, 3):
            os.remove(base + ecc.to_ext(i))
        assert jbatch.mesh_rebuild_ec_files(base, mesh=ref_mesh,
                                            slice_size=511) == [0, 1, 2, 3]
        for i in (0, 1, 2, 3):
            assert _read(base + ecc.to_ext(i)) == original[i]


def test_dryrun_multidevice_on_a_virtual_cpu_mesh(ref_mesh):
    """dryrun_multidevice(8) on the CPU, asked for: the mesh the reference's
    dryrun_multichip(8) makes, every check passed."""
    got = dryrun_multidevice(8, device="cpu")
    assert got["mesh"] == dict(ref_mesh.shape) == {"dp": 2, "sp": 4}
    assert got["virtual"] and got["devices"] == ["cpu"] * 8
    assert got["rebuilt"] == [0, 1, 2, 3] and got["file_volumes"] == 16


def test_encoder_reads_at_offsets_as_the_reference(tmp_path):
    p = tmp_path / "f"
    p.write_bytes(bytes(range(200)))
    with open(p, "rb") as f:
        for off, n in ((0, 10), (195, 10), (300, 4)):
            assert np.array_equal(tenc._read_at(f, off, n),
                                  jenc._read_at(f, off, n))


def test_port_and_chip_smoke_import_neither_jax_nor_the_reference():
    """No module of the port, and not chip_smoke.py, imports jax, jaxlib
    or the JAX package (the import walk of test_torch_codec_service.py
    runs the modules; this reads every source, the script included)."""
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|seaweedfs_tpu)"
                     r"(?![\w])", re.M)
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _dirs, names in os.walk(os.path.join(root,
                                                "seaweedfs_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 100
    bad = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            bad += [(path, m.group(0)) for m in pat.finditer(f.read())]
    assert not bad, bad
