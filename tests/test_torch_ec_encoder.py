"""The port's EC file pipeline held against the JAX package, on the CPU.

Both packages encode the same random volume (.dat + .idx written by the
reference's Volume) with scaled-down blocks (large 10000, small 100, as
tests/test_ec_pipeline.py does): the JAX side with codec "tpu" (the Pallas
kernel in interpret mode), the port with "torch_cpu" (the CUDA kernel's
plain version).  Shard files and .ecx must be byte-identical, and so must
every rebuilt shard.
"""

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.storage.ec import encoder as jenc
from seaweedfs_tpu_torch.storage.ec import encoder as tenc
from seaweedfs_tpu_torch.storage.ec.constants import TOTAL_SHARDS, to_ext
from seaweedfs_tpu_torch.storage.needle_map import NeedleMap

from helpers import make_volume
from torch_threads import one_torch_thread  # noqa: F401

LARGE = 10000
SMALL = 100


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """One volume encoded by both packages: -> (port base, jax base)."""
    root = tmp_path_factory.mktemp("torch_ec")
    (root / "src").mkdir()
    vol = make_volume(str(root / "src"), n_needles=90, seed=11, max_size=3000)
    src = vol.file_name()
    vol.close()
    bases = []
    for side in ("port", "jax"):
        d = root / side
        d.mkdir()
        base = str(d / "1")
        for ext in (".dat", ".idx"):
            shutil.copyfile(src + ext, base + ext)
        bases.append(base)
    port, jax_base = bases
    # > LARGE*10 bytes, so both the large-row and the small-row geometry run
    assert os.path.getsize(port + ".dat") > LARGE * 10
    tenc.generate_ec_files(port, LARGE, SMALL, codec_name="torch_cpu",
                           slice_size=4096)
    tenc.write_sorted_file_from_idx(port)
    jenc.generate_ec_files(jax_base, large_block_size=LARGE,
                           small_block_size=SMALL, codec_name="tpu",
                           slice_size=4096)
    jenc.write_sorted_file_from_idx(jax_base)
    return port, jax_base


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_shards_and_ecx_identical_to_reference(encoded):
    port, jax_base = encoded
    for i in range(TOTAL_SHARDS):
        assert _read(port + to_ext(i)) == _read(jax_base + to_ext(i)), i
    assert _read(port + ".ecx") == _read(jax_base + ".ecx")


@pytest.mark.parametrize("slice_size", [50, 333, 1 << 20])
def test_slice_width_does_not_change_bytes(encoded, tmp_path, slice_size):
    port, _ = encoded
    base = str(tmp_path / "1")
    shutil.copyfile(port + ".dat", base + ".dat")
    n = tenc.generate_ec_files(base, LARGE, SMALL, codec_name="torch_cpu",
                               slice_size=slice_size)
    dat_size = os.path.getsize(base + ".dat")
    assert n == len(list(tenc._slice_tasks(dat_size, LARGE, SMALL,
                                           slice_size)))
    for i in range(TOTAL_SHARDS):
        assert _read(base + to_ext(i)) == _read(port + to_ext(i)), i


LOSSES = [(3,), (12,), (0, 9), (10, 13), (1, 5, 11), (0, 1, 2, 3),
          (10, 11, 12, 13), (2, 4, 10, 13)]


@pytest.mark.parametrize("lost", LOSSES, ids=[str(x) for x in LOSSES])
def test_rebuild_matches_original_and_reference(encoded, tmp_path, lost):
    port, jax_base = encoded
    sides = {}
    for side, src in (("port", port), ("jax", jax_base)):
        d = tmp_path / side
        d.mkdir()
        base = str(d / "1")
        for i in range(TOTAL_SHARDS):
            if i not in lost:
                shutil.copyfile(src + to_ext(i), base + to_ext(i))
        sides[side] = base
    got = tenc.rebuild_ec_files(sides["port"], codec_name="torch_cpu",
                                slice_size=1000)
    assert got == sorted(lost)
    assert sorted(jenc.rebuild_ec_files(sides["jax"], codec_name="tpu",
                                        slice_size=1000)) == sorted(lost)
    for i in lost:
        rebuilt = _read(sides["port"] + to_ext(i))
        assert rebuilt == _read(port + to_ext(i)), i
        assert rebuilt == _read(sides["jax"] + to_ext(i)), i
    assert tenc.rebuild_ec_files(sides["port"], codec_name="torch_cpu") == []


def test_failed_rebuild_leaves_no_partial_output(encoded, tmp_path):
    port, _ = encoded
    base = str(tmp_path / "1")
    for i in range(TOTAL_SHARDS):
        if i not in (0, 11):
            shutil.copyfile(port + to_ext(i), base + to_ext(i))
    # a truncated source makes the positioned read fail mid-stream
    size = os.path.getsize(base + to_ext(5))
    with open(base + to_ext(5), "r+b") as f:
        f.truncate(size // 2)
    with pytest.raises(IOError):
        tenc.rebuild_ec_files(base, codec_name="torch_cpu", slice_size=64)
    assert not os.path.exists(base + to_ext(0))
    assert not os.path.exists(base + to_ext(11))
    # too few sources is refused before any output is created
    for i in range(1, 6):
        os.remove(base + to_ext(i))
    with pytest.raises(ValueError):
        tenc.rebuild_ec_files(base, codec_name="torch_cpu")
    assert not os.path.exists(base + to_ext(0))


def test_needle_map_replay_matches_reference(tmp_path):
    """Overwrites and tombstones take the sequential replay path."""
    from seaweedfs_tpu.storage import types as jt
    from seaweedfs_tpu.storage.needle_map import NeedleMap as JNeedleMap

    rng = np.random.default_rng(5)
    idx = tmp_path / "1.idx"
    with open(idx, "wb") as f:
        for _ in range(400):
            key = int(rng.integers(1, 120))
            if rng.random() < 0.2:
                f.write(jt.pack_index_entry(key, 0, jt.TOMBSTONE_FILE_SIZE))
            else:
                f.write(jt.pack_index_entry(
                    key, 8 * int(rng.integers(1, 1 << 20)),
                    int(rng.integers(1, 5000))))
        f.write(b"\x01\x02\x03")  # torn trailing entry
    NeedleMap.load_from_idx(idx).write_sorted_index(tmp_path / "port.ecx")
    JNeedleMap.load_from_idx(idx).write_sorted_index(tmp_path / "jax.ecx")
    assert _read(tmp_path / "port.ecx") == _read(tmp_path / "jax.ecx")
    assert len(NeedleMap.load_from_idx(idx)) == \
        len(_read(tmp_path / "port.ecx")) // 16


@pytest.mark.parametrize("codec", ["cpu", "torch_cpu"])
def test_generate_progress_and_sync_match_reference(tmp_path, monkeypatch,
                                                    codec):
    """`progress` fires after each slice with the .dat bytes done, the same
    calls as the reference's; `sync=True` fsyncs the 14 shard files and
    their directory, as the reference does, and the bytes are the same."""
    rng = np.random.default_rng(21)
    bases = []
    for side in ("ref", "port"):
        (tmp_path / side).mkdir()
        base = str(tmp_path / side / "1")
        with open(base + ".dat", "wb") as f:
            f.write(rng.integers(0, 256, 123_457, dtype=np.uint8).tobytes()
                    if side == "ref" else _read(bases[0] + ".dat"))
        bases.append(base)
    ref_base, base = bases
    synced = {"ref": [], "port": []}
    real_fsync = os.fsync
    side = ["ref"]

    def fsync(fd):
        synced[side[0]].append(os.fstat(fd).st_mode)
        real_fsync(fd)
    monkeypatch.setattr(os, "fsync", fsync)
    want, got = [], []
    jenc.generate_ec_files(ref_base, large_block_size=LARGE,
                           small_block_size=SMALL, slice_size=512,
                           codec_name="cpu", progress=want.append, sync=True)
    side[0] = "port"
    tenc.generate_ec_files(base, LARGE, SMALL, codec_name=codec,
                           slice_size=512, progress=got.append, sync=True)
    assert got == want and got[-1] == os.path.getsize(base + ".dat")
    assert len(synced["port"]) == len(synced["ref"]) == TOTAL_SHARDS + 1
    assert synced["port"] == synced["ref"]  # 14 files, then the directory
    for i in range(TOTAL_SHARDS):
        assert _read(base + to_ext(i)) == _read(ref_base + to_ext(i)), i
    # without sync nothing is fsynced
    synced["port"].clear()
    tenc.generate_ec_files(base, LARGE, SMALL, codec_name=codec,
                           slice_size=512)
    assert synced["port"] == []
