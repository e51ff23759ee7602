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


# -- 5-byte offsets, the host route, the rebuild faultpoint --------------------


@pytest.mark.parametrize("codec", ["cpu", "torch_cpu"])
def test_five_byte_volume_ecx_shards_and_reads_equal_reference(tmp_path,
                                                               codec):
    """A 5-byte-offset volume (17-byte .idx, written by the reference's
    Volume at 5 bytes) encoded by both packages from the same .dat: the
    14 shards and the 17-byte .ecx equal byte for byte, and every needle
    read through the port's EcVolume with .ec00-.ec03 lost equals the
    reference's read."""
    from seaweedfs_tpu.storage import types as rt
    from seaweedfs_tpu.storage.ec.volume import EcVolume as RefEcVolume
    from seaweedfs_tpu_torch.storage import types as pt
    from seaweedfs_tpu_torch.storage.ec.volume import EcVolume

    pt.set_offset_size(5)
    rt.set_offset_size(5)
    try:
        (tmp_path / "src").mkdir()
        vol = make_volume(str(tmp_path / "src"), n_needles=70, seed=31,
                          max_size=3000)
        src = vol.file_name()
        vol.close()
        n = os.path.getsize(src + ".idx") // 17
        assert os.path.getsize(src + ".idx") == 17 * n == 17 * 70
        bases = {}
        for side in ("ref", "port"):
            (tmp_path / side).mkdir()
            bases[side] = str(tmp_path / side / "1")
            for ext in (".dat", ".idx"):
                shutil.copyfile(src + ext, bases[side] + ext)
        jenc.generate_ec_files(bases["ref"], large_block_size=LARGE,
                               small_block_size=SMALL, codec_name="cpu",
                               slice_size=4096)
        jenc.write_sorted_file_from_idx(bases["ref"])
        tenc.generate_ec_files(bases["port"], LARGE, SMALL,
                               codec_name=codec, slice_size=4096)
        tenc.write_sorted_file_from_idx(bases["port"])
        for i in range(TOTAL_SHARDS):
            assert _read(bases["port"] + to_ext(i)) \
                == _read(bases["ref"] + to_ext(i)), i
        ecx = _read(bases["port"] + ".ecx")
        assert ecx == _read(bases["ref"] + ".ecx") and len(ecx) == 17 * 70
        ref = RefEcVolume(bases["ref"], volume_id=1, codec_name="cpu",
                          large_block_size=LARGE, small_block_size=SMALL)
        port = EcVolume(bases["port"], volume_id=1, codec_name=codec,
                        large_block_size=LARGE, small_block_size=SMALL)
        try:
            for ev in (ref, port):
                for sid in (0, 1, 2, 3):
                    ev.delete_shard(sid)
            for key in range(1, 71):
                got, want = port.read_needle(key), ref.read_needle(key)
                assert (got.id, got.cookie, got.data, got.checksum) \
                    == (want.id, want.cookie, want.data, want.checksum)
            # a tombstone lands at NEEDLE_ID_SIZE + OFFSET_SIZE (byte 13)
            port.delete_needle(9)
            ref.delete_needle(9)
        finally:
            port.close()
            ref.close()
        assert _read(bases["port"] + ".ecx") == _read(bases["ref"] + ".ecx")
    finally:
        pt.set_offset_size(4)
        rt.set_offset_size(4)


@pytest.mark.parametrize("dat_size", [1, 99, 1007, LARGE * 10 + 13,
                                      3 * LARGE * 10 + 5])
def test_cpu_codec_takes_the_mmap_route(tmp_path, monkeypatch, dat_size):
    """The host codec encodes on the reference's zero-copy route
    (_encode_stream_mmap, encoder.py:103-118 of the reference), at ragged
    sizes and small slices that batch rows across stripes, with shards
    equal to the reference's; torch_cpu keeps the pipelined route."""
    calls = {"mmap": 0, "pipelined": 0}
    for name, key in (("_encode_stream_mmap", "mmap"),
                      ("_encode_stream_pipelined", "pipelined")):
        real = getattr(tenc, name)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tenc, name, counted)
    rng = np.random.default_rng(dat_size)
    blob = rng.integers(0, 256, dat_size, dtype=np.uint8).tobytes()
    bases = {}
    for side in ("ref", "port", "torch"):
        (tmp_path / side).mkdir()
        bases[side] = str(tmp_path / side / "1")
        with open(bases[side] + ".dat", "wb") as f:
            f.write(blob)
    jenc.generate_ec_files(bases["ref"], large_block_size=LARGE,
                           small_block_size=SMALL, codec_name="cpu",
                           slice_size=250)
    want_slices = sum(1 for _ in tenc._slice_tasks(dat_size, LARGE, SMALL,
                                                   250))
    assert tenc.generate_ec_files(bases["port"], LARGE, SMALL,
                                  codec_name="cpu",
                                  slice_size=250) == want_slices
    assert calls == {"mmap": 1, "pipelined": 0}
    assert tenc.generate_ec_files(bases["torch"], LARGE, SMALL,
                                  codec_name="torch_cpu",
                                  slice_size=250) == want_slices
    assert calls == {"mmap": 1, "pipelined": 1}
    for i in range(TOTAL_SHARDS):
        want = _read(bases["ref"] + to_ext(i))
        assert _read(bases["port"] + to_ext(i)) == want, i
        assert _read(bases["torch"] + to_ext(i)) == want, i


@pytest.mark.parametrize("iov_max", [8, None])
def test_writev_all_past_iov_max_and_short_writes(tmp_path, monkeypatch,
                                                  iov_max):
    """_writev_all writes more buffers than IOV_MAX (the system's, or 8)
    in chunks, and resumes a write the kernel cut short mid-buffer."""
    if iov_max is not None:
        monkeypatch.setattr(tenc, "_IOV_MAX", iov_max)
    rng = np.random.default_rng(5)
    bufs = [rng.integers(0, 256, int(rng.integers(1, 40)),
                         dtype=np.uint8) for _ in range(3 * tenc._IOV_MAX + 7)]
    want = b"".join(b.tobytes() for b in bufs)
    real = os.writev
    seen = []

    def short(fd, chunk):
        seen.append(len(chunk))
        assert len(chunk) <= tenc._IOV_MAX
        # never more than 53 bytes a call: cuts land mid-buffer
        out, room = [], 53
        for b in chunk:
            b = memoryview(b).cast("B")[:room]
            out.append(b)
            room -= len(b)
            if not room:
                break
        return real(fd, out)
    monkeypatch.setattr(os, "writev", short)
    with open(tmp_path / "out.bin", "wb") as f:
        tenc._writev_all(f.fileno(), list(bufs))
    assert _read(tmp_path / "out.bin") == want
    assert len(seen) > len(bufs) // tenc._IOV_MAX


def test_chaos_rebuild_source_dies_midstream(encoded, tmp_path):
    """tests/test_degraded_read.py's case on the port: the
    `ec.rebuild.read` faultpoint, armed to fire once, fails the rebuild
    with a clean IOError while the outputs are open; every partial .ecNN
    is removed, the prefetch and writer threads are gone, and the retry
    rebuilds byte-identical shards."""
    import threading

    from seaweedfs_tpu_torch.stats.metrics import FAULT_COUNTER
    from seaweedfs_tpu_torch.util import faultpoint

    port, _ = encoded
    base = str(tmp_path / "1")
    lost = (0, 1, 12, 13)
    for i in range(TOTAL_SHARDS):
        if i not in lost:
            shutil.copyfile(port + to_ext(i), base + to_ext(i))
    names = {t.name for t in threading.enumerate()}
    fired = FAULT_COUNTER.labels("ec.rebuild.read").value
    faultpoint.set_fault("ec.rebuild.read", "error", count=1)
    try:
        with pytest.raises(IOError):
            tenc.rebuild_ec_files(base, codec_name="cpu", slice_size=1000)
    finally:
        faultpoint.clear_fault("ec.rebuild.read")
    assert FAULT_COUNTER.labels("ec.rebuild.read").value == fired + 1
    for sid in lost:
        assert not os.path.exists(base + to_ext(sid)), sid
    assert not {t.name for t in threading.enumerate()
                if t.name.startswith(("ec-prefetch", "ec-writer",
                                      "ec-rebuild-read"))} - names
    assert tenc.rebuild_ec_files(base, codec_name="cpu",
                                 slice_size=1000) == sorted(lost)
    for sid in lost:
        assert _read(base + to_ext(sid)) == _read(port + to_ext(sid)), sid
