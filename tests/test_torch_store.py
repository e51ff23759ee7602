"""The port's Store and its EC lifecycle (write, ec.encode, mount, reads
healthy and degraded, ec.rebuild, ec.decode, compaction) and its decoder,
held against the reference on the CPU.

The same seeded needles, with the same write times, go into the
reference's `Store(codec_name="cpu")` and into the port's, once on its
`cpu` codec (the native SIMD library) and once on `torch_cpu` (the
kernel's plain PyTorch version).  After each step the shard files, the
`.ecx`, the rebuilt shards and the decoded `.dat`/`.idx` are compared byte
for byte (tolerance: exact); the `.vif` and the superblock's times are
not.  A `cuda` store on this host, which has no card, must raise where it
would need one and write nothing, whether the codec service is on or off.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.storage.ec import decoder as rdec
from seaweedfs_tpu.storage.ec import encoder as renc
from seaweedfs_tpu.storage.needle import FLAG_HAS_MIME, FLAG_HAS_NAME
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu_torch.ops import codec as pcodec
from seaweedfs_tpu_torch.storage.ec import decoder as pdec
from seaweedfs_tpu_torch.storage.ec import encoder as penc
from seaweedfs_tpu_torch.storage.ec.constants import TOTAL_SHARDS, to_ext
from seaweedfs_tpu_torch.storage.ec.locate import shard_file_size
from seaweedfs_tpu_torch.storage.ec.shard_bits import ShardBits
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store

from helpers import make_volume
from torch_threads import one_torch_thread  # noqa: F401

HOST_CODECS = ("cpu", "torch_cpu")
APPEND_AT_NS = 1_700_000_000 * 10**9
N_NEEDLES = 120
LOST = [0, 1, 2, 3]
SHARD_EXTS = [to_ext(i) for i in range(TOTAL_SHARDS)]
# scaled block sizes of the reference's ec_test.go, for the decoder cases
LARGE, SMALL = 10000, 100


def _needle_fields(seed: int = 0) -> list[dict]:
    """Seeded needles of 1 B..64 KiB (about 3.8 MB in all, so the volume
    stripes over four 1 MB small-block rows and its decode plans touch
    real data), some named, some with a mime type."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_NEEDLES):
        size = int(rng.integers(1, 64 << 10))
        out.append({
            "id": int(i * 7919 + 3), "cookie": int(rng.integers(0, 2**32)),
            "data": rng.integers(0, 256, size, dtype=np.uint8).tobytes(),
            "name": f"f-{i}.bin".encode() if i % 3 == 0 else b"",
            "mime": b"application/octet-stream" if i % 5 == 0 else b"",
            "append_at_ns": APPEND_AT_NS + i})
    return out


def _needle(cls, f: dict):
    n = cls(cookie=f["cookie"], id=f["id"], data=f["data"])
    if f["name"]:
        n.set(FLAG_HAS_NAME)
        n.name = f["name"]
    if f["mime"]:
        n.set(FLAG_HAS_MIME)
        n.mime = f["mime"]
    n.append_at_ns = f["append_at_ns"]
    return n


def _view(n) -> tuple:
    return (n.id, n.cookie, bytes(n.data), n.checksum, n.append_at_ns,
            n.flags, bytes(n.name), bytes(n.mime))


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _equal(ref_base: str, port_base: str, exts) -> None:
    for ext in exts:
        assert _read(port_base + ext) == _read(ref_base + ext), ext


def _stores(tmp_path, codec: str):
    """A reference Store on `cpu` and a port Store on `codec`, each over a
    directory of its own, needle caches off (every read goes to disk),
    volume 1 written with the same needles and sealed."""
    fields = _needle_fields()
    pair = {}
    for name, cls, needle, c in (("ref", RefStore, RefNeedle, "cpu"),
                                 ("port", Store, Needle, codec)):
        d = tmp_path / name
        d.mkdir()
        st = cls([str(d)], codec_name=c, needle_cache_mb=0)
        st.add_volume(1, "")
        for f in fields:
            st.write_needle(1, _needle(needle, f))
        assert st.mark_readonly(1)
        pair[name] = (st, str(d / "1"))
    return pair, fields


def _reads_equal(pair, fields) -> None:
    (ref, _), (port, _) = pair["ref"], pair["port"]
    for f in fields:
        want = _view(ref.read_needle(1, f["id"]))
        assert _view(port.read_needle(1, f["id"])) == want
        assert want[2] == f["data"]


@pytest.mark.parametrize("codec", HOST_CODECS)
def test_store_ec_lifecycle_matches_reference(tmp_path, codec):
    pair, fields = _stores(tmp_path, codec)
    (ref, rbase), (port, pbase) = pair["ref"], pair["port"]
    try:
        _equal(rbase, pbase, (".dat", ".idx"))
        dat = _read(pbase + ".dat")

        # ec.encode, then the volume deleted and its shards mounted
        for st in (ref, port):
            st.generate_ec_shards(1, "")
        _equal(rbase, pbase, SHARD_EXTS + [".ecx"])
        for st in (ref, port):
            assert st.delete_volume(1)
            st.mount_ec_shards(1, "", list(range(TOTAL_SHARDS)))
        assert not os.path.exists(pbase + ".dat")
        assert port.status() == ref.status() == {
            "volumes": [], "ec_volumes": {1: list(range(TOTAL_SHARDS))}}
        _reads_equal(pair, fields)

        # 4 shards unmounted: degraded reads
        originals = {i: _read(pbase + to_ext(i)) for i in LOST}
        for st in (ref, port):
            st.unmount_ec_shards(1, LOST)
        assert port.find_ec_volume(1).shard_ids() == list(range(4, 14))
        _reads_equal(pair, fields)

        # ec.rebuild of the deleted files, then remounted
        for base in (rbase, pbase):
            for i in LOST:
                os.remove(base + to_ext(i))
        assert ref.rebuild_ec_shards(1, "") == LOST
        assert port.rebuild_ec_shards(1, "") == LOST
        _equal(rbase, pbase, [to_ext(i) for i in LOST])
        assert {i: _read(pbase + to_ext(i)) for i in LOST} == originals
        for st in (ref, port):
            st.mount_ec_shards(1, "", LOST)

        # a needle deleted in the EC volume (.ecx tombstone + .ecj)
        gone = fields[5]["id"]
        assert port.delete_ec_needle(1, gone) == ref.delete_ec_needle(1, gone)
        _equal(rbase, pbase, (".ecx", ".ecj"))

        # ec.decode back to a normal volume
        for st in (ref, port):
            st.ec_shards_to_volume(1, "")
        _equal(rbase, pbase, (".dat", ".idx"))
        assert _read(pbase + ".dat") == dat
        assert port.find_volume(1) is not None
        assert port.find_ec_volume(1) is None
        live = [f for f in fields if f["id"] != gone]
        _reads_equal(pair, live)
        with pytest.raises(KeyError):
            port.read_needle(1, gone)

        # the delta records carry the reference messages' fields
        for mine, theirs in ((port.new_volumes, ref.new_volumes),
                             (port.deleted_volumes, ref.deleted_volumes),
                             (port.new_ec_shards, ref.new_ec_shards),
                             (port.deleted_ec_shards, ref.deleted_ec_shards)):
            assert len(mine) == len(theirs) > 0
            for m, t in zip(mine, theirs):
                for fd in t.DESCRIPTOR.fields:
                    assert getattr(m, fd.name) == getattr(t, fd.name), fd.name

        # compaction of the decoded volume after deletes
        for f in live[:30:3]:
            for st in (ref, port):
                assert st.delete_needle(1, f["id"]) > 0
        assert port.check_compact_volume(1) == pytest.approx(
            ref.check_compact_volume(1))
        for st in (ref, port):
            st.compact_volume(1)
            st.commit_compact_volume(1)
        _equal(rbase, pbase, (".dat", ".idx"))
        _reads_equal(pair, live[30:])
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("codec", HOST_CODECS)
def test_store_reloads_volumes_and_ec_shards(tmp_path, codec):
    """A store made over a directory finds its volume and an EC volume
    (the location's load_existing_volumes and load_all_ec_shards), on the
    location's codec, and serves both as the reference's does."""
    pair, fields = _stores(tmp_path, codec)
    (ref, rbase), (port, pbase) = pair["ref"], pair["port"]
    for st, base in ((ref, rbase), (port, pbase)):
        st.close()
        # a second volume, a copy of the first, EC-encoded
        shutil.copy(base + ".dat", base[:-1] + "2.dat")
        shutil.copy(base + ".idx", base[:-1] + "2.idx")
    renc.write_ec_files(rbase[:-1] + "2", codec_name="cpu")
    renc.write_sorted_file_from_idx(rbase[:-1] + "2")
    penc.write_ec_files(pbase[:-1] + "2", codec_name=codec)
    penc.write_sorted_file_from_idx(pbase[:-1] + "2")
    for base in (rbase, pbase):
        os.remove(base[:-1] + "2.dat")
        os.remove(base[:-1] + "2.idx")
    ref = RefStore([os.path.dirname(rbase)], codec_name="cpu",
                   needle_cache_mb=0)
    port = Store([os.path.dirname(pbase)], codec_name=codec,
                 needle_cache_mb=0)
    pair = {"ref": (ref, rbase), "port": (port, pbase)}
    try:
        assert port.status() == ref.status() == {
            "volumes": [1], "ec_volumes": {2: list(range(TOTAL_SHARDS))}}
        assert port.find_ec_volume(2).codec._impl == codec
        _reads_equal(pair, fields)
        for f in fields[:20]:
            assert _view(port.read_needle(2, f["id"])) == \
                _view(ref.read_needle(2, f["id"]))
    finally:
        ref.close()
        port.close()


def test_shard_bits_match_reference():
    from seaweedfs_tpu.storage.ec.shard_bits import ShardBits as RefBits

    rng = np.random.default_rng(4)
    for _ in range(50):
        ids = rng.choice(14, int(rng.integers(0, 15)), replace=False)
        mine, theirs = ShardBits(0), RefBits(0)
        for i in ids:
            mine, theirs = mine.add(int(i)), theirs.add(int(i))
        assert int(mine) == int(theirs)
        assert mine.shard_ids() == theirs.shard_ids()
        assert mine.count() == theirs.count()
        drop = int(rng.integers(0, 14))
        assert int(mine.remove(drop)) == int(theirs.remove(drop))
        assert int(mine.minus(0b1010)) == int(theirs.minus(0b1010))


# -- the decoder (test_ec_pipeline.py's decode cases) ---------------------------


@pytest.fixture()
def scaled_blocks(monkeypatch):
    """Both decoders on the reference ec_test.go's scaled block sizes."""
    for mod in (rdec, pdec):
        monkeypatch.setattr(mod, "LARGE_BLOCK_SIZE", LARGE)
        monkeypatch.setattr(mod, "SMALL_BLOCK_SIZE", SMALL)


def test_decode_roundtrip(tmp_path, scaled_blocks):
    vol = make_volume(str(tmp_path), n_needles=80, seed=3, max_size=3000)
    base = vol.file_name()
    vol.close()
    renc.generate_ec_files(base, large_block_size=LARGE,
                           small_block_size=SMALL, codec_name="cpu",
                           slice_size=50)
    renc.write_sorted_file_from_idx(base)
    orig_dat, orig_idx = _read(base + ".dat"), _read(base + ".idx")
    out = {}
    for name, dec in (("ref", rdec), ("port", pdec)):
        dbase = str(tmp_path / name / "1")
        os.makedirs(os.path.dirname(dbase))
        for ext in SHARD_EXTS + [".ecx"]:
            shutil.copy(base + ext, dbase + ext)
        size = dec.find_dat_file_size(dbase, dbase)
        dec.write_dat_file(dbase, size)
        dec.write_idx_file_from_ec_index(dbase)
        out[name] = (size, _read(dbase + ".dat"), _read(dbase + ".idx"))
    assert out["port"] == out["ref"]
    size, got, idx = out["port"]
    assert got == orig_dat[:len(got)] and len(got) >= size
    assert idx == orig_idx


def test_shard_file_size_edges(tmp_path, scaled_blocks):
    """`.dat` sizes at the row edges, exact multiples of the 10-block large
    row among them (the encoder's strict `>` row loop): shards of the size
    shard_file_size predicts, and the port's write_dat_file gives back the
    `.dat` byte for byte, as the reference's decoder does."""
    rng = np.random.default_rng(9)
    ten = 10
    sizes = [1, ten * SMALL - 1, ten * SMALL, ten * SMALL + 1,
             ten * LARGE - 1, ten * LARGE, ten * LARGE + 1,
             2 * ten * LARGE, 2 * ten * LARGE + ten * SMALL + 7]
    for k, size in enumerate(sizes):
        base = str(tmp_path / f"{k}")
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        with open(base + ".dat", "wb") as f:
            f.write(data)
        penc.generate_ec_files(base, LARGE, SMALL, codec_name="cpu",
                               slice_size=4096)
        want = shard_file_size(size, LARGE, SMALL)
        for ext in SHARD_EXTS:
            assert os.path.getsize(base + ext) == want, (size, ext)
        os.remove(base + ".dat")
        for dec in (pdec, rdec):
            dec.write_dat_file(base, size)
            assert _read(base + ".dat") == data, (size, dec.__name__)


# -- a cuda store on a host without a card ----------------------------------


@pytest.fixture()
def no_effective_codec(monkeypatch):
    """effective_codec is the reference's switch to the host; the store
    must never ask it."""

    def refuse(name):
        raise AssertionError(f"effective_codec({name!r}) consulted")

    monkeypatch.setattr(pcodec, "effective_codec", refuse)


SERVICE = pytest.mark.parametrize("service", ["1", "0"],
                                  ids=["service_on", "service_off"])


def _ec_files(directory: str) -> list[str]:
    return sorted(f for f in os.listdir(directory)
                  if f.endswith(".ecx") or f[-5:-2] == ".ec")


@SERVICE
def test_cuda_store_generate_raises_and_writes_no_shard(
        tmp_path, monkeypatch, no_effective_codec, service):
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SERVICE", service)
    store = Store([str(tmp_path)], needle_cache_mb=0)
    assert store.codec_name == "cuda"
    try:
        store.add_volume(1, "")
        for f in _needle_fields()[:10]:
            store.write_needle(1, _needle(Needle, f))
        with pytest.raises(RuntimeError, match="CUDA"):
            store.generate_ec_shards(1, "")
        assert _ec_files(str(tmp_path)) == []
        assert store.find_volume(1).read_needle(
            _needle_fields()[0]["id"]).id == _needle_fields()[0]["id"]
    finally:
        store.close()


@SERVICE
def test_cuda_store_rebuild_raises(tmp_path, monkeypatch,
                                   no_effective_codec, service):
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SERVICE", service)
    store = Store([str(tmp_path)], needle_cache_mb=0)
    try:
        os.makedirs(tmp_path / "src")
        vol = make_volume(str(tmp_path / "src"), n_needles=30, seed=5,
                          max_size=20000)
        src = vol.file_name()
        vol.close()
        renc.write_ec_files(src, codec_name="cpu")
        renc.write_sorted_file_from_idx(src)
        for ext in SHARD_EXTS[4:] + [".ecx"]:  # .ec00-.ec03 lost
            shutil.copy(src + ext, str(tmp_path / "1") + ext)
        before = _ec_files(str(tmp_path))
        with pytest.raises(RuntimeError, match="CUDA"):
            store.rebuild_ec_shards(1, "")
        assert _ec_files(str(tmp_path)) == before
    finally:
        store.close()


def test_auto_store_resolves_once_and_logs(tmp_path, monkeypatch):
    """`auto` is resolved when the store is made, through the codec
    registry's own choice, and the choice is logged; a host without a
    card gets `cpu`, which its EC volumes then run on."""
    import io

    from seaweedfs_tpu_torch.util import glog

    log = io.StringIO()
    monkeypatch.setattr(glog, "_sink", log)
    monkeypatch.setattr(pcodec, "_AUTO_CHOICE", [])
    store = Store([str(tmp_path)], codec_name="auto", needle_cache_mb=0)
    try:
        assert store.codec_name == "cpu"
        assert store.locations[0].codec_name == "cpu"
        assert pcodec._AUTO_CHOICE == ["cpu"]
        assert "codec auto resolved to cpu" in log.getvalue()
    finally:
        store.close()
