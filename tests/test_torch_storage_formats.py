"""The port's copies of the on-disk formats held equal to the reference.

For needle records, index entries, the superblock, TTL, replica placement,
the striped-layout interval math and the .vif sidecar: the same seeded
inputs go through seaweedfs_tpu's module and seaweedfs_tpu_torch's copy, and
the bytes and parsed fields must be equal; the edge cases are those of
tests/test_storage_formats.py and tests/test_ec_pipeline.py.  Drift in a
copy shows here as a failing test.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

from seaweedfs_tpu.storage import idx as ridx
from seaweedfs_tpu.storage import needle as rneedle
from seaweedfs_tpu.storage import replica_placement as rrp
from seaweedfs_tpu.storage import super_block as rsb
from seaweedfs_tpu.storage import ttl as rttl
from seaweedfs_tpu.storage import types as rt
from seaweedfs_tpu.storage import vif as rvif
from seaweedfs_tpu.storage.ec import locate as rloc
from seaweedfs_tpu_torch.storage import idx as pidx
from seaweedfs_tpu_torch.storage import needle as pneedle
from seaweedfs_tpu_torch.storage import replica_placement as prp
from seaweedfs_tpu_torch.storage import super_block as psb
from seaweedfs_tpu_torch.storage import ttl as pttl
from seaweedfs_tpu_torch.storage import types as pt
from seaweedfs_tpu_torch.storage import vif as pvif
from seaweedfs_tpu_torch.storage.ec import locate as ploc

from helpers import make_volume
from torch_threads import one_torch_thread  # noqa: F401

VERSIONS = (1, 2, 3)
LARGE, SMALL = 10000, 100  # the reference ec_test.go's scaled block sizes


def _needle_pair(rng, version, flags: int):
    """The same seeded needle built from both packages' classes."""
    size = int(rng.integers(0, 5000))
    fields = dict(cookie=int(rng.integers(0, 2**32)),
                  id=int(rng.integers(1, 2**63)),
                  data=rng.integers(0, 256, size, dtype=np.uint8).tobytes(),
                  append_at_ns=int(rng.integers(0, 2**62)))
    pair = []
    for mod, ttl_mod in ((rneedle, rttl), (pneedle, pttl)):
        n = mod.Needle(**fields)
        if version != 1 and fields["data"]:
            if flags & 1:
                n.set(mod.FLAG_HAS_NAME)
                n.name = b"name-%d.bin" % size
            if flags & 2:
                n.set(mod.FLAG_HAS_MIME)
                n.mime = b"application/octet-stream"
            if flags & 4:
                n.set(mod.FLAG_HAS_LAST_MODIFIED)
                n.last_modified = 1234567890 + size
            if flags & 8:
                n.set(mod.FLAG_HAS_TTL)
                n.ttl = ttl_mod.TTL.parse("3d")
            if flags & 16:
                n.set(mod.FLAG_HAS_PAIRS)
                n.pairs = b'{"k":"v"}'
        pair.append(n)
    return pair


def _fields(n) -> dict:
    d = {f.name: getattr(n, f.name) for f in dataclasses.fields(n)}
    d["ttl"] = None if d["ttl"] is None else (d["ttl"].count, d["ttl"].unit)
    return d


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("flags", [0, 1, 3, 31])
def test_needle_bytes_and_fields_equal_reference(version, flags):
    rng = np.random.default_rng(100 * version + flags)
    for _ in range(20):
        ref, port = _needle_pair(rng, version, flags)
        blob = ref.to_bytes(version)
        assert port.to_bytes(version) == blob
        assert _fields(port) == _fields(ref)
        got = pneedle.Needle.from_bytes(blob, version)
        want = rneedle.Needle.from_bytes(blob, version)
        assert _fields(got) == _fields(want)
        assert pneedle.actual_size(want.size, version) == len(blob) \
            == rneedle.actual_size(want.size, version)


def test_needle_padding_and_sizes_equal_reference():
    for version in VERSIONS:
        for size in range(0, 80):
            p = pneedle.padding_length(size, version)
            assert 1 <= p <= 8
            assert p == rneedle.padding_length(size, version)
            assert pneedle.body_length(size, version) \
                == rneedle.body_length(size, version)
            assert pneedle.actual_size(size, version) % 8 == 0


def test_needle_crc_detects_corruption_as_reference():
    n = pneedle.Needle(cookie=1, id=2, data=b"payload")
    blob = bytearray(n.to_bytes(3))
    blob[pt.NEEDLE_HEADER_SIZE + 5] ^= 0xFF  # flip a data byte
    with pytest.raises(pneedle.CorruptNeedleError, match="CRC"):
        pneedle.Needle.from_bytes(bytes(blob), 3)
    with pytest.raises(rneedle.CorruptNeedleError):
        rneedle.Needle.from_bytes(bytes(blob), 3)
    # verify=False parses anyway, as the reference does
    assert pneedle.Needle.from_bytes(bytes(blob), 3, verify=False).id == 2
    with pytest.raises(ValueError, match="tombstoned"):
        pneedle.Needle.from_bytes(
            pt.needle_id_to_bytes(0)[:4] + pt.needle_id_to_bytes(2)
            + pt.size_to_bytes(-1), 3)


def test_needles_of_a_reference_volume_parse_equal(tmp_path):
    """Every record of a volume the reference's writer made parses to the
    same fields through the port's Needle, at its .idx offset."""
    vol = make_volume(str(tmp_path), n_needles=40, seed=8, max_size=5000)
    base = vol.file_name()
    vol.close()
    dat = open(base + ".dat", "rb").read()
    sb = psb.SuperBlock.from_bytes(dat)
    assert sb == psb.SuperBlock.from_bytes(rsb.SuperBlock().to_bytes())
    assert sb.version == rsb.SuperBlock.from_bytes(dat).version == 3
    entries = list(pidx.walk_index_blob(open(base + ".idx", "rb").read()))
    assert entries == ridx.walk_index_file(base + ".idx")
    for key, off, size in entries:
        blob = dat[off: off + pneedle.actual_size(size, 3)]
        assert _fields(pneedle.Needle.from_bytes(blob, 3)) \
            == _fields(rneedle.Needle.from_bytes(blob, 3))
        assert pneedle.Needle.from_bytes(blob, 3).id == key


def test_index_entries_equal_reference():
    rng = np.random.default_rng(5)
    cases = [(0xDEADBEEF12345678, 8 * 12345, 6789), (1, 0, pt.TOMBSTONE_FILE_SIZE),
             (2**64 - 1, 8 * (2**32 - 1), 2**31 - 1), (7, 8, 0)]
    cases += [(int(rng.integers(0, 2**63)), 8 * int(rng.integers(0, 2**32)),
               int(rng.integers(-1, 2**31))) for _ in range(200)]
    blob = b""
    for key, off, size in cases:
        b = pt.pack_index_entry(key, off, size)
        assert b == rt.pack_index_entry(key, off, size)
        assert pt.unpack_index_entry(b) == rt.unpack_index_entry(b) \
            == (key, off, size)
        blob += b
    assert list(pidx.walk_index_blob(blob + b"torn")) \
        == list(ridx.walk_index_blob(blob + b"torn"))
    for size in (-1, 0, 1, -5):
        assert pt.size_is_deleted(size) == rt.size_is_deleted(size)
    with pytest.raises(ValueError):
        pt.offset_to_bytes(13)


def test_ttl_equal_reference():
    for s in ("", "3m", "4h", "5d", "6w", "7M", "8y", "90", "255d"):
        p, r = pttl.TTL.parse(s), rttl.TTL.parse(s)
        assert (p.count, p.unit) == (r.count, r.unit)
        assert p.to_bytes() == r.to_bytes()
        assert p.to_uint32() == r.to_uint32()
        assert str(p) == str(r)
        assert p.minutes() == r.minutes()
        assert pttl.TTL.from_bytes(r.to_bytes()) == p
        assert pttl.TTL.from_uint32(r.to_uint32()) == p
        assert p.expired(1000.0, now=1000.0 + p.seconds() + 1) \
            == r.expired(1000.0, now=1000.0 + r.seconds() + 1)


def test_replica_placement_equal_reference():
    for s in ("000", "001", "010", "100", "012", "222", "2"):
        p, r = prp.ReplicaPlacement.parse(s), rrp.ReplicaPlacement.parse(s)
        assert p.to_byte() == r.to_byte()
        assert str(p) == str(r) and p.copy_count() == r.copy_count()
        assert prp.ReplicaPlacement.from_byte(r.to_byte()) == p
    for bad in ("091", "300"):
        with pytest.raises(ValueError):
            prp.ReplicaPlacement.parse(bad)


@pytest.mark.parametrize("version", VERSIONS)
def test_super_block_equal_reference(version):
    for extra in (b"", b"\x08\x01\x12\x04abcd"):
        kw = dict(version=version, compaction_revision=7, extra=extra)
        p = psb.SuperBlock(replica_placement=prp.ReplicaPlacement.parse("001"),
                           ttl=pttl.TTL.parse("3w"), **kw)
        r = rsb.SuperBlock(replica_placement=rrp.ReplicaPlacement.parse("001"),
                           ttl=rttl.TTL.parse("3w"), **kw)
        assert p.to_bytes() == r.to_bytes()
        assert p.block_size() == r.block_size()
        back = psb.SuperBlock.from_bytes(r.to_bytes())
        assert back == p
    with pytest.raises(ValueError):
        psb.SuperBlock.from_bytes(b"\x03\x00")


def test_locate_data_reference_vectors():
    """The exact interval the reference's TestLocateData pins, and a span
    from mid-large-area to the end of the volume, equal to the reference."""
    ivs = ploc.locate_data(LARGE, SMALL, 10 * LARGE + 1, 10 * LARGE, 1)
    assert len(ivs) == 1
    iv = ivs[0]
    assert (iv.block_index, iv.inner_block_offset, iv.size,
            iv.is_large_block, iv.large_block_rows_count) == (0, 0, 1, False, 1)
    total = 10 * LARGE + 1
    start = 10 * LARGE // 2 + 100
    ivs = ploc.locate_data(LARGE, SMALL, total, start, total - start)
    assert sum(i.size for i in ivs) == total - start
    ref = rloc.locate_data(LARGE, SMALL, total, start, total - start)
    assert [dataclasses.astuple(i) for i in ivs] \
        == [dataclasses.astuple(i) for i in ref]


def test_locate_data_equal_reference_on_seeded_ranges():
    rng = np.random.default_rng(11)
    for _ in range(300):
        dat_size = int(rng.integers(1, 40 * LARGE))
        offset = int(rng.integers(0, dat_size))
        size = int(rng.integers(1, dat_size - offset + 1))
        got = ploc.locate_data(LARGE, SMALL, dat_size, offset, size)
        want = rloc.locate_data(LARGE, SMALL, dat_size, offset, size)
        assert [dataclasses.astuple(i) for i in got] \
            == [dataclasses.astuple(i) for i in want]
        for i in got:
            assert i.to_shard_id_and_offset(LARGE, SMALL) == rloc.Interval(
                *dataclasses.astuple(i)).to_shard_id_and_offset(LARGE, SMALL)


def test_shard_file_size_edges():
    ten = 10
    f = ploc.shard_file_size
    assert f(0, LARGE, SMALL) == 0
    assert f(1, LARGE, SMALL) == SMALL
    assert f(ten * SMALL, LARGE, SMALL) == SMALL
    assert f(ten * SMALL + 1, LARGE, SMALL) == 2 * SMALL
    assert f(ten * LARGE, LARGE, SMALL) == LARGE  # all small rows
    assert f(ten * LARGE + 1, LARGE, SMALL) == LARGE + SMALL
    rng = np.random.default_rng(2)
    for dat_size in rng.integers(0, 50 * LARGE, 200):
        assert f(int(dat_size), LARGE, SMALL) \
            == rloc.shard_file_size(int(dat_size), LARGE, SMALL)


def _vif_fields(info) -> dict:
    """A VolumeInfo, the port's or the reference's protobuf message, as a
    plain dict."""
    out = {name: getattr(info, name)
           for name in ("version", "replication", "dat_file_size")}
    out["files"] = [{name: getattr(rf, name) for name, _j, _k
                     in pvif._REMOTE_FIELDS} for rf in info.files]
    return out


_REMOTE = [dict(backend_type="s3", backend_id="cold", key="v/1.dat",
                offset=-3, file_size=5 << 33, modified_time=1700000000,
                extension=".dat")]


@pytest.mark.parametrize("args", [
    (3, "001", 12345, _REMOTE), (2, "", 0, None), (0, "", 0, None),
    (3, "000", 2**63 + 5, None), (1, "200", 30000 << 20, _REMOTE * 2)],
    ids=["remote", "version-only", "empty", "u64", "two-files"])
def test_vif_reads_and_writes_as_reference(tmp_path, args):
    """The port's .vif writer makes the reference's bytes; its JSON and
    binary-protobuf readers read files the reference wrote to the same
    fields as the reference's reader."""
    ref_path, port_path = str(tmp_path / "r.vif"), str(tmp_path / "p.vif")
    rvif.save_volume_info(ref_path, *args)
    pvif.save_volume_info(port_path, *args)
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()
    want = rvif.load_volume_info(ref_path)
    got = pvif.load_volume_info(ref_path)
    assert _vif_fields(got) == _vif_fields(want)
    binary = str(tmp_path / "b.vif")
    with open(binary, "wb") as f:
        f.write(want.SerializeToString())
    if os.path.getsize(binary):
        assert _vif_fields(pvif.load_volume_info(binary)) \
            == _vif_fields(rvif.load_volume_info(binary))
    else:  # an all-default message is empty: neither reads anything
        assert pvif.load_volume_info(binary) is None \
            and rvif.load_volume_info(binary) is None


def test_vif_missing_and_snake_case(tmp_path):
    assert pvif.load_volume_info(str(tmp_path / "none.vif")) is None
    p = str(tmp_path / "s.vif")
    with open(p, "w") as f:  # protobuf-JSON also accepts the proto names
        f.write('{"version": 3, "dat_file_size": "77", "replication": "010"}')
    got = pvif.load_volume_info(p)
    want = rvif.load_volume_info(p)
    assert _vif_fields(got) == _vif_fields(want)
    assert got.dat_file_size == 77
