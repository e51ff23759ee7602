"""The port's Volume (write path, index, torn-tail repair, disk-fault
rollback), its needle maps and the store's watermark reconciliation, held
against the reference on the CPU.

Every volume test writes the same seeded needles, with the same write
times, into the reference's Volume and into the port's, applies the same
operation to both, and compares the `.dat` and `.idx` byte for byte
(tolerance: exact) besides the behaviour the reference's own test checks.
The needle-map tests run the reference's assertions against both maps and
hold a seeded sequence of mutations equal step by step.
"""

from __future__ import annotations

import errno
import os

import numpy as np
import pytest

from seaweedfs_tpu.storage import types as rt
from seaweedfs_tpu.storage import volume as rvolmod
from seaweedfs_tpu.storage.disk_health import DiskFailingError as RefFailing
from seaweedfs_tpu.storage.disk_health import DiskFullError as RefFull
from seaweedfs_tpu.storage.disk_needle_map import DiskNeedleMap as RefDiskMap
from seaweedfs_tpu.storage.needle import FLAG_HAS_MIME, FLAG_HAS_NAME
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.needle_map import NeedleMap as RefNeedleMap
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu.storage.super_block import SuperBlock as RefSuperBlock
from seaweedfs_tpu.util import faultpoint as rfault
from seaweedfs_tpu_torch.storage import disk_health as phealth
from seaweedfs_tpu_torch.storage import types as pt
from seaweedfs_tpu_torch.storage import volume as pvolmod
from seaweedfs_tpu_torch.storage.disk_needle_map import DiskNeedleMap
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.needle_map import NeedleMap
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.super_block import SuperBlock
from seaweedfs_tpu_torch.util import faultpoint as pfault

from torch_threads import one_torch_thread  # noqa: F401

GB = 1 << 30
MB = 1 << 20
APPEND_AT_NS = 1_700_000_000 * 10**9
DELETE_AT_NS = 1_800_000_000 * 10**9


class Side:
    """One package's half of a pair: its Volume, Needle, SuperBlock,
    types, faultpoint registry and typed disk errors."""

    def __init__(self, name, volmod, needle, super_block, types, fault,
                 full, failing):
        self.name, self.volmod, self.Needle = name, volmod, needle
        self.SuperBlock, self.t, self.fault = super_block, types, fault
        self.Full, self.Failing = full, failing

    def needle(self, i: int, data: bytes, cookie: int = 1):
        n = self.Needle(cookie=cookie, id=i, data=data)
        n.append_at_ns = APPEND_AT_NS + i
        return n

    def volume(self, directory: str, fresh: bool = False):
        return self.volmod.Volume(
            directory, "", 1,
            super_block=self.SuperBlock() if fresh else None)


REF = Side("reference", rvolmod, RefNeedle, RefSuperBlock, rt, rfault,
           RefFull, RefFailing)
PORT = Side("port", pvolmod, Needle, SuperBlock, pt, pfault,
            phealth.DiskFullError, phealth.DiskFailingError)
SIDES = (REF, PORT)


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    rfault.clear_fault("all")
    pfault.clear_fault("all")


def _make(side: Side, directory: str, n_needles: int, seed: int = 0,
          max_size: int = 2000):
    """tests/helpers.py's make_volume, write times from the seed."""
    rng = np.random.default_rng(seed)
    vol = side.volume(directory, fresh=True)
    for i in range(1, n_needles + 1):
        size = int(rng.integers(1, max_size))
        n = side.needle(i, rng.integers(0, 256, size).astype(np.uint8)
                        .tobytes(), cookie=int(rng.integers(0, 2**32)))
        if i % 3 == 0:
            n.set(FLAG_HAS_NAME)
            n.name = f"file-{i}.bin".encode()
        if i % 5 == 0:
            n.set(FLAG_HAS_MIME)
            n.mime = b"application/octet-stream"
        vol.append_needle(n)
    return vol


def _dirs(tmp_path):
    out = {}
    for side in SIDES:
        d = tmp_path / side.name
        d.mkdir()
        out[side.name] = str(d)
    return out


def _files_equal(dirs, exts=(".dat", ".idx")) -> None:
    for ext in exts:
        a = open(os.path.join(dirs["reference"], "1" + ext), "rb").read()
        b = open(os.path.join(dirs["port"], "1" + ext), "rb").read()
        assert a == b, ext


def _last_entry(vol):
    last = None
    for v in vol.needle_map.items_ascending():
        if last is None or v.offset > last.offset:
            last = v
    return last


def _payload(i: int, size: int = 900) -> bytes:
    return bytes((i * 31 + j) % 256 for j in range(size))


# -- test_storage_formats.py's volume cases ----------------------------------


def test_volume_write_read_delete(tmp_path):
    dirs = _dirs(tmp_path)
    freed = {}
    for side in SIDES:
        vol = _make(side, dirs[side.name], 30)
        assert vol.read_needle(7).id == 7
        freed[side.name] = vol.delete_needle(7, at_ns=DELETE_AT_NS)
        with pytest.raises(KeyError):
            vol.read_needle(7)
        vol.close()
        vol2 = side.volume(dirs[side.name])
        with pytest.raises(KeyError):
            vol2.read_needle(7)
        assert vol2.read_needle(8).id == 8
        vol2.close()
    assert freed["port"] == freed["reference"] > 0
    _files_equal(dirs)


def test_volume_torn_tail_truncated(tmp_path):
    dirs = _dirs(tmp_path)
    for side in SIDES:
        d = dirs[side.name]
        vol = _make(side, d, 5)
        base = vol.file_name()
        last = vol.needle_map.get(5)
        vol.close()
        size = os.path.getsize(base + ".dat")
        with open(base + ".dat", "r+b") as f:  # padding only: re-padded
            f.truncate(size - 1)
        vol2 = side.volume(d)
        assert vol2.read_needle(5).id == 5
        assert os.path.getsize(base + ".dat") == size
        vol2.close()
        with open(base + ".dat", "r+b") as f:  # real bytes: dropped
            f.truncate(last.offset + 10)
        vol3 = side.volume(d)
        with pytest.raises(KeyError):
            vol3.read_needle(5)
        vol3.close()
    _files_equal(dirs)


# -- test_torn_tail.py ---------------------------------------------------------


def test_mid_blob_tear_truncates_to_previous_record(tmp_path):
    dirs = _dirs(tmp_path)
    for side in SIDES:
        d = dirs[side.name]
        vol = _make(side, d, 6)
        base = vol.file_name()
        last = _last_entry(vol)
        vol.close()
        with open(base + ".dat", "r+b") as f:
            f.truncate(last.offset + side.t.NEEDLE_HEADER_SIZE
                       + max(last.size // 2, 1))
        vol2 = side.volume(d)
        with pytest.raises(KeyError):
            vol2.read_needle(6)
        assert vol2.read_needle(5).id == 5
        assert os.path.getsize(base + ".dat") == last.offset
        vol2.append_needle(side.needle(100, b"after-heal", cookie=7))
        vol2.close()
        vol3 = side.volume(d)
        assert vol3.read_needle(100).data == b"after-heal"
        vol3.close()
    _files_equal(dirs)


def test_mid_idx_entry_tear_drops_partial_entry(tmp_path):
    dirs = _dirs(tmp_path)
    for side in SIDES:
        d = dirs[side.name]
        vol = _make(side, d, 6)
        base = vol.file_name()
        vol.close()
        idx_size = os.path.getsize(base + ".idx")
        assert idx_size == 6 * side.t.NEEDLE_MAP_ENTRY_SIZE
        with open(base + ".idx", "r+b") as f:
            f.truncate(idx_size - 9)
        vol2 = side.volume(d)
        with pytest.raises(KeyError):
            vol2.read_needle(6)
        assert vol2.read_needle(5).id == 5
        vol2.append_needle(side.needle(101, b"idx-heal", cookie=7))
        vol2.close()
        vol3 = side.volume(d)
        assert vol3.read_needle(101).data == b"idx-heal"
        assert os.path.getsize(base + ".idx") \
            % side.t.NEEDLE_MAP_ENTRY_SIZE == 0
        vol3.close()
    _files_equal(dirs)


def test_tear_at_padding_boundary_repads(tmp_path):
    from seaweedfs_tpu.storage.needle import actual_size, padding_length

    dirs = _dirs(tmp_path)
    for side in SIDES:
        d = dirs[side.name]
        vol = _make(side, d, 4)
        base = vol.file_name()
        last = _last_entry(vol)
        version = vol.version
        vol.close()
        end = last.offset + actual_size(last.size, version)
        pad = padding_length(last.size, version)
        with open(base + ".dat", "r+b") as f:
            f.truncate(end - pad)
        vol2 = side.volume(d)
        assert vol2.read_needle(4).id == 4
        assert os.path.getsize(base + ".dat") == end
        vol2.append_needle(side.needle(102, b"padded", cookie=7))
        assert vol2.read_needle(102).data == b"padded"
        vol2.close()
    _files_equal(dirs)


def test_tombstone_as_last_record(tmp_path):
    dirs = _dirs(tmp_path)
    for side in SIDES:
        d = dirs[side.name]
        vol = _make(side, d, 5)
        assert vol.delete_needle(5, at_ns=DELETE_AT_NS) > 0
        vol.close()
        vol2 = side.volume(d)
        with pytest.raises(KeyError):
            vol2.read_needle(5)
        assert vol2.read_needle(4).id == 4
        vol2.append_needle(side.needle(103, b"post-delete", cookie=7))
        assert vol2.read_needle(103).data == b"post-delete"
        vol2.close()
    _files_equal(dirs)


def test_torn_tombstone_keeps_delete_durable(tmp_path):
    dirs = _dirs(tmp_path)
    for side in SIDES:
        d = dirs[side.name]
        vol = _make(side, d, 5)
        base = vol.file_name()
        pre = os.path.getsize(base + ".dat")
        assert vol.delete_needle(5, at_ns=DELETE_AT_NS) > 0
        vol.close()
        with open(base + ".dat", "r+b") as f:
            f.truncate(pre + 4)
        vol2 = side.volume(d)
        with pytest.raises(KeyError):
            vol2.read_needle(5)
        assert vol2.read_needle(4).id == 4
        vol2.close()
    _files_equal(dirs)


# -- test_disk_health.py's volume and store cases ------------------------------


def test_append_enospc_rolls_back_cleanly(tmp_path):
    dirs = _dirs(tmp_path)
    for side in SIDES:
        d = dirs[side.name]
        vol = _make(side, d, 3)
        base = vol.file_name()
        pre_dat = os.path.getsize(base + ".dat")
        pre_idx = os.path.getsize(base + ".idx")
        side.fault.set_fault("disk.write.enospc", "error", count=1,
                             match=base + ".dat")
        with pytest.raises(side.Full):
            vol.append_needle(side.needle(50, _payload(50)))
        assert os.path.getsize(base + ".dat") == pre_dat
        assert os.path.getsize(base + ".idx") == pre_idx
        assert vol.needle_map.get(50) is None
        assert vol.read_only and vol.read_only_reason == "full"
        with pytest.raises(side.Full):
            vol.append_needle(side.needle(51, b"x"))
        vol.close()
        vol2 = side.volume(d)
        assert vol2.read_needle(1).id == 1
        with pytest.raises(KeyError):
            vol2.read_needle(50)
        off, _size = vol2.append_needle(side.needle(52, _payload(52)))
        assert vol2.read_needle(52).data == _payload(52)
        assert off % side.t.NEEDLE_PADDING_SIZE == 0
        vol2.close()
    _files_equal(dirs)


def test_append_eio_rolls_back_and_counts(tmp_path):
    dirs = _dirs(tmp_path)
    for side in SIDES:
        vol = _make(side, dirs[side.name], 2)
        base = vol.file_name()
        pre = os.path.getsize(base + ".dat")
        side.fault.set_fault("disk.write.partial", "error", count=1,
                             match=base + ".dat")
        with pytest.raises(side.Failing):
            vol.append_needle(side.needle(9, _payload(9)))
        assert os.path.getsize(base + ".dat") == pre
        assert not vol.read_only
        assert vol.health is None
        vol.append_needle(side.needle(9, _payload(9)))
        assert vol.read_needle(9).data == _payload(9)
        vol.close()
    _files_equal(dirs)


def test_short_write_detected_and_rolled_back(tmp_path):
    dirs = _dirs(tmp_path)
    for side in SIDES:
        vol = _make(side, dirs[side.name], 2)
        base = vol.file_name()
        pre = os.path.getsize(base + ".dat")
        side.fault.set_fault("disk.write.short", "partial", count=1,
                             match=base + ".dat")
        with pytest.raises(side.Failing):
            vol.append_needle(side.needle(9, _payload(9)))
        assert os.path.getsize(base + ".dat") == pre
        vol.close()
    _files_equal(dirs)


def test_delete_enforces_volume_size_cap(tmp_path, monkeypatch):
    dirs = _dirs(tmp_path)
    for side in SIDES:
        vol = _make(side, dirs[side.name], 3)
        monkeypatch.setattr(side.t, "MAX_POSSIBLE_VOLUME_SIZE", 64)
        with pytest.raises(IOError, match="size limit"):
            vol.delete_needle(2, at_ns=DELETE_AT_NS)
        assert vol.read_needle(2).id == 2
        vol.close()
    _files_equal(dirs)


def test_delete_enospc_rolls_back(tmp_path):
    dirs = _dirs(tmp_path)
    for side in SIDES:
        vol = _make(side, dirs[side.name], 3)
        base = vol.file_name()
        pre = os.path.getsize(base + ".dat")
        side.fault.set_fault("disk.write.enospc", "error", count=1,
                             match=base + ".dat")
        with pytest.raises(side.Full):
            vol.delete_needle(2, at_ns=DELETE_AT_NS)
        assert os.path.getsize(base + ".dat") == pre
        assert vol.read_needle(2).id == 2
        assert vol.read_only and vol.read_only_reason == "full"
        assert vol.delete_needle(2, at_ns=DELETE_AT_NS) > 0
        with pytest.raises(KeyError):
            vol.read_needle(2)
        with pytest.raises(side.Full):
            vol.append_needle(side.needle(77, b"x"))
        vol.close()
    _files_equal(dirs)


@pytest.mark.parametrize("store_cls,full", [
    (RefStore, RefFull), (Store, phealth.DiskFullError)],
    ids=["reference", "port"])
def test_store_watermark_flips_and_recovers_volumes(tmp_path, store_cls,
                                                    full):
    store = store_cls([str(tmp_path)], needle_cache_mb=0,
                      codec_name="cpu")
    needle = RefNeedle if store_cls is RefStore else Needle
    store.add_volume(1, "")
    loc = store.locations[0]
    free = [50 * GB]
    loc.health._statvfs = lambda _d: (100 * GB, free[0])
    events = []
    store.on_disk_event = lambda: events.append(1)
    assert store.apply_disk_health()[0]["state"] == "healthy"
    v = store.find_volume(1)
    assert not v.read_only
    free[0] = 100 * MB
    snaps = store.apply_disk_health()
    assert snaps[0]["state"] == "full"
    assert v.read_only and v.read_only_reason == "full"
    with pytest.raises(full):
        store.write_needle(1, needle(cookie=1, id=5, data=b"x"))
    assert events
    free[0] = 50 * GB
    store.apply_disk_health()
    assert not v.read_only
    store.write_needle(1, needle(cookie=1, id=5, data=b"x"))
    v.read_only, v.read_only_reason = True, ""
    store.apply_disk_health()
    assert v.read_only
    store.close()


def _health(mod, free_seq, total=100 * GB, eio_threshold=3):
    seq = list(free_seq)

    def fake(_dir):
        return total, seq.pop(0) if len(seq) > 1 else seq[0]

    return mod.DiskHealth("/fake", min_free_mb=64, min_free_percent=1.0,
                          eio_threshold=eio_threshold, statvfs=fake)


def test_disk_health_state_machine_matches_reference():
    """The watermark, ENOSPC and EIO transitions of test_disk_health.py's
    state-machine cases, one scripted sequence through both machines."""
    from seaweedfs_tpu.storage import disk_health as rhealth

    frees = [50 * GB, 3 * GB, 512 * MB, 2 * GB, 50 * GB, 50 * GB, 40 * GB]
    trail = {}
    for mod in (rhealth, phealth):
        h = _health(mod, frees)
        states = [h.poll() for _ in range(5)]
        h.record_write_error(OSError(errno.ENOSPC, "no space"))
        states.append(h.state)
        states.append(h.poll())
        for _ in range(3):
            h.record_write_error(OSError(errno.EIO, "io error"))
            states.append(h.state)
        h.record_write_ok()
        states.append(h.poll())
        h.mark_repaired()
        states.append(h.state)
        snap = h.snapshot()
        states.append((snap["state"], snap["free_bytes"],
                       snap["total_bytes"]))
        trail[mod.__name__] = states
        full = mod.classify_write_error(OSError(errno.ENOSPC, "x"), "/d")
        eio = mod.classify_write_error(OSError(errno.EIO, "x"), "/d")
        assert isinstance(full, mod.DiskFullError)
        assert isinstance(eio, mod.DiskFailingError)
    ref, port = trail.values()
    assert port == ref
    assert ref[:5] == ["healthy", "low_space", "full", "low_space",
                       "healthy"]


# -- test_needle_map.py --------------------------------------------------------


@pytest.mark.parametrize("nm_cls", [RefNeedleMap, NeedleMap],
                         ids=["reference", "port"])
def test_put_get_delete_with_merges(nm_cls):
    nm = nm_cls(merge_threshold=8)
    for k in range(100):
        nm.put(k + 1, (k + 1) * 8, 100 + k)
    assert len(nm) == 100 and nm.file_count == 100
    assert nm.get(50).offset == 50 * 8 and nm.get(50).size == 149
    assert 101 not in nm
    nm.put(50, 8000, 500)
    assert (nm.get(50).offset, nm.get(50).size) == (8000, 500)
    assert nm.deleted_count == 1 and nm.deleted_bytes == 149
    assert nm.delete(51) == 150
    assert nm.get(51) is None and len(nm) == 99
    assert nm.delete(51) == 0
    nm.put(51, 400, 7)
    assert nm.get(51).size == 7 and len(nm) == 100


@pytest.mark.parametrize("nm_cls", [RefNeedleMap, NeedleMap],
                         ids=["reference", "port"])
def test_iteration_sorted_and_next_key(nm_cls):
    nm = nm_cls(merge_threshold=4)
    keys = [9, 2, 77, 31, 5, 64, 100, 1]
    for k in keys:
        nm.put(k, k * 8, k)
    assert nm.sorted_keys() == sorted(keys)
    assert [v.key for v in nm.items_ascending()] == sorted(keys)
    assert nm.next_key_after(5) == 9 and nm.next_key_after(100) is None
    assert nm.maximum_key == 100


def test_needle_map_mutations_match_reference(tmp_path):
    """A seeded mix of puts, overwrites and deletes through both maps
    (merge threshold 16, so the tiers merge often): every lookup, count
    and byte tally equal after each step, and the sorted index and the
    map loaded back from the same .idx equal."""
    rng = np.random.default_rng(7)
    ref, port = RefNeedleMap(merge_threshold=16), NeedleMap(merge_threshold=16)
    idx = bytearray()
    for step in range(600):
        key = int(rng.integers(1, 120))
        if rng.random() < 0.3:
            got = (ref.delete(key), port.delete(key))
            idx += rt.pack_index_entry(key, 8, rt.TOMBSTONE_FILE_SIZE)
        else:
            off, size = int(rng.integers(1, 10**6)) * 8, int(
                rng.integers(1, 5000))
            ref.put(key, off, size)
            port.put(key, off, size)
            got = (None, None)
            idx += rt.pack_index_entry(key, off, size)
        assert got[0] == got[1]
        r, p = ref.get(key), port.get(key)
        assert (r is None) == (p is None)
        if r is not None:
            assert (r.key, r.offset, r.size) == (p.key, p.offset, p.size)
        assert (len(ref), ref.file_count, ref.deleted_count,
                ref.deleted_bytes, ref.content_size, ref.maximum_key) == (
            len(port), port.file_count, port.deleted_count,
            port.deleted_bytes, port.content_size, port.maximum_key), step
    assert ref.sorted_keys() == port.sorted_keys()
    ref.write_sorted_index(tmp_path / "r.ecx")
    port.write_sorted_index(tmp_path / "p.ecx")
    assert (tmp_path / "r.ecx").read_bytes() == \
        (tmp_path / "p.ecx").read_bytes()
    (tmp_path / "v.idx").write_bytes(bytes(idx))
    r2 = RefNeedleMap.load_from_idx(tmp_path / "v.idx")
    p2 = NeedleMap.load_from_idx(tmp_path / "v.idx")
    assert [(v.key, v.offset, v.size) for v in r2.items_ascending()] == \
        [(v.key, v.offset, v.size) for v in p2.items_ascending()]
    assert (len(r2), r2.deleted_count, r2.deleted_bytes) == \
        (len(p2), p2.deleted_count, p2.deleted_bytes)


@pytest.mark.parametrize("nm_cls", [RefNeedleMap, NeedleMap],
                         ids=["reference", "port"])
def test_content_size_accounting(nm_cls):
    nm = nm_cls()
    nm.put(1, 8, 10)
    nm.put(2, 16, 20)
    assert nm.content_size == 30
    nm.delete(1)
    assert nm.content_size == 20
    nm.put(2, 24, 5)
    assert nm.content_size == 5


@pytest.mark.parametrize("dm_cls", [RefDiskMap, DiskNeedleMap],
                         ids=["reference", "port"])
def test_disk_needle_map_bounded_ram(tmp_path, dm_cls):
    m = dm_cls(str(tmp_path / "1.sdx"), overflow_limit=500)
    n = 5000
    for k in range(1, n + 1):
        m.put(k, k * 8, 100 + (k % 7))
    assert len(m._overflow) + len(m._deleted) <= 501
    assert m._base_count >= n - 501
    assert len(m) == n
    for k in (1, 250, 2500, n):
        nv = m.get(k)
        assert nv is not None and nv.offset == k * 8
    assert m.get(n + 1) is None
    for k in range(1, 1001):
        m.delete(k)
    assert len(m) == n - 1000
    assert m.get(500) is None and m.get(1001) is not None
    keys = m.sorted_keys()
    assert keys[0] == 1001 and keys[-1] == n and len(keys) == n - 1000
    m.close()


def test_disk_needle_map_files_match_reference(tmp_path):
    """The same mutations through both disk maps leave the same sorted
    `.sdx` base file behind."""
    maps = {}
    for name, cls in (("r", RefDiskMap), ("p", DiskNeedleMap)):
        m = cls(str(tmp_path / f"{name}.sdx"), overflow_limit=64)
        for k in range(1, 700):
            m.put(k * 3, k * 8, 100 + k % 11)
        for k in range(1, 700, 4):
            m.delete(k * 3)
        maps[name] = (m.sorted_keys(), [m.get(k * 3) for k in range(700)])
        m.close()
    r_keys, r_vals = maps["r"]
    p_keys, p_vals = maps["p"]
    assert r_keys == p_keys
    assert [(v.offset, v.size) if v else None for v in r_vals] == \
        [(v.offset, v.size) if v else None for v in p_vals]
    assert (tmp_path / "r.sdx").read_bytes() == \
        (tmp_path / "p.sdx").read_bytes()


def test_disk_needle_map_volume_roundtrip(tmp_path):
    dirs = _dirs(tmp_path)
    for side in SIDES:
        side.volmod.set_needle_map_kind("disk")
        try:
            d = dirs[side.name]
            vol = _make(side, d, 40)
            assert type(vol.needle_map).__name__ == "DiskNeedleMap"
            assert bytes(vol.read_needle(7).data)
            vol.delete_needle(7, at_ns=DELETE_AT_NS)
            with pytest.raises(KeyError):
                vol.read_needle(7)
            vol.close()
            vol2 = side.volume(d)
            assert type(vol2.needle_map).__name__ == "DiskNeedleMap"
            assert vol2.read_needle(8).data
            with pytest.raises(KeyError):
                vol2.read_needle(7)
            vol2.close()
        finally:
            side.volmod.set_needle_map_kind("memory")
    _files_equal(dirs, (".dat", ".idx", ".sdx"))


# -- durability modes (test_serving_plane.py's group-commit cases) -------------


@pytest.mark.parametrize("mode", ["none", "sync", "batch"])
def test_durability_modes_match_reference(tmp_path, monkeypatch, mode):
    """Appends and a delete under each SEAWEEDFS_TPU_DURABILITY mode: the
    same files as the reference's, one fsync pair per mutation in `sync`,
    every mutation through a flush barrier in `batch` (the port's
    seaweedfs_fsync_batch_* counters move), and the delete durable across
    a remount."""
    from seaweedfs_tpu_torch.stats.metrics import (
        FSYNC_BATCH_COMMITS,
        FSYNC_BATCH_WRITES,
    )

    monkeypatch.setenv("SEAWEEDFS_TPU_DURABILITY", mode)
    dirs = _dirs(tmp_path)
    syncs = {}
    writes0 = FSYNC_BATCH_WRITES.labels().value
    commits0 = FSYNC_BATCH_COMMITS.labels().value
    for side in SIDES:
        vol = side.volume(dirs[side.name], fresh=True)
        assert vol.durability == mode
        assert (vol._group is not None) == (mode == "batch")
        calls = [0]
        real = vol._dat.sync

        def spy(real=real, calls=calls):
            calls[0] += 1
            real()

        monkeypatch.setattr(vol._dat, "sync", spy)
        for i in range(1, 7):
            vol.append_needle(side.needle(i, _payload(i, 300 + 50 * i)))
        assert vol.delete_needle(3, at_ns=DELETE_AT_NS) > 0
        syncs[side.name] = calls[0]
        vol.close()
        vol2 = side.volume(dirs[side.name])
        with pytest.raises(KeyError):
            vol2.read_needle(3)
        assert vol2.read_needle(6).data == _payload(6, 600)
        vol2.close()
    assert syncs["port"] == syncs["reference"]
    assert syncs["port"] == {"none": 0, "sync": 7}.get(mode, syncs["port"])
    if mode == "batch":
        assert FSYNC_BATCH_WRITES.labels().value - writes0 == 7
        assert 1 <= FSYNC_BATCH_COMMITS.labels().value - commits0 <= 7
    _files_equal(dirs)


def test_batch_fsync_failure_rolls_back_whole_batch(tmp_path, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_DURABILITY", "batch")
    dirs = _dirs(tmp_path)
    for side in SIDES:
        vol = side.volume(dirs[side.name], fresh=True)
        vol.append_needle(side.needle(1, _payload(1)))
        dat_size = vol._dat.file_size()
        idx_size = os.path.getsize(vol.file_name() + ".idx")

        def broken_sync():
            raise OSError(errno.ENOSPC, "No space left on device")

        real = vol._dat.sync
        vol._dat.sync = broken_sync
        with pytest.raises(side.Full):
            vol.append_needle(side.needle(2, _payload(2)))
        with pytest.raises(KeyError):
            vol.read_needle(2)
        assert vol._dat.file_size() == dat_size
        assert os.path.getsize(vol.file_name() + ".idx") == idx_size
        assert vol.read_only and vol.read_only_reason == "full"
        assert vol.read_needle(1).data == _payload(1)
        vol._dat.sync = real
        vol.read_only, vol.read_only_reason = False, ""
        vol.append_needle(side.needle(3, _payload(3)))
        assert vol.read_needle(3).data == _payload(3)
        vol.close()
    _files_equal(dirs)


def test_batch_mode_concurrent_appends_durable(tmp_path, monkeypatch):
    """Eight writers on one port volume in batch mode, started together
    at a barrier: every append acked and read back, each through a flush
    barrier, and each still there after a remount."""
    import threading

    from seaweedfs_tpu_torch.stats.metrics import FSYNC_BATCH_WRITES

    monkeypatch.setenv("SEAWEEDFS_TPU_DURABILITY", "batch")
    vol = PORT.volume(str(tmp_path), fresh=True)
    writes0 = FSYNC_BATCH_WRITES.labels().value
    n_writers, per = 8, 6
    gate = threading.Barrier(n_writers)
    errs: list = []

    def writer(tid):
        gate.wait()
        for k in range(per):
            i = 1 + tid * per + k
            try:
                vol.append_needle(PORT.needle(i, _payload(i, 100 + i)))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(n_writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    total = n_writers * per
    assert FSYNC_BATCH_WRITES.labels().value - writes0 == total
    vol.close()
    vol = PORT.volume(str(tmp_path))
    for i in range(1, total + 1):
        assert vol.read_needle(i).data == _payload(i, 100 + i)
    vol.close()


# -- needle extents (the zero-copy read descriptor) -----------------------------


def test_needle_extent_matches_reference(tmp_path):
    """Each needle's extent names the same payload bytes and metadata as
    the reference's; a rotten payload is declined by both, and the
    ordinary read then raises the corrupt-needle error."""
    dirs = _dirs(tmp_path)
    vols = {side.name: _make(side, dirs[side.name], 12, seed=11)
            for side in SIDES}
    try:
        # one payload byte of needle 3 rots before its first extent serve
        nv = vols["port"].needle_map.get(3)
        for side in SIDES:
            path = os.path.join(dirs[side.name], "1.dat")
            with open(path, "r+b") as f:
                f.seek(nv.offset + side.t.NEEDLE_HEADER_SIZE + 5)
                b = f.read(1)
                f.seek(nv.offset + side.t.NEEDLE_HEADER_SIZE + 5)
                f.write(bytes([b[0] ^ 0xFF]))
            vol = vols[side.name]
            assert vol.needle_extent(3) is None
            with pytest.raises(ValueError, match="CRC|checksum|corrupt"):
                vol.read_needle(3)
        for i in [i for i in range(1, 13) if i != 3]:
            got = {}
            for name, vol in vols.items():
                with vol.needle_extent(i) as ext:
                    n = ext.needle
                    got[name] = (ext.data_offset, ext.data_len,
                                 os.pread(ext.fd, ext.data_len,
                                          ext.data_offset),
                                 n.checksum, n.cookie, bytes(n.name),
                                 bytes(n.mime), n.append_at_ns)
            assert got["port"] == got["reference"]
    finally:
        for vol in vols.values():
            vol.close()


def test_volume_on_unconfigured_tier_refuses_to_load(tmp_path):
    """A `.vif` that places the `.dat` on a remote tier no backend is
    registered for: both volumes refuse to load, naming the backend."""
    from seaweedfs_tpu.storage.vif import save_volume_info as ref_save

    dirs = _dirs(tmp_path)
    for side in SIDES:
        _make(side, dirs[side.name], 3).close()
        ref_save(os.path.join(dirs[side.name], "1.vif"), 3,
                 remote_files=[{"backend_type": "s3", "backend_id": "cold",
                                "key": "1.dat", "file_size": 4096,
                                "extension": ".dat"}])
        with pytest.raises(IOError, match="unconfigured backend s3.cold"):
            side.volume(dirs[side.name])
