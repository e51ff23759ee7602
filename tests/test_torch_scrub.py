"""The port's scrubber (token bucket, quarantine, volume and EC scans,
cursors, confirms, index repair) and vacuum's corrupt-needle skip, held
against the reference scrubber on the CPU.

Each case builds its files once with the reference's writer and encoder,
copies them into a second directory, and runs the reference's Store and
Scrubber over one copy and the port's over the other: every finding (its
volume, kind, shard, needle and detail, which names the interval), every
quarantine and every scan summary must be equal (tolerance: exact), and so
must the files a repair rewrites.  EC cases run the port on `cpu` and on
`torch_cpu`.  The token bucket runs on a fake clock, so its waits are
exact instead of timed.  A `cuda` store on this host, which has no card,
must raise from its EC scan with the codec service on and off: its parity
check never switches to the host codec.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.storage import scrub as rscrub
from seaweedfs_tpu.storage.ec.encoder import write_ec_files
from seaweedfs_tpu.storage.ec.encoder import write_sorted_file_from_idx
from seaweedfs_tpu.storage.needle import CorruptNeedleError as RefCorrupt
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu_torch.ops import codec as pcodec
from seaweedfs_tpu_torch.storage import scrub as pscrub
from seaweedfs_tpu_torch.storage.ec.constants import TOTAL_SHARDS, to_ext
from seaweedfs_tpu_torch.storage.ec.volume import EcVolume
from seaweedfs_tpu_torch.storage.needle import CorruptNeedleError
from seaweedfs_tpu_torch.storage.store import Store

from helpers import make_volume
from torch_threads import one_torch_thread  # noqa: F401


class Side:
    def __init__(self, name, scrub_mod, store_cls, corrupt):
        self.name, self.scrub, self.Store = name, scrub_mod, store_cls
        self.Corrupt = corrupt


REF = Side("reference", rscrub, RefStore, RefCorrupt)
PORT = Side("port", pscrub, Store, CorruptNeedleError)
HOST_CODECS = ("cpu", "torch_cpu")


class FakeTime:
    """monotonic() and sleep() of a clock that moves only when slept on."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now

    def sleep(self, dt: float) -> None:
        self.now += dt


@pytest.fixture()
def fake_clocks(monkeypatch):
    clocks = {}
    for side in (REF, PORT):
        clocks[side.name] = FakeTime()
        monkeypatch.setattr(side.scrub, "time", clocks[side.name])
    return clocks


def _flip_byte(path: str, offset: int, mask: int = 0xFF) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))


def _needle_offset(directory: str, vid: int, needle_id: int) -> int:
    """The .dat offset of one byte inside a live needle's data, from the
    .idx (header 16 + data size 4 + 2 bytes into the payload)."""
    raw = np.fromfile(os.path.join(directory, f"{vid}.idx"),
                      dtype=[("k", ">u8"), ("o", ">u4"), ("s", ">i4")])
    hit = raw[raw["k"] == needle_id][-1]
    return int(hit["o"]) * 8 + 16 + 4 + 2


def _twin_dirs(tmp_path, build) -> dict:
    """`build(directory)` once into the reference's directory, then the
    same files copied for the port."""
    dirs = {"reference": str(tmp_path / "reference"),
            "port": str(tmp_path / "port")}
    os.makedirs(dirs["reference"])
    build(dirs["reference"])
    shutil.copytree(dirs["reference"], dirs["port"])
    return dirs


def _volume_files(vid, n_needles, seed, max_size=2000):
    def build(d):
        make_volume(d, volume_id=vid, n_needles=n_needles, seed=seed,
                    max_size=max_size).close()
    return build


def _ec_volume_files(vid=2, n_needles=60, seed=7):
    def build(d):
        vol = make_volume(d, volume_id=vid, n_needles=n_needles, seed=seed,
                          max_size=20000)
        base = vol.file_name()
        vol.close()
        write_ec_files(base, codec_name="cpu")
        write_sorted_file_from_idx(base)
        os.remove(base + ".dat")
        os.remove(base + ".idx")
    return build


def _open(dirs, codec="cpu", ec_vid=None):
    """{side: (store, scrubber)} as the reference's tests make them: the
    needle cache off, 500 MB/s, the daemon never due."""
    out = {}
    for side in (REF, PORT):
        store = side.Store([dirs[side.name]], needle_cache_mb=0,
                           codec_name="cpu" if side is REF else codec)
        scrubber = side.scrub.Scrubber(store, rate_mbps=500, interval_s=9999)
        store.scrubber = scrubber
        if ec_vid is not None:
            store.mount_ec_shards(ec_vid, "", list(range(TOTAL_SHARDS)))
        out[side.name] = (store, scrubber)
    return out


def _close(pair) -> None:
    for store, _ in pair.values():
        store.close()


def _findings(scrubber) -> list[tuple]:
    return sorted((f["volume_id"], f["kind"], f["shard_id"], f["needle_id"],
                   f["detail"]) for f in scrubber.outstanding_findings())


def _same(pair, fn):
    """fn(side, store, scrubber) on both sides; the port's answer (with
    any `seconds` dropped) must equal the reference's."""
    got = {}
    for side in (REF, PORT):
        store, scrubber = pair[side.name]
        r = fn(side, store, scrubber)
        if isinstance(r, dict):
            r = {k: v for k, v in r.items() if k != "seconds"}
        got[side.name] = r
    assert got["port"] == got["reference"]
    return got["port"]


def _state(pair) -> tuple:
    return _same(pair, lambda side, st, sc: (
        _findings(sc), sc.quarantine.status()))


# -- throttle ------------------------------------------------------------------


def test_token_bucket_paces_consumption(fake_clocks):
    waits = {}
    for side in (REF, PORT):
        clock = fake_clocks[side.name]
        tb = side.scrub.TokenBucket(1 << 20)
        t0 = clock.now
        w = [tb.consume(1 << 20)] + [tb.consume(256 << 10) for _ in range(4)]
        waits[side.name] = (w, clock.now - t0)
    assert waits["port"] == waits["reference"]
    assert 0.7 <= waits["port"][1] <= 3.0


def test_token_bucket_rate_change_applies(fake_clocks):
    waits = {}
    for side in (REF, PORT):
        clock = fake_clocks[side.name]
        tb = side.scrub.TokenBucket(1 << 20)
        tb.set_rate(100 << 20)
        t0 = clock.now
        waits[side.name] = (tb.consume(20 << 20), clock.now - t0, tb.rate)
    assert waits["port"] == waits["reference"]
    assert waits["port"][1] < 2.0


def test_token_bucket_oversized_read_does_not_wedge(fake_clocks):
    waits = {}
    for side in (REF, PORT):
        clock = fake_clocks[side.name]
        tb = side.scrub.TokenBucket(1 << 20)
        t0 = clock.now
        tb.consume(3 << 20)
        first = clock.now - t0
        t0 = clock.now
        tb.consume(1)
        waits[side.name] = (first, clock.now - t0)
    assert waits["port"] == waits["reference"]
    first, debt = waits["port"]
    assert first < 2.0 and debt >= 1.0


def test_quarantine_bounds_and_clear():
    status = {}
    for side in (REF, PORT):
        q = side.scrub.Quarantine()
        assert q.mark_needle(1, 7)
        assert not q.mark_needle(1, 7)
        assert q.is_needle_suspect(1, 7)
        q.clear_needle(1, 7)
        assert not q.is_needle_suspect(1, 7)
        for i in range(side.scrub.Quarantine.MAX_PER_VOLUME + 10):
            q.mark_needle(2, i)
        q.mark_shard(3, 11)
        status[side.name] = q.status()
    assert status["port"] == status["reference"]
    assert len(status["port"]["needles"]["2"]) == \
        pscrub.Quarantine.MAX_PER_VOLUME


# -- volume scrub: detection + read-path quarantine ----------------------------


def test_scrub_clean_volume_finds_nothing(tmp_path):
    pair = _open(_twin_dirs(tmp_path, _volume_files(1, 30, 1)))
    try:
        r = _same(pair, lambda side, st, sc: sc.scrub_once())
        assert r["corrupt_needles"] == 0 and r["volumes"] == 1
        assert r["scanned_bytes"] > 0
        assert _state(pair) == ([], {"needles": {}, "shards": {}})
    finally:
        _close(pair)


def test_scrub_detects_flipped_byte_in_dat(tmp_path):
    dirs = _twin_dirs(tmp_path, _volume_files(1, 30, 2))
    for d in dirs.values():
        _flip_byte(os.path.join(d, "1.dat"), _needle_offset(d, 1, 9))
    pair = _open(dirs)
    try:
        r = _same(pair, lambda side, st, sc: sc.scrub_once())
        assert r["corrupt_needles"] == 1
        findings, quarantine = _state(pair)
        assert [(f[1], f[3]) for f in findings] == [("replica", 9)]
        assert quarantine["needles"] == {"1": [9]}
        _same(pair, lambda side, st, sc: sc.scrub_once())
        assert len(_state(pair)[0]) == 1
        _same(pair, lambda side, st, sc: sc.forget_volume(1))
        assert _state(pair) == ([], {"needles": {}, "shards": {}})
    finally:
        _close(pair)


def test_read_path_corruption_is_retryable_and_quarantined(tmp_path):
    dirs = _twin_dirs(tmp_path, _volume_files(1, 10, 3))
    for d in dirs.values():
        _flip_byte(os.path.join(d, "1.dat"), _needle_offset(d, 1, 4))
    pair = _open(dirs)
    try:
        def read(side, st, sc):
            with pytest.raises(side.Corrupt):
                st.read_needle(1, 4)
            return sc.quarantine.is_needle_suspect(1, 4)

        assert _same(pair, read) is True
        _same(pair, lambda side, st, sc: sc._confirm_pending())
        findings, _q = _state(pair)
        assert [f[3] for f in findings] == [4]
        assert _same(pair, lambda side, st, sc: bytes(
            st.read_needle(1, 5).data))
    finally:
        _close(pair)


def test_read_path_transient_error_is_not_reported(tmp_path):
    pair = _open(_twin_dirs(tmp_path, _volume_files(1, 10, 4)))
    try:
        _same(pair, lambda side, st, sc: sc.suspect_needle(1, 6))
        assert _state(pair) == ([], {"needles": {"1": [6]}, "shards": {}})
        _same(pair, lambda side, st, sc: sc._confirm_pending())
        assert _state(pair) == ([], {"needles": {}, "shards": {}})
    finally:
        _close(pair)


def test_scrub_cursor_persists_and_resumes(tmp_path):
    dirs = _twin_dirs(tmp_path, _volume_files(1, 20, 5))
    pair = _open(dirs)
    _same(pair, lambda side, st, sc: sc.scrub_once())
    _close(pair)
    cursors = {}
    for name, d in dirs.items():
        with open(os.path.join(d, pscrub.CURSOR_FILE)) as f:
            cursors[name] = json.load(f)
    assert cursors["port"] == cursors["reference"]
    assert cursors["port"]["volume"]["1"] == 0
    pair = _open(dirs)
    try:
        assert _same(pair, lambda side, st, sc: sc._cursor(
            os.path.realpath(dirs[side.name]), "volume", 1)) == 0
    finally:
        _close(pair)


def test_scrub_resumes_from_cursor_mid_volume(tmp_path):
    """A cursor left mid-volume by an interrupted pass: the next pass
    scans only the needles at or past it, on both sides alike."""
    dirs = _twin_dirs(tmp_path, _volume_files(1, 40, 6))
    for d in dirs.values():
        off = _needle_offset(d, 1, 20) - 22
        with open(os.path.join(d, pscrub.CURSOR_FILE), "w") as f:
            json.dump({"volume": {"1": off}, "ec": {}}, f)
    pair = _open(dirs)
    try:
        r = _same(pair, lambda side, st, sc: sc.scrub_once())
        assert 0 < r["scanned_bytes"] < os.path.getsize(
            os.path.join(dirs["port"], "1.dat"))
    finally:
        _close(pair)


# -- EC scrub: parity verification + localization + read-path failover ---------


@pytest.mark.parametrize("codec", HOST_CODECS)
def test_scrub_detects_flipped_byte_in_ec_shard(tmp_path, codec):
    dirs = _twin_dirs(tmp_path, _ec_volume_files())
    pair = _open(dirs, codec, ec_vid=2)
    try:
        r = _same(pair, lambda side, st, sc: sc.scrub_once())
        assert r["corrupt_shards"] == 0 and r["ec_volumes"] == 1
        for d in dirs.values():
            _flip_byte(os.path.join(d, "2" + to_ext(0)), 5000, 0x5A)
        r = _same(pair, lambda side, st, sc: sc.scrub_once())
        assert r["corrupt_shards"] == 1
        findings, quarantine = _state(pair)
        assert findings == [(2, "ec_shard", 0, 0,
                             "parity mismatch at 0+262144")]
        assert quarantine["shards"] == {"2": [0]}
        _same(pair, lambda side, st, sc: sc.forget_shards(2, [0]))
        assert _state(pair) == ([], {"needles": {}, "shards": {}})
    finally:
        _close(pair)


@pytest.mark.parametrize("codec", HOST_CODECS)
def test_scrub_localizes_corrupt_parity_shard(tmp_path, codec):
    dirs = _twin_dirs(tmp_path, _ec_volume_files(seed=8))
    for d in dirs.values():
        _flip_byte(os.path.join(d, "2" + to_ext(11)), 600, 0x3C)
    pair = _open(dirs, codec, ec_vid=2)
    try:
        _same(pair, lambda side, st, sc: sc.scrub_once())
        findings, quarantine = _state(pair)
        assert findings == [(2, "ec_shard", 11, 0,
                             "parity mismatch at 0+262144")]
        assert quarantine["shards"] == {"2": [11]}
    finally:
        _close(pair)


@pytest.mark.parametrize("codec", HOST_CODECS)
def test_ec_read_serves_through_corruption_byte_identical(tmp_path, codec):
    """A flipped shard byte under a live needle: both read paths serve
    the original bytes and flag the same shard."""
    expected = {}

    def build(d):
        vol = make_volume(d, volume_id=2, n_needles=40, seed=9,
                          max_size=20000)
        base = vol.file_name()
        expected.update({nid: bytes(vol.read_needle(nid).data)
                         for nid in range(1, 41)})
        vol.close()
        write_ec_files(base, codec_name="cpu")
        write_sorted_file_from_idx(base)
        os.remove(base + ".dat")
        os.remove(base + ".idx")

    dirs = _twin_dirs(tmp_path, build)
    for d in dirs.values():
        _flip_byte(os.path.join(d, "2" + to_ext(0)), 5000, 0x77)
    pair = _open(dirs, codec, ec_vid=2)
    try:
        def read_all(side, st, sc):
            marks = []
            st.find_ec_volume(2).corruption_hook = \
                lambda v, s: marks.append((v, s))
            for nid in range(1, 41):
                assert bytes(st.read_needle(2, nid).data) == expected[nid]
            return sorted(set(marks))

        assert (2, 0) in _same(pair, read_all)
    finally:
        _close(pair)


@pytest.mark.parametrize("codec", HOST_CODECS)
def test_scrub_ec_cursor_scan_finds_interval(tmp_path, codec):
    """A scan resumed at an EC cursor (as chip_smoke.py's store phase
    scans the interval of its flipped byte) reports that interval."""
    dirs = _twin_dirs(tmp_path, _ec_volume_files(n_needles=80, seed=10))
    shard = os.path.join(dirs["port"], "2" + to_ext(2))
    size = os.path.getsize(shard)
    pos = size - 1000
    at = pos // (256 << 10) * (256 << 10)
    for d in dirs.values():
        _flip_byte(os.path.join(d, "2" + to_ext(2)), pos, 0x11)
        with open(os.path.join(d, pscrub.CURSOR_FILE), "w") as f:
            json.dump({"volume": {}, "ec": {"2": at}}, f)
    pair = _open(dirs, codec, ec_vid=2)
    try:
        r = _same(pair, lambda side, st, sc: sc.scrub_once())
        assert r["corrupt_shards"] == 1
        assert r["scanned_bytes"] == TOTAL_SHARDS * (size - at)
        findings, quarantine = _state(pair)
        assert findings == [(2, "ec_shard", 2, 0,
                             f"parity mismatch at {at}+{size - at}")]
        assert quarantine["shards"] == {"2": [2]}
    finally:
        _close(pair)


# -- index verification + offline fix_index --------------------------------------


def test_fix_index_rebuilds_from_dat(tmp_path):
    from seaweedfs_tpu.tools.offline import fix_index as ref_fix
    from seaweedfs_tpu_torch.storage.idx import walk_index_file
    from seaweedfs_tpu_torch.tools.offline import fix_index

    def build(d):
        vol = make_volume(d, volume_id=3, n_needles=25, seed=10)
        vol.delete_needle(5, at_ns=1)
        vol.delete_needle(6, at_ns=2)
        vol.close()

    dirs = _twin_dirs(tmp_path, build)
    before = {}
    for key, offset, size in walk_index_file(
            os.path.join(dirs["port"], "3.idx")):
        if size > 0:
            before[key] = (offset, size)
        else:
            before.pop(key, None)
    for d in dirs.values():
        os.remove(os.path.join(d, "3.idx"))
    assert ref_fix(dirs["reference"], 3) == fix_index(dirs["port"], 3) == 23
    idx = [open(os.path.join(d, "3.idx"), "rb").read()
           for d in dirs.values()]
    assert idx[0] == idx[1]
    rebuilt = {k: (o, s) for k, o, s in walk_index_file(
        os.path.join(dirs["port"], "3.idx"))}
    assert rebuilt == before


def test_fix_index_missing_dat_raises(tmp_path):
    from seaweedfs_tpu_torch.tools.offline import fix_index

    with pytest.raises(FileNotFoundError):
        fix_index(str(tmp_path), 99)


def test_scrub_repairs_corrupt_index(tmp_path):
    dirs = _twin_dirs(tmp_path, _volume_files(4, 20, 11))
    pair = _open(dirs)
    # one entry's offset field rots on disk, the in-memory map unaffected
    for d in dirs.values():
        _flip_byte(os.path.join(d, "4.idx"), 16 * 3 + 9)
    try:
        r = _same(pair, lambda side, st, sc: sc.scrub_once())
        assert r["index_repairs"] == 1
        assert _same(pair, lambda side, st, sc: sc._verify_index(
            st.find_volume(4))) is True
        assert _same(pair, lambda side, st, sc: st.read_needle(4, 7).id) == 7
        r2 = _same(pair, lambda side, st, sc: sc.scrub_once())
        assert r2["index_repairs"] == 0
        idx = [open(os.path.join(d, "4.idx"), "rb").read()
               for d in dirs.values()]
        assert idx[0] == idx[1]
    finally:
        _close(pair)


# -- vacuum verifies while copying -----------------------------------------------


def test_vacuum_reports_corrupt_needle_for_repair(tmp_path):
    dirs = _twin_dirs(tmp_path, _volume_files(5, 12, 20))
    for d in dirs.values():
        _flip_byte(os.path.join(d, "5.dat"), _needle_offset(d, 5, 4))
    pair = _open(dirs)
    try:
        def vacuum(side, st, sc):
            st.compact_volume(5)
            st.commit_compact_volume(5)

        _same(pair, vacuum)
        findings, _q = _state(pair)
        assert [(f[1], f[3]) for f in findings] == [("replica", 4)]
        for ext in (".dat", ".idx"):
            got = [open(os.path.join(d, "5" + ext), "rb").read()
                   for d in dirs.values()]
            assert got[0] == got[1], ext
    finally:
        _close(pair)


def test_vacuum_skips_corrupt_needle(tmp_path):
    from seaweedfs_tpu.stats.metrics import SCRUB_ERRORS as REF_ERRORS
    from seaweedfs_tpu.storage.vacuum import vacuum_volume as ref_vacuum
    from seaweedfs_tpu.storage.volume import Volume as RefVolume
    from seaweedfs_tpu_torch.stats.metrics import SCRUB_ERRORS
    from seaweedfs_tpu_torch.storage.vacuum import vacuum_volume
    from seaweedfs_tpu_torch.storage.volume import Volume

    def build(d):
        vol = make_volume(d, volume_id=5, n_needles=20, seed=12)
        vol.delete_needle(3, at_ns=7)
        vol.close()

    dirs = _twin_dirs(tmp_path, build)
    expected = None
    for d in dirs.values():
        _flip_byte(os.path.join(d, "5.dat"), _needle_offset(d, 5, 8))
    for name, vol_cls, vacuum, errors in (
            ("reference", RefVolume, ref_vacuum, REF_ERRORS),
            ("port", Volume, vacuum_volume, SCRUB_ERRORS)):
        vol = vol_cls(dirs[name], "", 5)
        before = errors.labels("vacuum").value
        vacuum(vol)
        assert errors.labels("vacuum").value == before + 1
        assert vol.needle_map.get(8) is None
        got = {nid: bytes(vol.read_needle(nid).data)
               for nid in range(1, 21) if nid not in (3, 8)}
        assert expected is None or got == expected
        expected = got
        vol.close()
    for ext in (".dat", ".idx"):
        got = [open(os.path.join(d, "5" + ext), "rb").read()
               for d in dirs.values()]
        assert got[0] == got[1], ext


# -- a cuda store on a host without a card ----------------------------------------


@pytest.mark.parametrize("service", ["1", "0"],
                         ids=["service_on", "service_off"])
def test_cuda_store_ec_scrub_raises(tmp_path, monkeypatch, service):
    """The scrubber verifies parity on the store's own codec: with the
    service on, service_for_codec finds no card and answers None; with it
    off, None too; either way get_codec("cuda") raises, and nothing is
    verified on the host.  The EC volume is mounted on a host codec by
    hand, because a `cuda` EcVolume cannot be opened without a card."""
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SERVICE", service)

    def refuse(name):
        raise AssertionError(f"effective_codec({name!r}) consulted")

    monkeypatch.setattr(pcodec, "effective_codec", refuse)
    _ec_volume_files()(str(tmp_path))
    store = Store([str(tmp_path / "empty")], needle_cache_mb=0)
    assert store.codec_name == "cuda"
    try:
        ev = EcVolume(str(tmp_path / "2"), 2, codec_name="cpu")
        store.locations[0].ec_volumes[2] = ev
        scrubber = pscrub.Scrubber(store, rate_mbps=0)
        with pytest.raises(RuntimeError, match="CUDA"):
            scrubber.scrub_volume(2)
        assert scrubber.outstanding_findings() == []
        assert scrubber.status()["counts"]["scanned_bytes"] == 0
    finally:
        store.close()
