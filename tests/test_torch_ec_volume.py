"""The port's EcVolume (needle reads, degraded reads, deletes) and its
remote-source rebuild, held against the reference on the CPU.

Volumes are written by the reference's writer (real needle records,
version 3) and encoded by the reference, so the port reads files the
reference made.  The reference runs on its `cpu` codec, the port on `cpu`
(the native SIMD library) and `torch_cpu` (the kernel's plain PyTorch
version); every comparison is byte equality.  Concurrency is asserted with
gates (events and barriers), never with sleeps or thread-count snapshots:
the tier-1 run shares the host with other workers.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from seaweedfs_tpu.ops.rs_cpu import ReedSolomon as RefRS
from seaweedfs_tpu.storage import types as rt
from seaweedfs_tpu.storage import vif as rvif
from seaweedfs_tpu.storage.ec import encoder as renc
from seaweedfs_tpu.storage.ec.volume import EcVolume as RefEcVolume
from seaweedfs_tpu_torch.ops import codec_service
from seaweedfs_tpu_torch.ops.codec_service import CodecService
from seaweedfs_tpu_torch.stats.metrics import (
    EC_INTERVAL_CACHE,
    EC_PREADV_BATCHES,
    EC_SINGLEFLIGHT,
)
from seaweedfs_tpu_torch.storage import types as pt
from seaweedfs_tpu_torch.storage.ec import encoder as penc
from seaweedfs_tpu_torch.storage.ec import volume as pvol
from seaweedfs_tpu_torch.storage.ec.constants import TOTAL_SHARDS, to_ext
from seaweedfs_tpu_torch.storage.ec.locate import locate_data
from seaweedfs_tpu_torch.storage.ec.volume import EcVolume, NotFoundError

from helpers import make_volume

HOST_CODECS = ("cpu", "torch_cpu")
# block sizes: the needle volume stripes over large rows and then small
# ones, so needles cross block and row edges; the reference ec_test.go's
# scaled sizes for the counterparts of its tests
NEEDLE_LARGE, NEEDLE_SMALL = 100_000, 10_000
LARGE, SMALL = 10000, 100
N_NEEDLES = 90


def _encode_with_reference(base, large, small):
    renc.generate_ec_files(base, large_block_size=large,
                           small_block_size=small, codec_name="cpu",
                           slice_size=1 << 20)
    renc.write_sorted_file_from_idx(base)


@pytest.fixture(scope="module")
def needle_volume(tmp_path_factory):
    """Real needles of 1 B to 64 KiB (names and mimes on some), written and
    encoded by the reference; a .vif with the .dat size beside."""
    d = tmp_path_factory.mktemp("needles")
    vol = make_volume(str(d), n_needles=N_NEEDLES, seed=31, max_size=65536)
    base = vol.file_name()
    vol.close()
    _encode_with_reference(base, NEEDLE_LARGE, NEEDLE_SMALL)
    rvif.save_volume_info(base + ".vif", 3, "000",
                          dat_file_size=os.path.getsize(base + ".dat"))
    return base


def _copy_volume(base, dest_dir, shards=range(TOTAL_SHARDS)):
    os.makedirs(dest_dir, exist_ok=True)
    out = os.path.join(dest_dir, os.path.basename(base))
    for ext in [".ecx", ".vif"] + [to_ext(i) for i in shards]:
        if os.path.exists(base + ext):
            shutil.copyfile(base + ext, out + ext)
    return out


def _needle_fields(n) -> dict:
    d = {f.name: getattr(n, f.name) for f in dataclasses.fields(n)}
    d["ttl"] = None if d["ttl"] is None else (d["ttl"].count, d["ttl"].unit)
    return d


def _shard_bytes(base):
    return {i: open(base + to_ext(i), "rb").read() for i in range(TOTAL_SHARDS)}


def _file_fetch(base, serve):
    """A remote_fetch answering shards in `serve` from `base`'s files."""
    def fetch(sid, off, length):
        if sid not in serve:
            return None
        with open(base + to_ext(sid), "rb") as f:
            f.seek(off)
            return f.read(length)
    return fetch


LOSSES = {
    "none": (),
    "ec00-ec03": (0, 1, 2, 3),
    "2-5-11-13": (2, 5, 11, 13),
    "ec10-ec13": (10, 11, 12, 13),
    "remote-only": tuple(range(TOTAL_SHARDS)),
}


def _open_pair(base, codec, lost, remote_only):
    ref = RefEcVolume(base, volume_id=1, codec_name="cpu",
                      large_block_size=NEEDLE_LARGE,
                      small_block_size=NEEDLE_SMALL)
    port = EcVolume(base, volume_id=1, codec_name=codec,
                    large_block_size=NEEDLE_LARGE,
                    small_block_size=NEEDLE_SMALL)
    for ev in (ref, port):
        for sid in lost:
            ev.delete_shard(sid)
        if remote_only:  # every shard held by a peer: only the hook reads
            ev.remote_fetch = _file_fetch(base, set(range(TOTAL_SHARDS)))
    return ref, port


@pytest.mark.parametrize("codec", HOST_CODECS)
@pytest.mark.parametrize("loss", list(LOSSES), ids=list(LOSSES))
def test_read_every_needle_as_reference(needle_volume, tmp_path, codec, loss):
    """Every key's Needle (all fields, data) equals the reference's, with
    the loss pattern's shards unmounted; the remote-only volume holds no
    shard and sizes itself from the .vif."""
    base = _copy_volume(needle_volume, str(tmp_path))
    remote_only = loss == "remote-only"
    ref, port = _open_pair(base, codec, LOSSES[loss], remote_only)
    try:
        assert port.shard_ids() == ref.shard_ids()
        assert port.shard_size == ref.shard_size
        for key in range(1, N_NEEDLES + 1):
            want = ref.read_needle(key)
            got = port.read_needle(key)
            assert _needle_fields(got) == _needle_fields(want), key
        with pytest.raises(NotFoundError):
            port.read_needle(N_NEEDLES + 7)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("codec", HOST_CODECS)
def test_reads_after_delete_as_reference(needle_volume, tmp_path, codec):
    """Deletes tombstone the .ecx in place and append to the .ecj as the
    reference does; deleted keys raise, the rest read as the reference."""
    base = _copy_volume(needle_volume, str(tmp_path / "port"))
    rbase = _copy_volume(needle_volume, str(tmp_path / "ref"))
    port = EcVolume(base, volume_id=1, codec_name=codec,
                    large_block_size=NEEDLE_LARGE,
                    small_block_size=NEEDLE_SMALL)
    ref = RefEcVolume(rbase, volume_id=1, codec_name="cpu",
                      large_block_size=NEEDLE_LARGE,
                      small_block_size=NEEDLE_SMALL)
    deleted = (1, 7, 30, N_NEEDLES)
    try:
        for ev in (port, ref):
            for sid in (0, 1, 2, 3):
                ev.delete_shard(sid)
        seq = port.delete_seq
        for key in deleted + (N_NEEDLES + 5,):  # an absent key is a no-op
            port.delete_needle(key)
            ref.delete_needle(key)
        assert port.delete_seq == seq + len(deleted)
        for ext in (".ecx", ".ecj"):
            assert open(base + ext, "rb").read() \
                == open(rbase + ext, "rb").read(), ext
        for key in range(1, N_NEEDLES + 1):
            if key in deleted:
                with pytest.raises(NotFoundError):
                    port.read_needle(key)
                continue
            assert _needle_fields(port.read_needle(key)) \
                == _needle_fields(ref.read_needle(key))
        assert port.first_live_needle() == ref.first_live_needle() == 2
        # tombstones keep the tail's extent: the .ecx-derived size holds
        assert port._shard_size_from_ecx() == ref._shard_size_from_ecx()
    finally:
        port.close()
        ref.close()
    # a reopened volume reads the tombstones from disk
    again = EcVolume(base, volume_id=1, codec_name=codec,
                     large_block_size=NEEDLE_LARGE,
                     small_block_size=NEEDLE_SMALL)
    try:
        with pytest.raises(NotFoundError):
            again.read_needle(7)
        assert again.read_needle(8).id == 8
    finally:
        again.close()


def test_ecx_search_without_the_key_cache(needle_volume, tmp_path,
                                          monkeypatch):
    """The pread binary search (volumes too large for the key cache) finds
    what the cached search finds."""
    base = _copy_volume(needle_volume, str(tmp_path))
    cached = EcVolume(base, codec_name="cpu", large_block_size=NEEDLE_LARGE,
                      small_block_size=NEEDLE_SMALL)
    monkeypatch.setattr(EcVolume, "_ECX_KEY_CACHE_MAX", 0)
    plain = EcVolume(base, codec_name="cpu", large_block_size=NEEDLE_LARGE,
                     small_block_size=NEEDLE_SMALL)
    try:
        for key in range(0, N_NEEDLES + 3):
            assert plain._search_ecx(key) == cached._search_ecx(key)
        assert plain._ecx_keys() is None
    finally:
        cached.close()
        plain.close()


def test_batched_preadv_and_odirect_reads(needle_volume, tmp_path,
                                          monkeypatch):
    """A needle spanning many blocks of one shard is gathered with one
    preadv per contiguous run; with O_DIRECT asked for (or refused by the
    filesystem) the bytes are the same."""
    base = _copy_volume(needle_volume, str(tmp_path))
    ref = RefEcVolume(base, volume_id=1, codec_name="cpu",
                      large_block_size=1000, small_block_size=100)
    want = {}
    sizes = {}
    for key in range(1, N_NEEDLES + 1):
        offset, size, _ = ref.locate(key)
        want[key] = ref._read_intervals(ref.locate(key)[2])
        sizes[key] = size
    ref.close()
    for odirect in ("0", "1"):
        monkeypatch.setenv("SEAWEEDFS_TPU_EC_ODIRECT", odirect)
        ev = EcVolume(base, volume_id=1, codec_name="cpu",
                      large_block_size=1000, small_block_size=100)
        before = EC_PREADV_BATCHES.labels().value
        try:
            for key in range(1, N_NEEDLES + 1):
                got = ev._read_intervals(ev.locate(key)[2])
                assert got == want[key], key
        finally:
            ev.close()
        assert EC_PREADV_BATCHES.labels().value > before


def test_corrupt_shard_bytes_are_reconstructed_and_reported(needle_volume,
                                                            tmp_path):
    """Rotten bytes in a local shard fail the needle's CRC; the read
    rebuilds its intervals from the other shards, serves the right needle
    and names the shard through corruption_hook, as the reference does."""
    base = _copy_volume(needle_volume, str(tmp_path))
    ev = EcVolume(base, volume_id=1, codec_name="cpu",
                  large_block_size=NEEDLE_LARGE,
                  small_block_size=NEEDLE_SMALL)
    key = 12
    want = ev.read_needle(key)
    _off, _size, ivs = ev.locate(key)
    sid, soff = ivs[0].to_shard_id_and_offset(NEEDLE_LARGE, NEEDLE_SMALL)
    ev.close()
    with open(base + to_ext(sid), "r+b") as f:  # flip a payload byte
        f.seek(soff + pt.NEEDLE_HEADER_SIZE + 6)
        b = f.read(1)
        f.seek(soff + pt.NEEDLE_HEADER_SIZE + 6)
        f.write(bytes([b[0] ^ 0xFF]))
    reported = []
    ev = EcVolume(base, volume_id=1, codec_name="cpu",
                  large_block_size=NEEDLE_LARGE,
                  small_block_size=NEEDLE_SMALL)
    ev.corruption_hook = lambda vid, shard: reported.append((vid, shard))
    try:
        got = ev.read_needle(key)
    finally:
        ev.close()
    assert got.data == want.data and got.id == key
    assert reported == [(1, sid)]


@pytest.mark.parametrize("codec", HOST_CODECS)
def test_canary_read_reconstructs_and_checks(needle_volume, tmp_path, codec):
    base = _copy_volume(needle_volume, str(tmp_path))
    ev = EcVolume(base, volume_id=1, codec_name=codec,
                  large_block_size=NEEDLE_LARGE,
                  small_block_size=NEEDLE_SMALL)
    ref = RefEcVolume(base, volume_id=1, codec_name="cpu",
                      large_block_size=NEEDLE_LARGE,
                      small_block_size=NEEDLE_SMALL)
    try:
        assert ev.canary_read() == ref.canary_read()
        got = ev.canary_read(drop_shard=0)
        assert got["reconstructed"] and got["needleId"] == "1"
    finally:
        ev.close()
        ref.close()


def test_degraded_reads_through_the_host_service(needle_volume, tmp_path,
                                                 monkeypatch):
    """SEAWEEDFS_TPU_EC_SERVICE_DEGRADED=1 routes each degraded interval
    through the shared host-mode service (the native cpu codec); the bytes
    are the reference's."""
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_SERVICE_DEGRADED", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_INTERVAL_CACHE_MB", "0")
    base = _copy_volume(needle_volume, str(tmp_path))
    ref, port = _open_pair(base, "torch_cpu", (0, 1, 2, 3), False)
    svc = codec_service.service_for_degraded()
    assert svc is not None and svc.mode == "host" and svc.codec_name == "cpu"
    try:
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(port.read_needle, range(1, N_NEEDLES + 1)))
        for key, n in zip(range(1, N_NEEDLES + 1), got):
            assert _needle_fields(n) == _needle_fields(ref.read_needle(key))
    finally:
        ref.close()
        port.close()
        codec_service.shutdown_all(timeout=10)


# -- counterparts of tests/test_ec_pipeline.py --------------------------------


@pytest.fixture()
def synthetic_base(tmp_path):
    vol = make_volume(str(tmp_path), n_needles=80, seed=3, max_size=3000)
    base = vol.file_name()
    vol.close()
    _encode_with_reference(base, LARGE, SMALL)
    return base


def test_ec_volume_runtime(synthetic_base):
    ev = EcVolume(synthetic_base, volume_id=1, version=3, codec_name="cpu",
                  large_block_size=LARGE, small_block_size=SMALL)
    n = ev.read_needle(5)
    assert n.id == 5
    for sid in (0, 1, 2, 3):  # degraded: 4 shards gone from the view
        ev.delete_shard(sid)
    n2 = ev.read_needle(5)
    assert n2.data == n.data
    ev.delete_needle(5)
    with pytest.raises((NotFoundError, KeyError)):
        ev.read_needle(5)
    assert os.path.exists(synthetic_base + ".ecj")
    ev.close()


def test_ec_volume_remote_only_reads(synthetic_base):
    """With only the .ecx (no .vif, every shard remote) the volume sizes
    itself from the index and reads through the remote-fetch hook."""
    ref = RefEcVolume(synthetic_base, volume_id=1, version=3,
                      large_block_size=LARGE, small_block_size=SMALL)
    want = ref.read_needle(5)
    real_shard_size = ref.shard_size
    ref.close()
    ev = EcVolume(synthetic_base, volume_id=1, version=3,
                  codec_name="torch_cpu", large_block_size=LARGE,
                  small_block_size=SMALL)
    for sid in list(ev.shards):
        ev.delete_shard(sid)
    ev.remote_fetch = _file_fetch(synthetic_base, set(range(TOTAL_SHARDS)))
    assert not os.path.exists(synthetic_base + ".vif")
    assert ev.shard_size == real_shard_size
    got = ev.read_needle(5)
    assert got.data == want.data
    ev.close()


def test_random_10_of_14_reconstruction(synthetic_base):
    """As the reference's: intervals of real needles rebuilt by the port's
    codecs from 10 random other shards equal the shard bytes."""
    from seaweedfs_tpu_torch.ops.codec import get_codec
    from seaweedfs_tpu_torch.storage.idx import parse_index_arrays

    rng = np.random.default_rng(4)
    keys, offsets, sizes = parse_index_arrays(synthetic_base + ".idx")
    dat_size = os.path.getsize(synthetic_base + ".dat")
    shards_on_disk = _shard_bytes(synthetic_base)
    codecs = [get_codec(n) for n in HOST_CODECS]
    for off, size in list(zip(offsets, sizes))[:20]:
        for iv in locate_data(LARGE, SMALL, dat_size, int(off), max(int(size), 1)):
            sid, soff = iv.to_shard_id_and_offset(LARGE, SMALL)
            want = shards_on_disk[sid][soff: soff + iv.size]
            others = [i for i in range(TOTAL_SHARDS) if i != sid]
            chosen = rng.choice(others, 10, replace=False)
            shards = [None] * TOTAL_SHARDS
            for i in chosen:
                shards[int(i)] = np.frombuffer(
                    shards_on_disk[int(i)][soff: soff + iv.size], np.uint8)
            for codec in codecs:
                got = np.asarray(codec.reconstruct(list(shards))[sid]).tobytes()
                assert got == want
            break  # one interval per needle keeps the runtime down


# -- counterparts of tests/test_ec_repair.py ----------------------------------


def _degraded_volume(base, codec="cpu"):
    """EcVolume with the first 4 data shards gone."""
    for sid in range(4):
        os.remove(base + to_ext(sid))
    return EcVolume(base, volume_id=1, version=3, codec_name=codec,
                    large_block_size=LARGE, small_block_size=SMALL)


def _count_gathers(ev):
    counter = {"n": 0}
    inner = ev._gather_and_decode

    def counting(shard_id, offset, length):
        counter["n"] += 1
        return inner(shard_id, offset, length)

    ev._gather_and_decode = counting
    return counter


def test_interval_cache_serves_repeat_reads(synthetic_base):
    ev = _degraded_volume(synthetic_base)
    counter = _count_gathers(ev)
    hits = EC_INTERVAL_CACHE.labels("hit").value
    first = ev._reconstruct_interval(1, 0, 512)
    again = ev._reconstruct_interval(1, 0, 512)
    assert first == again
    assert counter["n"] == 1, "second read must come from the interval LRU"
    assert EC_INTERVAL_CACHE.labels("hit").value == hits + 1
    ev.close()


def test_interval_cache_invalidated_on_unmount_and_delete(synthetic_base):
    for sid in range(3):  # 11 mounted: one more can go and 10 remain
        os.remove(synthetic_base + to_ext(sid))
    ev = EcVolume(synthetic_base, volume_id=1, version=3, codec_name="cpu",
                  large_block_size=LARGE, small_block_size=SMALL)
    counter = _count_gathers(ev)
    ev._reconstruct_interval(2, 0, 512)
    assert counter["n"] == 1
    ev.delete_shard(13)  # the layout changed wholesale: gather again
    ev._reconstruct_interval(2, 0, 512)
    assert counter["n"] == 2
    ev.add_shard(13)
    ev._reconstruct_interval(2, 0, 512)
    assert counter["n"] == 3
    ev.delete_needle(9)  # delete_seq moves: cached intervals are stale
    ev._reconstruct_interval(2, 0, 512)
    assert counter["n"] == 4
    ev.close()


def test_interval_cache_compare_before_publish(synthetic_base):
    """A delete racing the gather must prevent the stale publish."""
    ev = _degraded_volume(synthetic_base)
    inner = ev._gather_and_decode

    def racing(shard_id, offset, length):
        data, token = inner(shard_id, offset, length)
        ev.delete_needle(11)  # bump delete_seq after the capture
        return data, token

    ev._gather_and_decode = racing
    ev._reconstruct_interval(3, 0, 256)
    assert len(ev._interval_cache) == 0, "a stale interval was published"
    ev.close()


def _remote_volume(base, gone=range(6)):
    """The first shards removed locally, their bytes kept for a peer."""
    originals = _shard_bytes(base)
    for sid in gone:
        os.remove(base + to_ext(sid))
    return originals


def test_single_flight_coalesces_concurrent_readers(synthetic_base):
    """16 readers of one lost interval make ONE gather: the leader's remote
    fetch is held on a gate until all 15 others have joined as followers
    (counted by the single-flight metric), so the outcome does not depend
    on timing."""
    originals = _remote_volume(synthetic_base)
    ev = EcVolume(synthetic_base, volume_id=1, version=3, codec_name="cpu",
                  large_block_size=LARGE, small_block_size=SMALL)
    gate = threading.Event()
    fetched = []

    def fetch(sid, off, length):
        if sid not in (4, 5):
            return None
        gate.wait(60)
        fetched.append(sid)
        return originals[sid][off:off + length]

    ev.remote_fetch = fetch
    counter = _count_gathers(ev)
    coalesced = EC_SINGLEFLIGHT.labels("coalesced")
    leaders = EC_SINGLEFLIGHT.labels("leader")
    c0, l0 = coalesced.value, leaders.value
    length = 256
    with ThreadPoolExecutor(max_workers=16) as pool:
        futs = [pool.submit(ev._reconstruct_interval, 0, 0, length)
                for _ in range(16)]
        deadline = time.monotonic() + 60
        while coalesced.value < c0 + 15 and time.monotonic() < deadline:
            time.sleep(0.001)  # waits for the followers; asserts nothing
        joined = coalesced.value - c0
        gate.set()
        results = [f.result(60) for f in futs]
    ev.close()
    assert joined == 15
    assert counter["n"] == 1 and leaders.value == l0 + 1
    assert sorted(fetched) == [4, 5]
    assert all(r == originals[0][:length] for r in results)


def test_degraded_reads_spawn_no_new_threads(synthetic_base):
    """Remote fetches of every degraded read run on ONE shared, bounded
    pool: across 40 reads of distinct intervals the fetching threads are
    that pool's own, never more than its workers."""
    originals = _remote_volume(synthetic_base)
    ev = EcVolume(synthetic_base, volume_id=1, version=3, codec_name="cpu",
                  large_block_size=LARGE, small_block_size=SMALL)
    threads = set()
    lock = threading.Lock()

    def fetch(sid, off, length):
        with lock:
            threads.add(threading.current_thread())
        return originals[sid][off:off + length]

    ev.remote_fetch = fetch
    pool = pvol._fetch_pool()
    for i in range(40):
        got, _token = ev._gather_and_decode(0, i * 11, 64)
        assert got == originals[0][i * 11:i * 11 + 64]
    ev.close()
    assert pvol._fetch_pool() is pool
    assert threads and len(threads) <= pool._max_workers
    assert all(t.name.startswith("ec-fetch") for t in threads)
    assert threads <= set(pool._threads)


def test_rebuild_progress_monotonic(synthetic_base):
    for sid in (0, 11):
        os.remove(synthetic_base + to_ext(sid))
    seen = []
    penc.rebuild_ec_files(synthetic_base, codec_name="cpu", slice_size=1000,
                          progress=seen.append)
    assert seen == sorted(seen) and seen, "progress must be monotonic"
    assert seen[-1] == os.path.getsize(synthetic_base + to_ext(0))
    assert len(seen) == -(-seen[-1] // 1000)


ROUTES = ["direct-cpu", "direct-torch_cpu", "service-host", "service-device-cpu"]


def _route(name):
    """-> (codec name, service) of a rebuild route."""
    if name.startswith("direct-"):
        return name[len("direct-"):], None
    if name == "service-host":
        return "torch_cpu", CodecService(mode="host")
    return "torch_cpu", CodecService(mode="device", device="cpu")


@pytest.mark.parametrize("route", ROUTES)
def test_rebuild_remote_source_hook(synthetic_base, route):
    """A node with 8 local shards streams missing sources from a peer and
    rebuilds only the GLOBALLY missing shards, byte-equal to the original;
    without the hook it refuses cleanly."""
    originals = _remote_volume(synthetic_base)  # 0-5 gone, 8 local
    peer_holds = {4, 5}
    with pytest.raises(ValueError):
        penc.rebuild_ec_files(synthetic_base, codec_name="cpu",
                              slice_size=1000)
    for sid in range(6):
        assert not os.path.exists(synthetic_base + to_ext(sid))
    calls = []

    def fetch(sid, off, length):
        if sid not in peer_holds:
            return None
        calls.append(sid)
        return originals[sid][off:off + length]

    codec, svc = _route(route)
    try:
        rebuilt = penc.rebuild_ec_files(synthetic_base, codec_name=codec,
                                        slice_size=1000, remote_fetch=fetch,
                                        service=svc)
    finally:
        if svc is not None:
            svc.close()
    assert sorted(rebuilt) == [0, 1, 2, 3]
    assert calls, "remote sources must have been streamed"
    for sid in (0, 1, 2, 3):
        assert open(synthetic_base + to_ext(sid), "rb").read() \
            == originals[sid], f"shard {sid} differs via the remote hook"
    for sid in peer_holds:  # healthy on a peer: not regenerated here
        assert not os.path.exists(synthetic_base + to_ext(sid))


def test_rebuild_remote_source_dies_cleanly(synthetic_base):
    """A peer dying mid-rebuild surfaces IOError and leaves NO partial
    .ecNN; a retry against a healthy peer is byte-identical."""
    originals = _remote_volume(synthetic_base, gone=range(5))
    budget = {"n": 4}  # the probe and a few slices, then the peer dies

    def dying_fetch(sid, off, length):
        if sid != 4 or budget["n"] <= 0:
            return None
        budget["n"] -= 1
        return originals[sid][off:off + length]

    with pytest.raises(IOError):
        penc.rebuild_ec_files(synthetic_base, codec_name="cpu",
                              slice_size=1000, remote_fetch=dying_fetch)
    for sid in range(5):
        assert not os.path.exists(synthetic_base + to_ext(sid)), \
            f"partial shard {sid} must be removed on error"
    rebuilt = penc.rebuild_ec_files(
        synthetic_base, codec_name="cpu", slice_size=1000,
        remote_fetch=lambda sid, off, ln: (
            originals[sid][off:off + ln] if sid == 4 else None))
    assert sorted(rebuilt) == [0, 1, 2, 3]
    for sid in (0, 1, 2, 3):
        assert open(synthetic_base + to_ext(sid), "rb").read() \
            == originals[sid]


@pytest.mark.parametrize("route", ROUTES)
def test_remote_rebuild_equals_reference_rebuild(needle_volume, tmp_path,
                                                 route):
    """6 local shards (.ec04-.ec09), a peer serving .ec10-.ec13: the port
    rebuilds exactly .ec00-.ec03, equal to the reference's rebuild of the
    same loss."""
    port = _copy_volume(needle_volume, str(tmp_path / "port"), range(4, 10))
    ref = _copy_volume(needle_volume, str(tmp_path / "ref"), range(4, 10))
    fetch = _file_fetch(needle_volume, set(range(10, 14)))
    want = renc.rebuild_ec_files(ref, codec_name="cpu", remote_fetch=fetch,
                                 slice_size=1 << 16)
    codec, svc = _route(route)
    try:
        got = penc.rebuild_ec_files(port, codec_name=codec, remote_fetch=fetch,
                                    slice_size=1 << 16, service=svc)
    finally:
        if svc is not None:
            svc.close()
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for sid in range(4):
        assert open(port + to_ext(sid), "rb").read() \
            == open(ref + to_ext(sid), "rb").read() \
            == open(needle_volume + to_ext(sid), "rb").read()
    for sid in range(10, 14):
        assert not os.path.exists(port + to_ext(sid))


def test_remote_only_rebuild_needs_shard_size(needle_volume, tmp_path):
    """No local shard: the stream is sized by `shard_size`, and refused
    without it."""
    base = _copy_volume(needle_volume, str(tmp_path), ())
    fetch = _file_fetch(needle_volume, set(range(4, 14)))
    with pytest.raises(ValueError, match="shard_size"):
        penc.rebuild_ec_files(base, codec_name="cpu", remote_fetch=fetch)
    size = os.path.getsize(needle_volume + to_ext(0))
    assert penc.rebuild_ec_files(base, codec_name="cpu", remote_fetch=fetch,
                                 shard_size=size) == [0, 1, 2, 3]
    for sid in range(4):
        assert open(base + to_ext(sid), "rb").read() \
            == open(needle_volume + to_ext(sid), "rb").read()


# -- counterparts of tests/test_degraded_read.py ------------------------------


def test_reconstruct_interval_fetches_concurrently(tmp_path):
    """The remote fetches of one degraded interval run at once: each fetch
    waits at a barrier of all 13, which only concurrent fetches pass (a
    sequential fan-out would break the barrier and fail the read)."""
    rs = RefRS()
    rng = np.random.default_rng(3)
    length = 4096
    shards = [rng.integers(0, 256, length, dtype=np.uint8) for _ in range(10)]
    shards += [np.zeros(length, dtype=np.uint8) for _ in range(4)]
    rs.encode(shards)
    base = str(tmp_path / "1")
    with open(base + ".ecx", "wb") as f:  # one never-read entry to open on
        f.write(rt.pack_index_entry(1, 0, 8))
    ev = EcVolume(base, volume_id=1, codec_name="cpu")
    barrier = threading.Barrier(13, timeout=60)

    def fetch(shard_id, offset, size):
        if shard_id == 0:
            return None  # the lost shard: reconstructed on the fly
        barrier.wait()
        return shards[shard_id][offset: offset + size].tobytes()

    ev.remote_fetch = fetch
    got = ev.read_shard_interval(0, 0, length)
    ev.close()
    assert got == shards[0].tobytes()
    assert not barrier.broken


def test_concurrent_degraded_reads_share_file_handles(tmp_path):
    """Positioned I/O: concurrent needle reads on one EcVolume do not
    corrupt each other."""
    vol = make_volume(str(tmp_path), n_needles=120, seed=9, max_size=60000)
    base = vol.file_name()
    vol.close()
    renc.generate_ec_files(base, codec_name="cpu")
    renc.write_sorted_file_from_idx(base)
    for sid in range(4):
        os.remove(base + to_ext(sid))
    ev = EcVolume(base, volume_id=1, codec_name="cpu")

    def reader(seed: int) -> int:
        rng = np.random.default_rng(seed)
        ok = 0
        for _ in range(60):
            nid = int(rng.integers(1, 121))
            assert ev.read_needle(nid).id == nid
            ok += 1
        return ok

    with ThreadPoolExecutor(max_workers=8) as pool:
        counts = list(pool.map(reader, range(8)))
    ev.close()
    assert sum(counts) == 8 * 60


def test_port_volume_defaults_to_the_card_codec():
    """codec_name defaults to "cuda", as the port's encoder does; without a
    card the constructor raises rather than serve from the host."""
    import inspect

    import torch

    assert inspect.signature(EcVolume).parameters["codec_name"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        EcVolume("/nonexistent/1")
