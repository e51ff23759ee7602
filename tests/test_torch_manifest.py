"""The port's manifest chunks and filer chunk cache held against the
reference's (tests/test_manifest.py, without its mount case, which comes
with the mount in ROADMAP A-7): the same chunk lists fold into the same
manifests, byte for byte, and resolve back; a manifest cycle is refused;
a manifest blob folded by either package resolves in the other; and a
port filer with a tiny manifest batch manifestizes, reads back, caches
and garbage-collects large files."""

from __future__ import annotations

import gzip
import time
import urllib.error
import urllib.request

import pytest
from helpers import free_port

from seaweedfs_tpu.filer import filechunk_manifest as ref_fcm
from seaweedfs_tpu.pb import filer_pb2 as ref_pb
from seaweedfs_tpu_torch.filer import filechunk_manifest as fcm
from seaweedfs_tpu_torch.filer import filechunks
from seaweedfs_tpu_torch.pb import filer_pb2 as pb

SIDES = {"port": (fcm, pb), "ref": (ref_fcm, ref_pb)}


class BlobStore:
    """In-memory save/fetch pair for unit tests."""

    def __init__(self, mpb):
        self.pb = mpb
        self.blobs = {}
        self.n = 0

    def save(self, data: bytes):
        self.n += 1
        fid = f"m,{self.n:x}"
        self.blobs[fid] = data
        return self.pb.FileChunk(file_id=fid, size=len(data))

    def fetch(self, fid: str) -> bytes:
        return self.blobs[fid]


def _chunks(mpb, n, size):
    return [mpb.FileChunk(file_id=f"1,{i:x}", offset=i * size, size=size,
                          mtime=i) for i in range(n)]


def _fold(side, n, size, batch, twice=False):
    mod, mpb = SIDES[side]
    store = BlobStore(mpb)
    folded = mod.maybe_manifestize(store.save, _chunks(mpb, n, size), batch)
    if twice:
        folded = mod.maybe_manifestize(store.save, folded, batch)
    resolved = mod.resolve_chunk_manifest(store.fetch, folded)
    return ([c.SerializeToString(deterministic=True) for c in folded],
            store.blobs,
            sorted(c.SerializeToString(deterministic=True) for c in resolved))


@pytest.mark.parametrize("n,size,batch,twice", [
    (10, 100, 4, False),  # 2 manifests of 4 and a plain tail of 2
    (3, 100, 4, False),   # short: passes through
    (16, 10, 4, True),    # a manifest of manifests
    (1000, 4096, 1000, False),
])
def test_manifestize_and_resolve_are_the_references(n, size, batch, twice):
    got, want = _fold("port", n, size, batch, twice), _fold(
        "ref", n, size, batch, twice)
    assert got[0] == want[0]
    assert {k: gzip.decompress(v) for k, v in got[1].items()} == \
        {k: gzip.decompress(v) for k, v in want[1].items()}
    assert got[2] == want[2] == sorted(
        c.SerializeToString(deterministic=True) for c in _chunks(pb, n, size))
    if (n, twice) == (10, False):
        folded = [pb.FileChunk.FromString(b) for b in got[0]]
        manifests = [c for c in folded if c.is_chunk_manifest]
        assert len(manifests) == 2 and manifests[0].size == 400
        assert filechunks.total_size(folded) == 1000


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_manifest_blobs_resolve_across_packages(direction):
    writer, reader = direction.split("_to_")
    wmod, wpb = SIDES[writer]
    rmod, rpb = SIDES[reader]
    store = BlobStore(wpb)
    folded = wmod.maybe_manifestize(store.save, _chunks(wpb, 12, 50), 4)
    as_reader = [rpb.FileChunk.FromString(c.SerializeToString())
                 for c in folded]
    resolved = rmod.resolve_chunk_manifest(store.fetch, as_reader)
    assert sorted(c.SerializeToString(deterministic=True)
                  for c in resolved) == sorted(
        c.SerializeToString(deterministic=True) for c in _chunks(rpb, 12, 50))


@pytest.mark.parametrize("side", ["port", "ref"])
def test_manifest_cycle_detected(side):
    """A manifest naming itself, made by either package, is refused by
    the port."""
    _mod, mpb = SIDES[side]
    m = mpb.FileChunkManifest()
    mc = mpb.FileChunk(file_id="loop,1", offset=0, size=10,
                       is_chunk_manifest=True)
    m.chunks.append(mc)
    blob = gzip.compress(m.SerializeToString())
    with pytest.raises(IOError):
        fcm.resolve_chunk_manifest(
            lambda fid: blob,
            [pb.FileChunk.FromString(mc.SerializeToString())])


# -- a live port filer with a tiny manifest batch -----------------------------


@pytest.fixture(scope="module")
def manifest_cluster(tmp_path_factory):
    from seaweedfs_tpu_torch.filer.server import FilerServer
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.volume.server import VolumeServer

    master = MasterServer(ip="127.0.0.1", port=free_port(),
                          volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer(
        directories=[str(tmp_path_factory.mktemp("manvol"))],
        master_addresses=[f"127.0.0.1:{master.grpc_port}"],
        ip="127.0.0.1", port=free_port(), pulse_seconds=0.5,
        codec_name="cpu")
    vs.start()
    deadline = time.time() + 15
    while time.time() < deadline and len(master.topo.nodes) < 1:
        time.sleep(0.1)
    filer = FilerServer(
        masters=[f"127.0.0.1:{master.grpc_port}"],
        ip="127.0.0.1", port=free_port(), store="memory", max_mb=1)
    filer.manifest_batch = 4  # tiny: a 6MB file manifestizes
    filer.start()
    yield master, vs, filer
    filer.stop()
    vs.stop()
    master.stop()


def _http(method, url, data=None, headers=None):
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


PAYLOAD = bytes(range(256)) * 24576  # 6MB -> 6 chunks > batch of 4


def test_filer_manifestizes_large_files(manifest_cluster):
    _, _, filer = manifest_cluster
    base = f"http://127.0.0.1:{filer.port}"
    assert _http("PUT", f"{base}/big/manifested.bin", PAYLOAD)[0] == 201
    entry = filer.filer.find_entry("/big/manifested.bin")
    assert [c for c in entry.chunks if c.is_chunk_manifest]
    assert len(entry.chunks) < 6
    code, got = _http("GET", f"{base}/big/manifested.bin")
    assert code == 200 and got == PAYLOAD
    code, got = _http("GET", f"{base}/big/manifested.bin",
                      headers={"Range": "bytes=4194204-4194404"})
    assert code == 206 and got == PAYLOAD[4194204:4194405]


def test_chunk_cache_hits_counted(manifest_cluster):
    from seaweedfs_tpu_torch.stats.metrics import CHUNK_CACHE_COUNTER

    _, _, filer = manifest_cluster
    base = f"http://127.0.0.1:{filer.port}"
    _http("PUT", f"{base}/c/cached.bin", b"cachable" * 1000)
    _http("GET", f"{base}/c/cached.bin")
    h0 = CHUNK_CACHE_COUNTER.labels("hit").value
    assert _http("GET", f"{base}/c/cached.bin") == (200, b"cachable" * 1000)
    assert CHUNK_CACHE_COUNTER.labels("hit").value > h0


def test_manifest_gc_preserves_inner_chunks(manifest_cluster):
    _, _, filer = manifest_cluster
    base = f"http://127.0.0.1:{filer.port}"
    _http("PUT", f"{base}/gc/f.bin", PAYLOAD)
    assert _http("GET", f"{base}/gc/f.bin") == (200, PAYLOAD)
    payload2 = bytes(reversed(range(256))) * 24576
    _http("PUT", f"{base}/gc/f.bin", payload2)
    filer.filer.drain_deletions()
    assert _http("GET", f"{base}/gc/f.bin") == (200, payload2)
    code, _ = _http("DELETE", f"{base}/gc/f.bin")
    assert code in (200, 202, 204)
    assert filer.filer.find_entry("/gc/f.bin") is None
