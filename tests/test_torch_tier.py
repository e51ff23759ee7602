"""The port's remote tier held against the reference's, tests/test_tier.py
case for case: the BackendStorageFile seam, remote-tier volume round trips
(a directory tier and the S3 stub of tests/helpers.py), and the S3 tier
into the JAX package's own gateway (`tier_cluster`), which here runs with
an identities config, so the reference's IAM verifies every SigV4
signature the port's backend makes.

Beyond the mirrors: the port's signing equals the reference's on seeded
inputs and on the AWS example vector; a `.vif` and object tiered by one
package's Volume open and read equal in the other's; the lifecycle
controller's tier stage after a `keep_source` encode, and its "already
remote" resume; and a remote `.dat` refused by sendfile, vacuum and the
scrubber.  Volumes are written with the reference's writer
(`helpers.make_volume`) and opened by the port's Volume.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from helpers import free_port, make_volume, start_s3_stub

from seaweedfs_tpu.s3api import auth as ref_auth
from seaweedfs_tpu.storage.backend_s3 import make_s3_backend as ref_make_s3
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu_torch.s3api import auth as port_auth
from seaweedfs_tpu_torch.storage import backend as port_backend
from seaweedfs_tpu_torch.storage.backend import (
    BackendStorage,
    DiskFile,
    RemoteBackendFile,
    register_backend,
)
from seaweedfs_tpu_torch.storage.backend_s3 import S3Backend, make_s3_backend
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from torch_threads import one_torch_thread  # noqa: F401

ACCESS_KEY, SECRET_KEY = "AKTIER", "SKTIER"


class DirBackend(BackendStorage):
    """Test tier: objects are files under a directory."""

    def __init__(self, backend_id, directory):
        super().__init__("dir", backend_id)
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.range_reads = 0

    def _p(self, key):
        return os.path.join(self.directory, key.replace("/", "_"))

    def upload_file(self, local_path, key, progress=None):
        shutil.copyfile(local_path, self._p(key))
        size = os.path.getsize(local_path)
        if progress:
            progress(size)
        return size

    def download_file(self, key, local_path, progress=None):
        shutil.copyfile(self._p(key), local_path)
        return os.path.getsize(local_path)

    def delete_file(self, key):
        if os.path.exists(self._p(key)):
            os.remove(self._p(key))

    def read_range(self, key, offset, size):
        self.range_reads += 1
        with open(self._p(key), "rb") as f:
            f.seek(offset)
            return f.read(size)


def _port_volume(directory, volume_id: int, n_needles: int, seed: int = 0,
                 max_size: int = 2000) -> tuple[Volume, dict]:
    """A volume written by the reference's writer, opened by the port's
    Volume; -> (volume, {key: data})."""
    ref = make_volume(str(directory), volume_id=volume_id,
                      n_needles=n_needles, seed=seed, max_size=max_size)
    want = {i: ref.read_needle(i).data for i in range(1, n_needles + 1)}
    ref.close()
    return Volume(str(directory), "", volume_id), want


@pytest.fixture
def s3_stub():
    stub, handler = start_s3_stub()
    yield f"http://127.0.0.1:{stub.server_address[1]}", handler
    stub.shutdown()
    stub.server_close()


# -- seam unit tests --------------------------------------------------------


def test_disk_file(tmp_path):
    f = DiskFile(str(tmp_path / "x.dat"))
    assert f.file_size() == 0
    off = f.append(b"hello")
    assert off == 0
    f.write_at(5, b" world")
    assert f.read_at(0, 11) == b"hello world"
    f.truncate(5)
    assert f.file_size() == 5
    f.sync()
    f.close()


def test_remote_backend_file_block_cache(tmp_path):
    b = DirBackend("t", str(tmp_path / "store"))
    blob = os.urandom((2 << 20) + 777)
    src = tmp_path / "src.bin"
    src.write_bytes(blob)
    b.upload_file(str(src), "obj")
    rf = RemoteBackendFile(b, "obj", len(blob))
    # cross-block read
    lo = (1 << 20) - 100
    assert rf.read_at(lo, 300) == blob[lo:lo + 300]
    n = b.range_reads
    # same blocks again: served from cache
    assert rf.read_at(lo, 300) == blob[lo:lo + 300]
    assert b.range_reads == n
    # tail clamp + write rejection
    assert rf.read_at(len(blob) - 10, 100) == blob[-10:]
    with pytest.raises(PermissionError):
        rf.write_at(0, b"x")


# -- volume tier round-trip -------------------------------------------------


def test_volume_tier_roundtrip(tmp_path):
    register_backend(DirBackend("default", str(tmp_path / "tier")))
    vol, want = _port_volume(tmp_path, 7, 30)
    size = vol.tier_to_remote("dir.default")
    assert size > 0
    assert vol.is_remote and vol.read_only
    assert not os.path.exists(vol.file_name() + ".dat")
    # reads flow through ranged requests on the remote object
    for i in (1, 15, 30):
        assert vol.read_needle(i).data == want[i]
    with pytest.raises(PermissionError):
        vol.append_needle(Needle(id=99, cookie=1, data=b"net new"))
    vol.close()

    # restart: a fresh Volume object finds the tier placement in the .vif
    vol2 = Volume(str(tmp_path), "", 7)
    assert vol2.is_remote
    for i in (2, 29):
        assert vol2.read_needle(i).data == want[i]
    # download back: writable again, remote object gone
    got = vol2.tier_to_local()
    assert got == size
    assert not vol2.is_remote and not vol2.read_only
    vol2.append_needle(Needle(id=99, cookie=1, data=b"net new"))
    assert vol2.read_needle(99).data == b"net new"
    assert not os.listdir(str(tmp_path / "tier"))
    vol2.close()


def test_volume_tier_keep_local(tmp_path):
    register_backend(DirBackend("keep", str(tmp_path / "tier")))
    vol, _want = _port_volume(tmp_path, 8, 5)
    vol.tier_to_remote("dir.keep", keep_local=True)
    assert os.path.exists(vol.file_name() + ".dat")
    assert vol.read_needle(3).id == 3
    vol.close()


def test_volume_tier_roundtrip_s3_stub(tmp_path, s3_stub):
    """Volume.tier_to_remote/tier_to_local against the S3 backend stub:
    PUT, ranged GET and DELETE over HTTP, the surface the lifecycle
    controller's tier jobs drive."""
    endpoint, handler = s3_stub
    make_s3_backend("stubrt", {"endpoint": endpoint, "bucket": "tier-rt"})
    vol, want = _port_volume(tmp_path, 17, 30)
    size = vol.tier_to_remote("s3.stubrt")
    # keep_local defaults False: the local .dat is gone, the bytes live
    # in the bucket
    assert not os.path.exists(vol.file_name() + ".dat")
    assert len(handler.objects["/tier-rt/17.dat"]) == size
    before = handler.range_reads
    for i in (1, 15, 30):
        assert vol.read_needle(i).data == want[i]
    assert handler.range_reads > before
    vol.close()

    # a fresh load finds the remote placement via the .vif and the
    # download brings it back local + deletes the remote object
    vol2 = Volume(str(tmp_path), "", 17)
    assert vol2.is_remote
    assert vol2.tier_to_local() == size
    assert "/tier-rt/17.dat" not in handler.objects
    assert not vol2.is_remote and not vol2.read_only
    for i in (2, 29):
        assert vol2.read_needle(i).data == want[i]
    vol2.close()


def test_volume_tier_s3_stub_keep_local(tmp_path, s3_stub):
    endpoint, handler = s3_stub
    make_s3_backend("stubkeep", {"endpoint": endpoint,
                                 "bucket": "tier-keep"})
    vol, want = _port_volume(tmp_path, 18, 5)
    vol.tier_to_remote("s3.stubkeep", keep_local=True)
    assert os.path.exists(vol.file_name() + ".dat")
    assert "/tier-keep/18.dat" in handler.objects
    assert vol.read_needle(3).data == want[3]
    vol.close()


def test_unconfigured_backend_fails_loud(tmp_path):
    backend = DirBackend("gone", str(tmp_path / "tier"))
    register_backend(backend)
    vol, _want = _port_volume(tmp_path, 9, 3)
    vol.tier_to_remote("dir.gone")
    vol.close()
    del port_backend._BACKENDS["dir.gone"]
    with pytest.raises(IOError, match="unconfigured backend dir.gone"):
        Volume(str(tmp_path), "", 9)
    register_backend(backend)  # restore for other tests
    # and a move to a backend nobody registered leaves the volume local
    (tmp_path / "b").mkdir()
    vol, want = _port_volume(tmp_path / "b", 10, 3)
    with pytest.raises(IOError, match="not configured"):
        vol.tier_to_remote("dir.nobody")
    assert not vol.is_remote and os.path.exists(vol.file_name() + ".dat")
    assert vol.read_needle(2).data == want[2]
    vol.close()


# -- SigV4: the port's signing against the reference's ----------------------


def test_sigv4_aws_documented_vector():
    """The AWS General Reference worked example (get-vanilla, iam), the
    vector tests/test_s3.py pins the reference with."""
    headers = {
        "content-type": "application/x-www-form-urlencoded; charset=utf-8",
        "host": "iam.amazonaws.com",
        "x-amz-date": "20150830T123600Z",
    }
    args = ("GET", "/", "Action=ListUsers&Version=2010-05-08", headers,
            ["content-type", "host", "x-amz-date"],
            hashlib.sha256(b"").hexdigest())
    canon = port_auth.canonical_request(*args)
    assert canon == ref_auth.canonical_request(*args)
    assert hashlib.sha256(canon.encode()).hexdigest() == (
        "f536975d06c0309214f805bb90ccff089219ecd68b2577efef23edd43b7e1a59")
    sig_args = ("wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", "20150830",
                "us-east-1", "iam", "20150830T123600Z", canon)
    assert port_auth.sign_v4(*sig_args) == ref_auth.sign_v4(*sig_args) == (
        "5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b5924a6f2b5d7")


@pytest.mark.parametrize("seed", range(6))
def test_sigv4_matches_reference_on_seeded_requests(seed):
    """Seeded methods, keys with characters SigV4 encodes, unsorted and
    repeated query parameters, multipart part queries, ragged header
    whitespace: every primitive gives the reference's bytes."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcXYZ019-._~ /%+=&?é")
    key = "".join(rng.choice(alphabet, int(rng.integers(1, 24))))
    query = "&".join(
        f"{rng.choice(['uploadId', 'partNumber', 'uploads', 'x-id', 'a b'])}"
        f"={int(rng.integers(0, 10000))}"
        for _ in range(int(rng.integers(0, 4))))
    headers = {"host": f"127.0.0.1:{int(rng.integers(1, 65535))}",
               "x-amz-date": "20261018T093000Z",
               "x-amz-content-sha256": hashlib.sha256(
                   rng.bytes(int(rng.integers(0, 64)))).hexdigest(),
               "x-amz-meta-tag": "  two   spaces  "}
    signed = sorted(headers)
    method = str(rng.choice(["GET", "PUT", "POST", "DELETE"]))
    raw_path = "/bucket/" + urllib.request.quote(key)
    assert port_auth._uri_encode(key) == ref_auth._uri_encode(key)
    assert port_auth._uri_encode(key, False) == ref_auth._uri_encode(
        key, False)
    assert port_auth.canonical_query(query) == ref_auth.canonical_query(
        query)
    args = (method, raw_path, query, headers, signed,
            headers["x-amz-content-sha256"])
    canon = port_auth.canonical_request(*args)
    assert canon == ref_auth.canonical_request(*args)
    scope = "20261018/us-east-1/s3/aws4_request"
    assert port_auth.string_to_sign("20261018T093000Z", scope, canon) \
        == ref_auth.string_to_sign("20261018T093000Z", scope, canon)
    secret = rng.bytes(20).hex()
    assert port_auth.signing_key(secret, "20261018", "us-east-1", "s3") \
        == ref_auth.signing_key(secret, "20261018", "us-east-1", "s3")
    sig_args = (secret, "20261018", "us-east-1", "s3", "20261018T093000Z",
                canon)
    assert port_auth.sign_v4(*sig_args) == ref_auth.sign_v4(*sig_args)


# -- a .vif written by either package opens in the other --------------------


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_tiered_vif_opens_in_the_other_package(tmp_path, s3_stub, writer):
    """Both registries name one stub bucket `s3.cross`; the volume tiered
    by `writer`'s Volume reopens in the other package's Volume from the
    .vif alone, every needle equal, and downloads back there."""
    endpoint, handler = s3_stub
    conf = {"endpoint": endpoint, "bucket": "cross"}
    ref_make_s3("cross", conf)
    make_s3_backend("cross", conf)
    ref = make_volume(str(tmp_path), volume_id=21, n_needles=40, seed=7)
    want = {i: ref.read_needle(i).data for i in range(1, 41)}
    dat = open(ref.file_name() + ".dat", "rb").read()
    ref.close()
    Writer, Reader = ((RefVolume, Volume) if writer == "ref"
                      else (Volume, RefVolume))
    w = Writer(str(tmp_path), "", 21)
    assert w.tier_to_remote("s3.cross") == len(dat)
    w.close()
    assert handler.objects["/cross/21.dat"] == dat
    vif = json.loads((tmp_path / "21.vif").read_text())
    assert vif["files"][0]["key"] == "21.dat"
    assert vif["files"][0]["backendType"] == "s3"
    r = Reader(str(tmp_path), "", 21)
    assert r.is_remote
    for i in range(1, 41):
        assert r.read_needle(i).data == want[i]
    assert r.tier_to_local() == len(dat)
    assert open(tmp_path / "21.dat", "rb").read() == dat
    r.close()


# -- the remote .dat never reaches the fast paths ---------------------------


@pytest.mark.parametrize("path", ["sendfile", "vacuum", "scrub"])
def test_remote_dat_is_refused_by_fast_paths(tmp_path, s3_stub, path):
    """A tiered volume in a port Store: the sendfile extent path answers
    "remote" (Volume.needle_extent None), compaction raises naming the
    remote tier, and the scrubber's pass skips it without one ranged
    GET; GETs through the store still read the remote bytes."""
    from seaweedfs_tpu_torch.storage.scrub import Scrubber
    from seaweedfs_tpu_torch.storage.store import Store

    endpoint, handler = s3_stub
    make_s3_backend("fast", {"endpoint": endpoint, "bucket": "fast"})
    make_volume(str(tmp_path), volume_id=23, n_needles=12, seed=4).close()
    store = Store([str(tmp_path)], needle_cache_mb=0, codec_name="cpu")
    try:
        v = store.find_volume(23)
        want = v.read_needle(5).data
        v.tier_to_remote("s3.fast")
        reads = handler.range_reads
        if path == "sendfile":
            assert v.needle_extent(5) is None
            assert store.needle_extent(23, 5) == (None, "remote")
        elif path == "vacuum":
            with pytest.raises(ValueError, match="remote-tiered"):
                store.compact_volume(23)
        else:
            summary = Scrubber(store, rate_mbps=0).scrub_once()
            assert summary["volumes"] == 0 and summary["scanned_bytes"] == 0
        assert handler.range_reads == reads
        assert store.read_needle(23, 5).data == want
        assert v.is_remote
    finally:
        store.close()


# -- S3 tier against the JAX package's own gateway --------------------------


@pytest.fixture(scope="module")
def tier_cluster(tmp_path_factory):
    """The reference's master, two volume servers, filer and S3 gateway;
    the gateway verifies SigV4 for one identity (ACCESS_KEY)."""
    from seaweedfs_tpu.filer.server import FilerServer
    from seaweedfs_tpu.master.server import MasterServer
    from seaweedfs_tpu.s3api.server import S3ApiServer
    from seaweedfs_tpu.volume.server import VolumeServer

    conf = tmp_path_factory.mktemp("s3conf") / "s3.json"
    conf.write_text(json.dumps({"identities": [{
        "name": "tier", "actions": ["Admin"],
        "credentials": [{"accessKey": ACCESS_KEY,
                         "secretKey": SECRET_KEY}]}]}))
    master = MasterServer(ip="127.0.0.1", port=free_port(),
                          volume_size_limit_mb=64)
    master.start()
    vols = []
    for i in range(2):
        vs = VolumeServer(
            directories=[str(tmp_path_factory.mktemp(f"tvol{i}"))],
            master_addresses=[f"127.0.0.1:{master.grpc_port}"],
            ip="127.0.0.1", port=free_port(), pulse_seconds=0.5)
        vs.start()
        vols.append(vs)
    deadline = time.time() + 15
    while time.time() < deadline and len(master.topo.nodes) < 2:
        time.sleep(0.1)
    filer = FilerServer(masters=[f"127.0.0.1:{master.grpc_port}"],
                        ip="127.0.0.1", port=free_port(), store="memory")
    filer.start()
    s3 = S3ApiServer(filer=f"127.0.0.1:{filer.port}", port=free_port(),
                     config_path=str(conf))
    s3.start()
    yield master, vols, filer, s3
    s3.stop()
    filer.stop()
    for v in vols:
        v.stop()
    master.stop()


def _gateway_backend(s3, backend_id: str, bucket: str,
                     secret: str = SECRET_KEY) -> S3Backend:
    """The port's signed backend on the gateway, the bucket made by a
    signed PUT of the port's own."""
    b = S3Backend(backend_id, f"http://127.0.0.1:{s3.port}", bucket,
                  access_key=ACCESS_KEY, secret_key=secret)
    if secret == SECRET_KEY:
        with b._request("PUT", ""):
            pass
    return b


def test_s3_backend_tier_dogfood(tier_cluster, tmp_path):
    """A port volume's .dat tiers into a bucket of the reference's
    gateway; needle reads keep working through signed ranged GETs, and an
    unsigned read of the object is refused."""
    _, _, _, s3 = tier_cluster
    register_backend(_gateway_backend(s3, "dogfood", "tier-bucket"))
    vol, want = _port_volume(tmp_path, 42, 20, seed=5)
    dat = open(tmp_path / "42.dat", "rb").read()
    size = vol.tier_to_remote("s3.dogfood")
    assert size > 0 and vol.is_remote
    for i in (1, 10, 20):
        assert vol.read_needle(i).data == want[i]
    # the bytes really live in the bucket (gateway -> filer -> chunks)
    b = S3Backend("check", f"http://127.0.0.1:{s3.port}", "tier-bucket",
                  access_key=ACCESS_KEY, secret_key=SECRET_KEY)
    assert size == len(dat) and b.read_range("42.dat", 0, size) == dat
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(
            f"http://127.0.0.1:{s3.port}/tier-bucket/42.dat", timeout=10)
    assert e.value.code == 403
    got = vol.tier_to_local()
    assert got == size and not vol.is_remote
    assert vol.read_needle(7).data == want[7]
    vol.close()


def test_s3_backend_wrong_secret_is_refused(tier_cluster, tmp_path):
    """The gateway's IAM rejects a signature made with another secret:
    an upload fails with 403 and leaves the volume local."""
    _, _, _, s3 = tier_cluster
    _gateway_backend(s3, "badmk", "bad-bucket")
    register_backend(_gateway_backend(s3, "bad", "bad-bucket",
                                      secret="not-the-secret"))
    vol, want = _port_volume(tmp_path, 43, 4)
    with pytest.raises(urllib.error.HTTPError) as e:
        vol.tier_to_remote("s3.bad")
    assert e.value.code == 403
    assert not vol.is_remote
    assert vol.read_needle(2).data == want[2]
    vol.close()


def test_s3_backend_multipart_upload(tier_cluster, tmp_path):
    """Files over the part size stream through the gateway's multipart
    API, each part signed with its own payload hash."""
    _, _, _, s3 = tier_cluster
    b = _gateway_backend(s3, "mp", "mp-bucket")
    blob = os.urandom(5 << 20)
    src = tmp_path / "big.bin"
    src.write_bytes(blob)
    parts = []
    assert b.upload_file(str(src), "big", progress=parts.append,
                         part_size=2 << 20) == len(blob)
    assert parts == [2 << 20, 4 << 20, 5 << 20]
    assert b.read_range("big", (3 << 20) - 50, 100) == blob[
        (3 << 20) - 50:(3 << 20) + 50]
    dst = tmp_path / "back.bin"
    assert b.download_file("big", str(dst)) == len(blob)
    assert dst.read_bytes() == blob
    b.delete_file("big")
    with pytest.raises(urllib.error.HTTPError):
        b.read_range("big", 0, 10)


def test_tier_grpc_and_shell(tier_cluster, tmp_path):
    """volume.tier.upload / volume.tier.download through the port's shell
    against a port master and volume server (`-tierBackends` as the
    server's `tier_backends`), the reference's gateway as the tier."""
    import grpc

    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
    from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
    from seaweedfs_tpu_torch.shell.volume_commands import _locate_volume
    from seaweedfs_tpu_torch.volume.server import VolumeServer

    _, _, _, s3 = tier_cluster
    _gateway_backend(s3, "shellmk", "shell-tier")
    master = MasterServer(ip="127.0.0.1", port=free_port(),
                          volume_size_limit_mb=64)
    master.start()
    vsrv = VolumeServer(
        [str(tmp_path)], [f"127.0.0.1:{master.grpc_port}"],
        ip="127.0.0.1", port=free_port(), pulse_seconds=0.5,
        codec_name="cpu", tier_backends={"s3.shell": {
            "endpoint": f"http://127.0.0.1:{s3.port}",
            "bucket": "shell-tier", "access_key": ACCESS_KEY,
            "secret_key": SECRET_KEY}})
    vsrv.start()
    try:
        deadline = time.time() + 15
        while time.time() < deadline and not master.topo.nodes:
            time.sleep(0.1)
        data = b"tiered needle payload " * 100
        with urllib.request.urlopen(
                f"http://127.0.0.1:{master.port}/dir/assign",
                timeout=10) as r:
            a = json.loads(r.read())
        fid, url = a["fid"], a["url"]
        req = urllib.request.Request(f"http://{url}/{fid}", data=data,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=10):
            pass
        vid = int(fid.split(",")[0])
        env = CommandEnv(f"127.0.0.1:{master.grpc_port}")
        # the new volume reaches the topology via the next heartbeat delta
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                _locate_volume(env, vid)
                break
            except RuntimeError:
                time.sleep(0.2)
        out = run_command(env,
                          f"volume.tier.upload -volumeId={vid} -dest=s3.shell")
        assert "s3.shell" in out
        assert vsrv.store.find_volume(vid).is_remote
        # the needle still reads through the HTTP path (remote tier)
        with urllib.request.urlopen(f"http://{url}/{fid}", timeout=10) as r:
            assert r.read() == data
        # a second upload: FAILED_PRECONDITION "already remote"
        stub = rpc.volume_server_stub(f"127.0.0.1:{vsrv.grpc_port}",
                                      timeout=30)
        with pytest.raises(grpc.RpcError) as e:
            list(stub.VolumeTierMoveDatToRemote(
                vs_pb.VolumeTierMoveDatToRemoteRequest(
                    volume_id=vid, destination_backend_name="s3.shell")))
        assert e.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        assert "already remote" in e.value.details()
        out = run_command(env, f"volume.tier.download -volumeId={vid}")
        assert "downloaded" in out
        assert not vsrv.store.find_volume(vid).is_remote
        with urllib.request.urlopen(f"http://{url}/{fid}", timeout=10) as r:
            assert r.read() == data
        # a backend nobody registered fails the rpc, the volume stays local
        with pytest.raises(grpc.RpcError) as e:
            list(stub.VolumeTierMoveDatToRemote(
                vs_pb.VolumeTierMoveDatToRemoteRequest(
                    volume_id=vid, destination_backend_name="s3.nope")))
        assert e.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        assert "not configured" in e.value.details()
        assert not vsrv.store.find_volume(vid).is_remote
        with pytest.raises(grpc.RpcError) as e:
            list(stub.VolumeTierMoveDatFromRemote(
                vs_pb.VolumeTierMoveDatFromRemoteRequest(volume_id=999)))
        assert e.value.code() == grpc.StatusCode.NOT_FOUND
    finally:
        vsrv.stop()
        master.stop()


# -- the lifecycle controller's tier stage ----------------------------------


def test_controller_tiers_after_a_keep_source_encode(tmp_path, s3_stub):
    """A port master whose policy names a tier backend: its controller
    seals a full volume, EC-encodes it keeping the source (14 shards
    mounted, the .dat still there), then tiers the .dat into the stub;
    the volume reads from the remote tier.  A tier job resumed after its
    ack was lost succeeds as "already remote"."""
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.volume.server import VolumeServer

    endpoint, handler = s3_stub
    conf = {"endpoint": endpoint, "bucket": "cold"}
    dirs = [tmp_path / "a", tmp_path / "b"]
    for d in dirs:
        d.mkdir()
    ref = make_volume(str(dirs[0]), volume_id=5, n_needles=80, seed=9,
                      max_size=4000)
    want = {i: ref.read_needle(i).data for i in (1, 40, 80)}
    dat = open(ref.file_name() + ".dat", "rb").read()
    ref.close()
    master = MasterServer(
        ip="127.0.0.1", port=free_port(), volume_size_limit_mb=1,
        lifecycle_dir=str(tmp_path), lifecycle_policy={"*": {
            "seal_full_percent": 10.0, "ec_cooldown_seconds": 0,
            "tier_backend": "s3.ctl", "tier_idle_seconds": 0}})
    master.start()
    servers = [VolumeServer([str(d)], [f"127.0.0.1:{master.grpc_port}"],
                            ip="127.0.0.1", port=free_port(),
                            pulse_seconds=0.5, codec_name="cpu",
                            tier_backends={"s3.ctl": conf})
               for d in dirs]
    for s in servers:
        s.start()
    try:
        deadline = time.time() + 15
        while time.time() < deadline and len(master.topo.nodes) < 2:
            time.sleep(0.1)
        done: dict = {}
        deadline = time.time() + 60
        while time.time() < deadline and "5:tier" not in done:
            master.lifecycle.run_once()
            done = {j["key"]: j for j in
                    master.lifecycle.journal.jobs(("done",))}
            time.sleep(0.3)
        assert {"5:seal", "5:ec_encode", "5:tier"} <= set(done), done
        jobs = master.lifecycle.journal.jobs()
        assert [j for j in jobs if j["key"] == "5:ec_encode"][0][
            "keep_source"] is True
        assert done["5:tier"]["backend"] == "s3.ctl"
        assert handler.objects["/cold/5.dat"] == dat
        v = servers[0].store.find_volume(5)
        assert v is not None and v.is_remote
        assert not os.path.exists(dirs[0] / "5.dat")
        assert len(master.topo.lookup_ec_shards(5)) == 14
        for i, data in want.items():
            assert servers[0].store.read_needle(5, i).data == data
        # resumed after a crash that lost the ack: the move answers
        # "already remote" and the job ends done, not failed
        master.lifecycle.journal.update("5:tier", state="pending")
        res = master.lifecycle.run_pending(wait=True, keys={"5:tier"})
        assert [r["state"] for r in res] == ["done"]
        assert res[0]["detail"].startswith("already remote on ")
    finally:
        for s in servers:
            s.stop()
        master.lifecycle.stop()
        master.stop()
