"""The port's volume-server HTTP plane (seaweedfs_tpu_torch/volume/
http_handlers.py and the HTTP side of volume/server.py) against the
reference's, on the same requests.

Two clusters, one per package: a MiniMaster (chip_smoke.py, built from the
port's rpc declarations; it answers LookupVolume and LookupEcVolume from
the heartbeats) and volume servers A and B — the reference's on `cpu`,
the port's on `torch_cpu`.  A holds volume 3, an EC volume 7 written and
encoded by the reference, and volume 5 (replication 001) with B; B alone
holds volume 6.  Every request goes to both clusters, and the answers
must agree: status, body (JSON parsed where it is JSON, each cluster's
addresses replaced by a name) and the Etag, Content-Type,
Content-Length, Content-Range, Accept-Ranges and Location headers.

Covered: POSTs of seeded needles (raw, multipart with a name and a mime
type, gzip bodies), GETs on the sendfile path and with it off, Range and
suffix ranges, 416, HEAD, 404s, the 302 for a volume held elsewhere, 401
without a write JWT, 403 from the whitelist, 409 on a full disk, image
resizes, corrupt-needle 500s, GETs of the EC volume healthy and with
.ec00-.ec03 lost (the port decodes each lost interval on its codec),
/debug/canary/ec, DELETE of an EC needle (the .ecj files equal), a
replicated POST and DELETE fanned out to B with the client's JWT, and
/status, /metrics and /debug/traces.  A port server's stop() leaves no
HTTP thread behind.  Waits are on the master's condition or on a counter
under a deadline, never on a fixed sleep.
"""

from __future__ import annotations

import gzip
import http.client
import io
import json
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest

from helpers import free_port
from seaweedfs_tpu.security import Guard as RefGuard
from seaweedfs_tpu.volume.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs
from seaweedfs_tpu_torch.security import Guard, gen_write_jwt
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.volume.server import VolumeServer
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

VOL, EC, REPL, ELSEWHERE = 3, 7, 5, 6
EC_LOST = [0, 1, 2, 3]
NAMED = ("Etag", "Content-Type", "Content-Length", "Content-Range",
         "Accept-Ranges", "Location")


def _seeded(rng, lo: int, hi: int) -> bytes:
    return rng.integers(0, 256, int(rng.integers(lo, hi))).astype(
        np.uint8).tobytes()


def _write_ec_source(directory: str) -> dict:
    """Volume EC (6 MiB of needles up to 200 KiB, so that needles lie in
    shards 0-5) written by the reference's Volume and encoded by the
    reference; -> {key: (cookie, payload)}."""
    from seaweedfs_tpu.storage import Needle, SuperBlock
    from seaweedfs_tpu.storage.ec.encoder import (
        generate_ec_files, write_sorted_file_from_idx)
    from seaweedfs_tpu.storage.needle import FLAG_HAS_MIME, FLAG_HAS_NAME
    from seaweedfs_tpu.storage.volume import Volume

    rng = np.random.default_rng(77)
    vol = Volume(directory, "", EC, super_block=SuperBlock())
    out, total, key = {}, 0, 0
    while total < 6 << 20:
        key += 1
        payload = _seeded(rng, 1, 200 << 10)
        n = Needle(cookie=int(rng.integers(0, 2**32)), id=key, data=payload)
        if key % 3 == 0:
            n.set(FLAG_HAS_NAME)
            n.name = f"ec-{key}.bin".encode()
        if key % 4 == 0:
            n.set(FLAG_HAS_MIME)
            n.mime = b"text/plain"
        vol.append_needle(n)
        out[key] = (n.cookie, payload)
        total += len(payload)
    vol.close()
    base = os.path.join(directory, str(EC))
    generate_ec_files(base, codec_name="cpu")
    write_sorted_file_from_idx(base)
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    return out


class _Cluster:
    """MiniMaster + volume servers A and B of one package."""

    def __init__(self, kind: str, root, ec_src: str):
        self.kind = kind
        self.master = chip_smoke.MiniMaster(rpc, master_pb2,
                                            free_port() + 10000)
        self.dirs = [str(root / kind / "a"), str(root / kind / "b")]
        for d in self.dirs:
            os.makedirs(d)
        for name in os.listdir(ec_src):
            shutil.copy(os.path.join(ec_src, name), self.dirs[0])
        self.servers = []
        try:
            for i, d in enumerate(self.dirs):
                kw = dict(ip="127.0.0.1", port=free_port(), pulse_seconds=1.0,
                          metrics_port=free_port() if i == 0 else 0,
                          jwt_signing_key=b"", whitelist=None)
                if kind == "reference":
                    srv = RefVolumeServer([d], [self.master.address], **kw)
                else:
                    srv = VolumeServer([d], [self.master.address],
                                       codec_name="torch_cpu", **kw)
                srv.start()
                self.servers.append(srv)
            a, b = self.stub(0), self.stub(1)
            a.AllocateVolume(vs.AllocateVolumeRequest(volume_id=VOL))
            for stub in (a, b):
                stub.AllocateVolume(vs.AllocateVolumeRequest(
                    volume_id=REPL, replication="001"))
            b.AllocateVolume(vs.AllocateVolumeRequest(volume_id=ELSEWHERE))
            self.master.wait_for(
                lambda m: m.holds(self.url(0), REPL)
                and m.holds(self.url(1), REPL)
                and m.holds(self.url(1), ELSEWHERE)
                and m.bits(self.url(0), EC) == 0x3FFF,
                "the volumes of A and B")
        except BaseException:
            self.stop()
            raise

    def url(self, i: int) -> str:
        return f"127.0.0.1:{self.servers[i].port}"

    def stub(self, i: int):
        return rpc.volume_server_stub(
            f"127.0.0.1:{self.servers[i].grpc_port}", timeout=60)

    def request(self, method: str, path: str, body: bytes | None = None,
                headers: dict | None = None, server: int = 0,
                port: int | None = None):
        conn = http.client.HTTPConnection(
            "127.0.0.1", port or self.servers[server].port, timeout=60)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            return r.status, dict(r.getheaders()), r.read()
        finally:
            conn.close()

    def normalize(self, resp) -> tuple:
        status, headers, body = resp
        names = {self.url(0): "<A>", self.url(1): "<B>"}
        named = {}
        for k in NAMED:
            v = headers.get(k)
            for url, name in names.items():
                v = v.replace(url, name) if v else v
            named[k] = v
        for url, name in names.items():
            body = body.replace(url.encode(), name.encode())
        if headers.get("Content-Type") == "application/json" and body:
            body = json.loads(body)
        return status, named, body

    def stop(self) -> None:
        for srv in self.servers:
            srv.stop()
        self.master.stop()


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    root = tmp_path_factory.mktemp("http_plane")
    ec_src = str(root / "ec_src")
    os.makedirs(ec_src)
    ec_needles = _write_ec_source(ec_src)
    clusters = {}
    try:
        for kind in ("reference", "port"):
            clusters[kind] = _Cluster(kind, root, ec_src)
        yield clusters, ec_needles
    finally:
        for c in clusters.values():
            c.stop()


def _both(clusters, method, path, body=None, headers=None, server=0):
    """Send one request to both clusters; -> the port's normalized answer
    after asserting it equals the reference's."""
    got = {kind: c.normalize(c.request(method, path, body, headers, server))
           for kind, c in clusters.items()}
    assert got["port"] == got["reference"], (method, path)
    return got["port"]


def _fid(vid: int, key: int, cookie: int) -> str:
    return f"{vid},{key:x}{cookie:08x}"


def _multipart(payload: bytes, name: str = "", mime: str = "") -> tuple:
    disp = 'form-data; name="file"'
    if name:
        disp += f'; filename="{name}"'
    head = f"--bb\r\nContent-Disposition: {disp}\r\n"
    if mime:
        head += f"Content-Type: {mime}\r\n"
    body = head.encode() + b"\r\n" + payload + b"\r\n--bb--\r\n"
    return body, {"Content-Type": "multipart/form-data; boundary=bb"}


def _post_seeded(clusters, vid: int, seed: int, n: int) -> dict:
    """n seeded needles POSTed to both clusters' A in four shapes: raw,
    multipart with a name, multipart with a name and mime type, gzip body.
    -> {fid: stored payload}."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        key = 1000 * seed + i + 1
        fid = _fid(vid, key, int(rng.integers(0, 2**32)))
        payload = _seeded(rng, 1, 64 << 10)
        shape = i % 4
        headers = {}
        if shape == 0:
            body = payload
        elif shape == 1:
            body, headers = _multipart(payload, name=f"n{i}.bin")
        elif shape == 2:
            body, headers = _multipart(payload, name=f"n{i}.txt",
                                       mime="text/plain")
        else:
            payload = body = gzip.compress(payload, mtime=0)
            headers = {"Content-Encoding": "gzip",
                       "Content-Type": "application/octet-stream"}
        status, _h, answer = _both(clusters, "POST", "/" + fid, body,
                                   headers)
        assert status == 201 and answer["size"] >= len(payload)
        out[fid] = payload
    return out


def _until(cond, what: str, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"never saw {what}"
        time.sleep(0.01)


def test_post_then_get_on_the_sendfile_path_and_off(planes, monkeypatch):
    clusters, _ = planes
    stored = _post_seeded(clusters, VOL, seed=1, n=24)
    sent = metrics.SENDFILE_BYTES.labels()
    before = sent.value
    for fid, payload in stored.items():
        status, headers, body = _both(clusters, "GET", "/" + fid)
        assert status == 200 and body == payload
        assert headers["Accept-Ranges"] == "bytes" and headers["Etag"]
    want = before + sum(len(p) for p in stored.values())
    # the counter ticks on the server thread after the last byte went out
    _until(lambda: sent.value >= want, "the port's sendfile bytes")
    assert sent.value == want
    monkeypatch.setenv("SEAWEEDFS_TPU_SENDFILE", "0")
    off = metrics.SENDFILE_FALLBACK.labels("disabled")
    before = off.value
    for fid, payload in stored.items():
        status, _h, body = _both(clusters, "GET", "/" + fid)
        assert status == 200 and body == payload
    assert off.value - before == len(stored)


def test_ranges_and_head(planes):
    clusters, _ = planes
    stored = _post_seeded(clusters, VOL, seed=2, n=8)
    for fid, payload in stored.items():
        n = len(payload)
        for rng in ("bytes=0-99", "bytes=100-", "bytes=-50",
                    f"bytes=0-{n + 1000}", f"bytes={n - 1}-{n - 1}",
                    f"bytes={n + 5}-{n + 9}", "bytes=9-3", "bytes=x-y",
                    "items=0-1"):
            status, headers, body = _both(clusters, "GET", "/" + fid,
                                          headers={"Range": rng})
            assert status in (200, 206, 416), rng
            if status == 206:
                assert headers["Content-Range"].startswith("bytes ")
        for rng in (None, "bytes=0-9", "bytes=-5", "bytes=bad"):
            status, headers, body = _both(
                clusters, "HEAD", "/" + fid,
                headers={"Range": rng} if rng else {})
            assert body == b""
        assert int(_both(clusters, "HEAD", "/" + fid)[1][
            "Content-Length"]) == n


def test_not_found_paths_and_redirect(planes):
    clusters, _ = planes
    (fid, payload), = _post_seeded(clusters, VOL, seed=3, n=1).items()
    vid, rest = fid.split(",")
    bad_cookie = f"{vid},{rest[:-8]}{int(rest[-8:], 16) ^ 0xFF:08x}"
    missing = f"{vid},{int(rest[:-8], 16) + 77:x}{rest[-8:]}"
    for path, want in (("/" + bad_cookie, 404), ("/" + missing, 404),
                       ("/nonsense", 404), ("/99,0101020304", 404),
                       (f"/{ELSEWHERE},0102030405", 302)):
        for method in ("GET", "HEAD"):
            status, headers, _ = _both(clusters, method, path)
            assert status == want, (method, path)
    assert headers["Location"] == f"http://<B>/{ELSEWHERE},0102030405"
    for path in ("/nonsense", "/" + missing):
        assert _both(clusters, "DELETE", path)[0] in (400, 404)
    assert _both(clusters, "POST", "/nonsense", b"x")[0] == 400


def test_write_jwt_and_whitelist(planes):
    clusters, _ = planes
    key = b"cluster-signing-key"
    fid = _fid(VOL, 4001, 0x1234)
    try:
        for c in clusters.values():
            c.servers[0].jwt_signing_key = key
        assert _both(clusters, "POST", "/" + fid, b"no token")[0] == 401
        other = {"Authorization": "Bearer " + gen_write_jwt(key, "3,99")}
        assert _both(clusters, "POST", "/" + fid, b"wrong fid",
                     other)[0] == 401
        # a token the port made, accepted by both packages' servers
        good = {"Authorization": "Bearer " + gen_write_jwt(key, fid)}
        assert _both(clusters, "POST", "/" + fid, b"signed", good)[0] == 201
        assert _both(clusters, "DELETE", "/" + fid)[0] == 401
        assert _both(clusters, "DELETE", "/" + fid, headers=good)[0] == 202
    finally:
        for c in clusters.values():
            c.servers[0].jwt_signing_key = b""
    try:
        for c in clusters.values():
            srv = c.servers[0]
            srv.guard = (RefGuard if c.kind == "reference" else Guard)(
                ["10.0.0.0/8"])
        status, _h, body = _both(clusters, "GET", "/status")
        assert (status, body) == (403, {"error": "ip not in whitelist"})
    finally:
        for c in clusters.values():
            c.servers[0].guard = (RefGuard if c.kind == "reference"
                                  else Guard)(None)


def test_full_disk_answers_409(planes):
    from seaweedfs_tpu.storage.disk_health import DiskFullError as RefFull
    from seaweedfs_tpu_torch.storage.disk_health import DiskFullError

    clusters, _ = planes
    saved = {}
    for kind, c in clusters.items():
        err = RefFull if kind == "reference" else DiskFullError
        store = c.servers[0].store
        saved[kind] = store.write_needle

        def full(vid, n, _err=err):
            raise _err(28, "no space left on device")

        store.write_needle = full
    rejects = metrics.VOLUME_FULL_REJECT.labels()
    before = rejects.value
    try:
        status, _h, body = _both(clusters, "POST", "/" + _fid(VOL, 4100, 9),
                                 b"full")
    finally:
        for kind, c in clusters.items():
            c.servers[0].store.write_needle = saved[kind]
    assert status == 409 and body["volumeFull"] is True
    assert rejects.value == before + 1


def test_image_resize(planes):
    pil = pytest.importorskip("PIL.Image", reason="Pillow is not installed")
    clusters, _ = planes
    img = pil.new("RGB", (64, 48))
    img.putdata([(x * 4 % 256, y * 5 % 256, (x * y) % 256)
                 for y in range(48) for x in range(64)])
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    body, headers = _multipart(buf.getvalue(), name="pic.png",
                               mime="image/png")
    fid = _fid(VOL, 4200, 0xABCDEF)
    assert _both(clusters, "POST", "/" + fid, body, headers)[0] == 201
    for q in ("", "?width=16&height=12", "?width=10&height=10&mode=fit",
              "?width=10&height=10&mode=fill", "?width=abc"):
        status, headers, _ = _both(clusters, "GET", f"/{fid}{q}")
        assert status in (200, 400)
    assert _both(clusters, "GET", f"/{fid}?width=16&height=12")[
        1]["Content-Type"] == "image/png"


def test_corrupt_needle_answers_500(planes, monkeypatch):
    clusters, _ = planes
    (fid, payload), = _post_seeded(clusters, VOL, seed=5, n=1).items()
    key = int(fid.split(",")[1][:-8], 16)
    for c in clusters.values():
        v = c.servers[0].store.find_volume(VOL)
        ext, _ = c.servers[0].store.needle_extent(VOL, key)
        with ext:
            at = ext.data_offset + len(payload) // 2
        with open(os.path.join(c.dirs[0], f"{VOL}.dat"), "r+b") as f:
            f.seek(at)
            b = f.read(1)
            f.seek(at)
            f.write(bytes([b[0] ^ 0xFF]))
        assert v is not None
    monkeypatch.setenv("SEAWEEDFS_TPU_SENDFILE", "0")
    status, _h, body = _both(clusters, "GET", "/" + fid)
    assert status == 500 and "corrupt" in body["error"]


def _lose_ec_shards(c) -> None:
    """.ec00-.ec03 of the EC volume unmounted and deleted on A (a no-op
    once gone), and A's needle cache cleared."""
    stub = c.stub(0)
    stub.VolumeEcShardsUnmount(vs.VolumeEcShardsUnmountRequest(
        volume_id=EC, shard_ids=EC_LOST))
    stub.VolumeEcShardsDelete(vs.VolumeEcShardsDeleteRequest(
        volume_id=EC, shard_ids=EC_LOST))
    cache = c.servers[0].store.needle_cache
    if cache is not None:
        cache.clear()


def test_ec_gets_healthy_then_degraded(planes):
    clusters, ec_needles = planes
    keys = sorted(ec_needles)
    for key in keys:
        cookie, payload = ec_needles[key]
        status, _h, body = _both(clusters, "GET", "/" + _fid(EC, key, cookie))
        assert status == 200 and body == payload
    for c in clusters.values():
        _lose_ec_shards(c)
    misses = metrics.EC_INTERVAL_CACHE.labels("miss")
    decodes = metrics.EC_OP_HISTOGRAM.labels("reconstruct", "torch_cpu")
    before = (misses.value, decodes.count)
    for key in keys:
        cookie, payload = ec_needles[key]
        path = "/" + _fid(EC, key, cookie)
        status, _h, body = _both(clusters, "GET", path)
        assert status == 200 and body == payload
        status, headers, body = _both(clusters, "HEAD", path)
        assert status == 200 and int(headers["Content-Length"]) == len(
            payload)
    # the port decoded the lost intervals on its own codec
    assert misses.value > before[0] and decodes.count > before[1]
    for q in ("", "&shard=5", "&shard=1"):
        answers = {}
        for kind, c in clusters.items():
            status, _h, body = c.request("GET", f"/debug/canary/ec?volume={EC}"
                                         + q)
            doc = json.loads(body)
            doc.pop("reconstructMs", None)
            answers[kind] = (status, doc)
        assert answers["port"] == answers["reference"], q
        assert answers["port"][1]["ok"] is True
    assert _both(clusters, "GET", "/debug/canary/ec?volume=x")[0] == 400
    assert _both(clusters, "GET", "/debug/canary/ec?volume=99")[0] == 404


def test_ec_delete_writes_the_same_journal(planes):
    clusters, ec_needles = planes
    rng = np.random.default_rng(9)
    gone = sorted(rng.choice(sorted(ec_needles), 5, replace=False).tolist())
    for key in gone:
        cookie, _payload = ec_needles[key]
        path = "/" + _fid(EC, key, cookie)
        assert _both(clusters, "DELETE",
                     "/" + _fid(EC, key, cookie ^ 1))[0] == 404
        status, _h, body = _both(clusters, "DELETE", path)
        assert status == 202 and body["size"] > 0
        assert _both(clusters, "GET", path)[0] == 404
    journals = [open(os.path.join(c.dirs[0], f"{EC}.ecj"), "rb").read()
                for c in clusters.values()]
    assert journals[0] == journals[1] and len(journals[0]) == 8 * len(gone)


def test_replicated_post_and_delete_reach_b(planes):
    clusters, _ = planes
    key = b"replica-key"
    rng = np.random.default_rng(11)
    try:
        for c in clusters.values():
            for srv in c.servers:
                srv.jwt_signing_key = key
        for i in range(6):
            fid = _fid(REPL, 5000 + i, int(rng.integers(0, 2**32)))
            payload = _seeded(rng, 1, 128 << 10)
            auth = {"Authorization": "Bearer " + gen_write_jwt(key, fid)}
            assert _both(clusters, "POST", "/" + fid, payload, auth)[0] == 201
            status, _h, body = _both(clusters, "GET", "/" + fid, server=1)
            assert status == 200 and body == payload
            assert _both(clusters, "DELETE", "/" + fid,
                         headers=auth)[0] == 202
            for server in (0, 1):
                assert _both(clusters, "GET", "/" + fid,
                             server=server)[0] == 404
        # without the token the fan-out never starts
        fid = _fid(REPL, 5100, 1)
        assert _both(clusters, "POST", "/" + fid, b"x")[0] == 401
        assert _both(clusters, "GET", "/" + fid, server=1)[0] == 404
    finally:
        for c in clusters.values():
            for srv in c.servers:
                srv.jwt_signing_key = b""


def _parse_exposition(text: str) -> dict:
    """{family: [(labels, value)]} of Prometheus text; every sample line
    must parse."""
    families: dict[str, list] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_labels, value = line.rsplit(" ", 1)
        name, _, labels = name_labels.partition("{")
        families.setdefault(name, []).append((labels.rstrip("}"),
                                              float(value)))
    return families


def test_status_metrics_and_traces(planes):
    clusters, _ = planes
    status = {}
    for kind, c in clusters.items():
        code, _h, body = c.request("GET", "/status")
        status[kind] = json.loads(body)
        assert code == 200
    assert set(status["port"]) == set(status["reference"])
    assert status["port"]["volumes"] == status["reference"]["volumes"]
    port = clusters["port"]
    for where in (port.servers[0].port, port.servers[0].metrics_port):
        code, headers, body = port.request("GET", "/metrics", port=where)
        assert code == 200 and headers["Content-Type"].startswith(
            "text/plain")
        fams = _parse_exposition(body.decode())
        gets = dict(fams["seaweedfs_request_total"])
        assert gets['type="volumeServer",op="get"'] > 0
        for family in ("seaweedfs_sendfile_bytes_total",
                       "seaweedfs_httpd_inflight_requests",
                       "seaweedfs_request_seconds_bucket"):
            assert family in fams, family
        # the port's registry only: no master or filer family
        assert not any(f.startswith(("seaweedfs_raft_", "seaweedfs_geo_"))
                       for f in fams)
    code, _h, body = port.request("GET", "/metrics?family=seaweedfs_http")
    assert code == 200 and set(_parse_exposition(body.decode())) == {
        "seaweedfs_httpd_open_sockets", "seaweedfs_httpd_inflight_requests"}
    assert port.request("GET", "/metrics?family=bad-prefix")[0] == 400
    code, _h, body = port.request("GET", "/debug/traces?limit=1000")
    names = {s["name"] for t in json.loads(body)["traces"]
             for s in t["spans"]}
    assert {"volumeServer.get", "volumeServer.post",
            "volumeServer.delete"} <= names
    assert port.request("GET", "/debug/traces?trace=zz")[0] == 400
    for path in ("/debug/hot", "/debug/scrub", "/debug/faults",
                 "/debug/profile?status=1", "/ui/index.html"):
        assert port.request("GET", path)[0] == 200, path


def test_failed_degraded_decode_is_a_500_not_a_host_retry(planes):
    """A codec error during a degraded GET answers 500; the needle is not
    decoded again on the host codec."""
    clusters, ec_needles = planes
    port = clusters["port"]
    _lose_ec_shards(port)
    ev = port.servers[0].store.find_ec_volume(EC)
    if ev._interval_cache is not None:
        ev._interval_cache.clear()
    host = metrics.EC_OP_HISTOGRAM.labels("reconstruct", "cpu")
    before = host.count

    class Broken:
        name = "torch_cpu"

        def __getattr__(self, attr):
            def fail(*a, **k):
                raise RuntimeError("kernel launch failed")
            return fail

    saved = ev.codec
    ev.codec = Broken()
    try:
        key = min(k for k in ec_needles
                  if port.request("HEAD", "/" + _fid(EC, k, ec_needles[k][0])
                                  )[0] == 500)
    finally:
        ev.codec = saved
    status, _h, body = port.request("GET", "/" + _fid(EC, key,
                                                      ec_needles[key][0]))
    assert status == 200 and body == ec_needles[key][1]  # codec restored
    assert host.count == before


def test_port_server_stop_leaves_no_http_thread(tmp_path):
    master = chip_smoke.MiniMaster(rpc, master_pb2, free_port() + 10000)
    try:
        before = set(threading.enumerate())
        srv = VolumeServer([str(tmp_path)], [master.address], ip="127.0.0.1",
                           port=free_port(), metrics_port=free_port(),
                           codec_name="torch_cpu", pulse_seconds=1.0)
        srv.start()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        try:
            for _ in range(3):  # a keep-alive client stays connected
                conn.request("GET", "/status")
                assert conn.getresponse().read()
            srv.stop()
            left = [t.name for t in set(threading.enumerate()) - before
                    if t.is_alive() and t.name.startswith(
                        ("volume-", "httpd-", "metrics-", "http-conn",
                         "replica-fanout"))]
            assert not left, left
        finally:
            conn.close()
    finally:
        master.stop()


def test_refused_post_leaves_the_keepalive_connection_framed(planes):
    """The port drains the body of a POST it refuses before reading it (a
    missing write JWT, a malformed fid), so the next request on the same
    keep-alive connection answers normally.  The reference leaves the body
    unread, and its next request parses it as a request line."""
    clusters, _ = planes
    port = clusters["port"]
    srv = port.servers[0]
    fid, payload = _fid(VOL, 6000, 0x5151), b"kept framed" * 100
    assert port.request("POST", "/" + fid, payload)[0] == 201
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    srv.jwt_signing_key = b"k"
    try:
        for path in ("/" + _fid(VOL, 6001, 5), "/not-a-fid"):
            conn.request("POST", path, body=b"x" * 70000)
            r = conn.getresponse()
            assert r.status in (400, 401) and r.read()
            conn.request("GET", "/" + fid)
            r = conn.getresponse()
            assert r.status == 200 and r.read() == payload
    finally:
        srv.jwt_signing_key = b""
        conn.close()
