"""Volume-server HTTP data path: POST/GET/DELETE `/<vid>,<fid>`.

The port's copy of seaweedfs_tpu/volume/http_handlers.py.  A needle of an
EC volume is read through the store's `read_needle`, so on a server whose
codec is `cuda` a lost interval is decoded on the card
(`EcVolume._gather_and_decode` -> `rs_cuda.gf_apply`).  No handler retries
a failed decode on the host: a codec or launch error answers 500, as any
IOError does.  A POST refused before its body is read (a malformed fid,
a missing write JWT) drains the body first, so the next request on the
keep-alive connection parses clean; the reference leaves it unread.  The
thread serving the front end is `httpd.serve_thread`, which the volume
server joins when it stops.

Reference: weed/server/volume_server_handlers_{read,write}.go — clients
upload directly to volume servers after a master Assign; reads fall back to
EC volumes transparently; replicated writes fan out to peers with
`?type=replicate`.
"""

from __future__ import annotations

import json
import os
import select
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler
from ..util.httpd import (
    BufferedResponseMixin,
    drain_request_body,
    make_http_server,
    shield_handler,
)

from .. import images
from ..security.jwt import token_from_header, verify_write_jwt
from ..telemetry import hotkeys, http_request, serve_debug_http
from ..storage.file_id import FileId
from ..storage.disk_health import DiskFailingError, DiskFullError
from ..storage.needle import (
    FLAG_HAS_MIME,
    FLAG_HAS_NAME,
    CorruptNeedleError,
    Needle,
)
from ..stats.metrics import (
    SENDFILE_BYTES,
    SENDFILE_FALLBACK,
    VOLUME_FULL_REJECT,
)
from ..util import faultpoint


def _sendfile_enabled() -> bool:
    return os.environ.get(
        "SEAWEEDFS_TPU_SENDFILE", "1").strip().lower() not in (
        "0", "off", "false", "none")

# chaos points on the public data path; ctx is this server's host:port so
# one server out of several in-process can be targeted via &match=
FP_GET = faultpoint.register("volume.http.get")
FP_POST = faultpoint.register("volume.http.post")


class VolumeHttpHandler(BufferedResponseMixin, BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "seaweedfs-tpu-volume"

    # injected by serve():
    volume_server = None

    def log_message(self, fmt, *args):  # quiet
        pass

    @property
    def store(self):
        return self.volume_server.store

    def handle_one_request(self):
        # IP whitelist guard (security/guard.go:43)
        guard = self.volume_server.guard
        if guard.networks and not guard.allows(self.client_address[0]):
            try:
                self.raw_requestline = self.rfile.readline(65537)
                if self.raw_requestline and self.parse_request():
                    self._send_json(403, {"error": "ip not in whitelist"})
            except Exception:
                pass
            self.close_connection = True
            return
        super().handle_one_request()

    def _check_write_jwt(self, fid_str: str) -> bool:
        """JWT write-token verification when the cluster is keyed
        (security/jwt.go ValidateJwt)."""
        key = self.volume_server.jwt_signing_key
        if not key:
            return True
        token = token_from_header(self.headers.get("Authorization"))
        return verify_write_jwt(key, token, fid_str)

    def _send(self, code: int, body: bytes = b"", content_type: str = "application/json", extra: dict | None = None):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        if body and self.command != "HEAD":
            self.wfile.write(body)

    def _send_json(self, code: int, obj: dict):
        self._send(code, json.dumps(obj).encode(), "application/json")

    # -- read -------------------------------------------------------------

    def do_GET(self):
        with http_request(self, "volumeServer", "get"):
            self._do_get()

    def _do_get(self):
        path = urllib.parse.urlparse(self.path)
        if path.path in ("/status", "/healthz"):
            return self._send_json(200, {"Version": "seaweedfs-tpu", **self.store.status()})
        if serve_debug_http(self, path.path):
            return
        if path.path == "/debug/scrub":
            return self._send_json(200, self.volume_server.scrubber.status())
        if path.path == "/debug/canary/ec":
            # black-box degraded-read probe: read a live needle with one
            # locally held shard forced through the reconstruct path, CRC
            # (= byte identity) checked.  The master's canary prober
            # drives this so "EC decode broken" pages before a real
            # shard loss discovers it.
            q = urllib.parse.parse_qs(path.query)
            try:
                vid = int(q.get("volume", [""])[0])
                drop = q.get("shard", [""])[0]
                drop_shard = int(drop) if drop else None
            except ValueError:
                return self._send_json(
                    400, {"error": "volume=<int> required; shard=<int>"})
            ev = self.store.find_ec_volume(vid)
            if ev is None:
                return self._send_json(
                    404, {"ok": False,
                          "error": f"ec volume {vid} not here"})
            t0 = time.perf_counter()
            try:
                res = ev.canary_read(drop_shard=drop_shard)
            except KeyError as e:
                # no live needle (empty or fully tombstoned volume):
                # nothing to probe is not a serving failure
                return self._send_json(
                    200, {"ok": False, "empty": True,
                          "error": str(e)[:300]})
            except Exception as e:  # noqa: BLE001 — probe answer, not a crash
                return self._send_json(
                    500, {"ok": False, "error": str(e)[:300]})
            return self._send_json(200, {
                "ok": True,
                "reconstructMs": round(
                    (time.perf_counter() - t0) * 1e3, 3),
                **res,
            })
        if path.path in ("/ui", "/ui/", "/ui/index.html"):
            from ..util.ui import render_status_page

            page = render_status_page(
                f"seaweedfs-tpu volume {self.volume_server.ip}:"
                f"{self.volume_server.port}",
                {"Status": self.store.status()})
            return self._send(200, page, "text/html")
        try:
            fid = FileId.parse(path.path.lstrip("/"))
        except ValueError:
            return self._send_json(404, {"error": "invalid file id"})
        hotkeys.record("needle", str(fid))
        if (
            self.store.find_volume(fid.volume_id) is None
            and self.store.find_ec_volume(fid.volume_id) is None
        ):
            # not local: redirect to a server that has it (ReadRedirect)
            target = self.volume_server.lookup_volume_url(fid.volume_id)
            if target and target != f"{self.volume_server.ip}:{self.volume_server.port}":
                return self._send(
                    302, b"", "text/plain",
                    {"Location": f"http://{target}{self.path}"},
                )
            return self._send_json(404, {"error": f"volume {fid.volume_id} not found"})
        try:
            me = f"{self.volume_server.ip}:{self.volume_server.port}"
            faultpoint.inject(FP_GET, ctx=me)
            if self._maybe_sendfile(fid, path):
                return
            n = self.store.read_needle(fid.volume_id, fid.key)
        except KeyError:
            return self._send_json(404, {"error": "not found"})
        except CorruptNeedleError as e:
            # quarantined by the store; a 5xx is the retryable NACK the
            # filer's _download_failover rotates on, so the client's read
            # lands on a healthy replica while repair runs in background
            return self._send_json(
                500, {"error": f"needle corrupt, retry a replica: {e}"})
        except IOError as e:
            return self._send_json(500, {"error": str(e)})
        if n.cookie != fid.cookie:
            return self._send_json(404, {"error": "cookie mismatch"})
        mime = n.mime.decode() if n.has(FLAG_HAS_MIME) and n.mime else "application/octet-stream"
        data = n.data
        # image GETs: EXIF orientation fix + ?width/?height/?mode resize
        # on read (volume_server_handlers_read.go -> images/resizing.go)
        ext = ""
        name = n.name.decode(errors="replace") if n.name else path.path
        if "." in name:
            ext = "." + name.rsplit(".", 1)[1].lower()
        if images.is_image(ext, mime):
            q = urllib.parse.parse_qs(path.query)
            data = images.fix_orientation(bytes(data))
            try:
                w = int(q.get("width", ["0"])[0] or 0)
                h = int(q.get("height", ["0"])[0] or 0)
            except ValueError:
                return self._send_json(400, {"error": "bad width/height"})
            if w or h:
                data, _, _ = images.resized(
                    bytes(data), ext or "." + mime.rpartition("/")[2],
                    w, h, q.get("mode", [""])[0])
        rng = self.headers.get("Range")
        extra = {
            "Etag": f'"{n.checksum:x}"',
            "Accept-Ranges": "bytes",
        }
        if rng and rng.startswith("bytes="):
            try:
                start_s, end_s = rng[len("bytes="):].split("-", 1)
                if not start_s:
                    # suffix range (RFC 7233): bytes=-N means the last N bytes
                    start = max(0, len(data) - int(end_s))
                    end = len(data) - 1
                else:
                    start = int(start_s)
                    end = int(end_s) if end_s else len(data) - 1
                end = min(end, len(data) - 1)
                if start > end:
                    raise ValueError
                extra["Content-Range"] = f"bytes {start}-{end}/{len(data)}"
                return self._send(206, data[start : end + 1], mime, extra)
            except ValueError:
                return self._send_json(416, {"error": "bad range"})
        self._send(200, data, mime, extra)

    # -- zero-copy read path ----------------------------------------------

    def _maybe_sendfile(self, fid, path) -> bool:
        """Whole-needle GETs serve disk→socket via os.sendfile: the
        payload bytes never enter userspace.  Anything that must touch
        the bytes (Range math, image transforms) or that has them in
        memory already (needle cache) declines and falls back to the
        ordinary read path.  -> True when the response was fully
        handled here."""
        if not _sendfile_enabled():
            SENDFILE_FALLBACK.labels("disabled").inc()
            return False
        if self.headers.get("Range"):
            SENDFILE_FALLBACK.labels("range").inc()
            return False
        ext, reason = self.store.needle_extent(fid.volume_id, fid.key)
        if ext is None:
            SENDFILE_FALLBACK.labels(reason or "error").inc()
            return False
        with ext:
            n = ext.needle
            if n.cookie != fid.cookie:
                self._send_json(404, {"error": "cookie mismatch"})
                return True
            mime = (n.mime.decode() if n.has(FLAG_HAS_MIME) and n.mime
                    else "application/octet-stream")
            name = n.name.decode(errors="replace") if n.name else path.path
            file_ext = ("." + name.rsplit(".", 1)[1].lower()
                        if "." in name else "")
            if images.is_image(file_ext, mime):
                # the GET pipeline re-orients/resizes images in
                # userspace; zero-copy would skip it
                SENDFILE_FALLBACK.labels("transform").inc()
                return False
            self.send_response(200)
            self.send_header("Content-Type", mime)
            self.send_header("Content-Length", str(ext.data_len))
            self.send_header("Etag", f'"{n.checksum:x}"')
            self.send_header("Accept-Ranges", "bytes")
            self.end_headers()
            self._stream_extent(ext)
        return True

    def _stream_extent(self, ext) -> None:
        """Ship ext's byte range after the headers: sendfile first, a
        pread→write loop if the very first sendfile call is refused
        (odd socket type); a failure after any payload byte went out
        can only close the connection — the stream is torn."""
        try:
            self.wfile.flush()  # headers must precede the payload
        except OSError:
            self.close_connection = True
            return
        sock = self.connection
        offset, remaining = ext.data_offset, ext.data_len
        sent_any = False
        try:
            while remaining > 0:
                try:
                    sent = os.sendfile(
                        sock.fileno(), ext.fd, offset, remaining)
                except BlockingIOError:
                    # the socket send buffer is full (the fd is
                    # non-blocking under a socket timeout): wait until
                    # writable, bounded by the same timeout
                    r = select.select(
                        [], [sock], [], sock.gettimeout() or 60.0)
                    if not r[1]:
                        raise OSError(110, "sendfile stalled") from None
                    continue
                if sent == 0:
                    raise OSError(5, "sendfile returned 0")
                sent_any = True
                offset += sent
                remaining -= sent
            SENDFILE_BYTES.inc(ext.data_len)
        except (OSError, AttributeError):
            if sent_any:
                self.close_connection = True
                return
            SENDFILE_FALLBACK.labels("error").inc()
            try:
                while remaining > 0:
                    chunk = os.pread(
                        ext.fd, min(remaining, 1 << 18), offset)
                    if not chunk:
                        raise OSError(5, "short extent read")
                    self.wfile.write(chunk)
                    offset += len(chunk)
                    remaining -= len(chunk)
                self.wfile.flush()
            except OSError:
                self.close_connection = True

    def do_HEAD(self):
        """HEAD answers from needle metadata alone: no EXIF re-orientation,
        no resize — the GET pipeline ran the full image transform only to
        throw the body away.  Content-Length reflects the stored bytes
        (a transformed GET body may differ; metadata-accurate beats
        paying the transform per HEAD)."""
        with http_request(self, "volumeServer", "get"):
            self._do_head()

    def _do_head(self):
        path = urllib.parse.urlparse(self.path)
        try:
            fid = FileId.parse(path.path.lstrip("/"))
        except ValueError:
            # non-fid paths (/status, /ui, debug): same answers as GET,
            # minus the body (_send skips it for HEAD)
            return self._do_get()
        if (
            self.store.find_volume(fid.volume_id) is None
            and self.store.find_ec_volume(fid.volume_id) is None
        ):
            target = self.volume_server.lookup_volume_url(fid.volume_id)
            if target and target != f"{self.volume_server.ip}:{self.volume_server.port}":
                return self._send(
                    302, b"", "text/plain",
                    {"Location": f"http://{target}{self.path}"},
                )
            return self._send_json(404, {"error": f"volume {fid.volume_id} not found"})
        try:
            n = self.store.read_needle(fid.volume_id, fid.key)
        except KeyError:
            return self._send_json(404, {"error": "not found"})
        except CorruptNeedleError as e:
            return self._send_json(
                500, {"error": f"needle corrupt, retry a replica: {e}"})
        except IOError as e:
            return self._send_json(500, {"error": str(e)})
        if n.cookie != fid.cookie:
            return self._send_json(404, {"error": "cookie mismatch"})
        mime = n.mime.decode() if n.has(FLAG_HAS_MIME) and n.mime else "application/octet-stream"
        extra = {
            "Etag": f'"{n.checksum:x}"',
            "Accept-Ranges": "bytes",
        }
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            # range semantics preserved (206 + Content-Range against the
            # stored length) — only the image transforms are skipped
            total = len(n.data)
            try:
                start_s, end_s = rng[len("bytes="):].split("-", 1)
                if not start_s:
                    start = max(0, total - int(end_s))
                    end = total - 1
                else:
                    start = int(start_s)
                    end = int(end_s) if end_s else total - 1
                end = min(end, total - 1)
                if start > end:
                    raise ValueError
                extra["Content-Range"] = f"bytes {start}-{end}/{total}"
                return self._send(206, n.data[start : end + 1], mime, extra)
            except ValueError:
                return self._send_json(416, {"error": "bad range"})
        self._send(200, n.data, mime, extra)

    # -- write ------------------------------------------------------------

    def do_POST(self):
        with http_request(self, "volumeServer", "post"):
            self._do_post()

    def _do_post(self):
        path = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(path.query)
        try:
            fid = FileId.parse(path.path.lstrip("/"))
        except ValueError:
            drain_request_body(self)
            return self._send_json(400, {"error": "invalid file id"})
        hotkeys.record("needle", str(fid))
        if not self._check_write_jwt(path.path.lstrip("/")):
            # the refused body must not stay on a keep-alive connection,
            # where the next request would parse it as a request line
            drain_request_body(self)
            return self._send_json(401, {"error": "missing or invalid jwt"})
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "")
        name = b""
        mime = b""
        data = body
        if ctype.startswith("multipart/form-data"):
            data, name, mime = _parse_multipart(body, ctype)
        try:
            # chaos point: error -> 500 before any write, delay -> slow
            # ack, partial -> the needle stores a truncated body
            me = f"{self.volume_server.ip}:{self.volume_server.port}"
            data = faultpoint.inject(FP_POST, ctx=me, data=data)
        except faultpoint.FaultInjected as e:
            return self._send_json(500, {"error": str(e)})
        n = Needle(cookie=fid.cookie, id=fid.key, data=data)
        if name:
            n.set(FLAG_HAS_NAME)
            n.name = name[:255]
        if mime and mime != b"application/octet-stream":
            n.set(FLAG_HAS_MIME)
            n.mime = mime
        n.append_at_ns = time.time_ns()
        try:
            size = self.store.write_needle(fid.volume_id, n)
        except KeyError:
            return self._send_json(404, {"error": f"volume {fid.volume_id} not found"})
        except DiskFullError as e:
            # typed 409: the volume/disk is full — a 4xx so no layer
            # retries HERE; the client re-assigns to a different volume
            # immediately (not on the next heartbeat)
            VOLUME_FULL_REJECT.inc()
            return self._send_json(
                409, {"error": str(e), "volumeFull": True})
        except DiskFailingError as e:
            # retryable 5xx: replicas/another assign absorb it while the
            # health machine counts the EIO toward evacuation
            return self._send_json(500, {"error": str(e)})
        except PermissionError as e:
            return self._send_json(403, {"error": str(e)})
        # replicate to peers unless this IS a replicated write
        if "replicate" not in qs.get("type", []):
            err = self.volume_server.replicate_write(fid, self.path, body, self.headers)
            if err:
                if "status 409" in err:
                    # a replica's disk filled: surface the same typed
                    # re-assign signal, not an opaque 500
                    VOLUME_FULL_REJECT.inc()
                    return self._send_json(
                        409, {"error": f"replication: {err}",
                              "volumeFull": True})
                return self._send_json(500, {"error": f"replication: {err}"})
        self._send_json(201, {"name": name.decode(errors="replace"), "size": int(size), "eTag": f"{n.checksum:x}"})

    def do_PUT(self):
        self.do_POST()

    # -- delete -----------------------------------------------------------

    def do_DELETE(self):
        with http_request(self, "volumeServer", "delete"):
            self._do_delete()

    def _do_delete(self):
        path = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(path.query)
        try:
            fid = FileId.parse(path.path.lstrip("/"))
        except ValueError:
            return self._send_json(400, {"error": "invalid file id"})
        hotkeys.record("needle", str(fid))
        if not self._check_write_jwt(path.path.lstrip("/")):
            return self._send_json(401, {"error": "missing or invalid jwt"})
        # EC volumes: tombstone + distributed fan-out to all shard holders
        if (
            self.store.find_volume(fid.volume_id) is None
            and self.store.find_ec_volume(fid.volume_id) is not None
        ):
            try:
                n = self.store.read_needle(fid.volume_id, fid.key)
                if n.cookie != fid.cookie:
                    return self._send_json(404, {"error": "cookie mismatch"})
            except KeyError:
                return self._send_json(404, {"error": "not found"})
            size = self.volume_server.delete_ec_needle_distributed(
                fid.volume_id, fid.key
            )
            return self._send_json(202, {"size": int(size)})
        try:
            n = self.store.read_needle(fid.volume_id, fid.key)
            if n.cookie != fid.cookie:
                return self._send_json(404, {"error": "cookie mismatch"})
            size = self.store.delete_needle(fid.volume_id, fid.key)
        except KeyError:
            return self._send_json(404, {"error": "not found"})
        except (DiskFullError, DiskFailingError) as e:
            # retryable 5xx, NOT the write path's 409: "re-assign" is
            # meaningless for a delete — the client's failover sends it
            # to a replica, whose fan-out tombstones this copy too
            return self._send_json(500, {"error": str(e)})
        except CorruptNeedleError as e:
            # cannot cookie-check rotten bytes; the retryable error sends
            # the delete to a healthy replica, whose fan-out tombstones
            # this copy too
            return self._send_json(
                500, {"error": f"needle corrupt, retry a replica: {e}"})
        if "replicate" not in qs.get("type", []):
            self.volume_server.replicate_delete(
                fid, self.path, self.headers.get("Authorization") or ""
            )
        self._send_json(202, {"size": int(size)})


def _parse_multipart(body: bytes, ctype: str) -> tuple[bytes, bytes, bytes]:
    """Minimal multipart/form-data parse: first file part wins."""
    boundary = None
    for piece in ctype.split(";"):
        piece = piece.strip()
        if piece.startswith("boundary="):
            boundary = piece[len("boundary="):].strip('"').encode()
    if not boundary:
        return body, b"", b""
    delim = b"--" + boundary
    # parts are separated by CRLF + delimiter; the first delimiter may have
    # no preceding CRLF, and the last is delim + b"--".  Splitting on the
    # exact separator keeps payload bytes intact (no rstrip — trailing
    # \r\n or '-' bytes in the data must survive).
    normalized = body if body.startswith(b"\r\n") else b"\r\n" + body
    for part in normalized.split(b"\r\n" + delim)[1:]:
        if part.startswith(b"--"):
            break  # closing delimiter
        if part.startswith(b"\r\n"):
            part = part[2:]
        head, sep, content = part.partition(b"\r\n\r\n")
        if not sep:
            continue
        name = b""
        mime = b""
        for line in head.split(b"\r\n"):
            low = line.lower()
            if low.startswith(b"content-disposition") and b"filename=" in low:
                fn = line.split(b"filename=")[-1].strip(b'"')
                name = fn.split(b'"')[0]
            elif low.startswith(b"content-type:"):
                mime = line.split(b":", 1)[1].strip()
        if name or content:
            return content, name, mime
    return body, b"", b""




shield_handler(VolumeHttpHandler, "_send_json")


def serve_http(volume_server, host: str, port: int):
    handler = type(
        "BoundVolumeHttpHandler",
        (VolumeHttpHandler,),
        {"volume_server": volume_server},
    )
    # the volume data port is the event-loop front end's first surface
    # (SEAWEEDFS_TPU_EVENTLOOP=off falls back to thread-per-connection)
    httpd = make_http_server((host, port), handler, surface="volume")
    httpd.serve_thread = threading.Thread(
        target=httpd.serve_forever, name="volume-http", daemon=True)
    httpd.serve_thread.start()
    return httpd
