"""Filer HTTP data path: auto-chunking writes, chunk-resolved reads, listing
— the port's copy of seaweedfs_tpu/filer/http_handlers.py.

Reference: weed/server/filer_server_handlers_write_autochunk.go:24 (upload
split into fixed-size chunks, each assigned + uploaded to volume servers,
then one CreateEntry) and filer_server_handlers_read.go (resolve chunk
views, range reads).  Directory GETs return a JSON listing with
pagination (?limit=&lastFileName=).  The geo replication surface
(`/.geo/status`, `POST /.geo/apply`) answers 501 naming ROADMAP A-7.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler
from ..util.httpd import (
    BufferedResponseMixin,
    make_http_server,
    shield_handler,
)

from ..pb import filer_pb2
from ..telemetry import hotkeys, http_request, serve_debug_http, trace
from . import filechunks
from .filer import join_path, split_path
from .fleet.tenant import (
    QuotaExceededError,
    SlowDownError,
    tenant_for_path,
)


class FilerHttpHandler(BufferedResponseMixin, BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "seaweedfs-tpu-filer"

    filer_server = None  # injected by serve_http

    def log_message(self, fmt, *args):
        pass

    @property
    def filer(self):
        return self.filer_server.filer

    def _send(self, code: int, body: bytes = b"",
              content_type: str = "application/json",
              extra: dict | None = None):
        extra = extra or {}
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        if "Content-Length" not in extra:
            self.send_header("Content-Length", str(len(body)))
        for k, v in extra.items():
            self.send_header(k, v)
        self.end_headers()
        if body and self.command != "HEAD":
            self.wfile.write(body)

    def _json(self, code: int, obj: dict):
        self._send(code, json.dumps(obj).encode())

    # -- admission (fleet WFQ) ---------------------------------------------

    def _admitted(self, fn) -> None:
        """Run one request under the tenant admission gate.  A rejection
        is a well-formed 503 with Retry-After + a machine-readable
        X-Seaweed-Reject header the S3 gateway translates into SlowDown
        XML; untenanted paths (config, /debug) pass uncounted."""
        tenant = tenant_for_path(
            urllib.parse.unquote(urllib.parse.urlparse(self.path).path))
        hotkeys.record("tenant", tenant)
        try:
            with self.filer_server.admission.admit(tenant):
                fn()
        except SlowDownError as e:
            self._send(503, json.dumps({"error": str(e)}).encode(),
                       extra={"Retry-After": str(e.retry_after),
                              "X-Seaweed-Reject": "slowdown"})

    # -- read / list -------------------------------------------------------

    def do_GET(self):
        with http_request(self, "filer", "get"):
            self._admitted(self._do_get)

    def _do_get(self):
        u = urllib.parse.urlparse(self.path)
        path = urllib.parse.unquote(u.path)
        q = urllib.parse.parse_qs(u.query)
        if path == "/debug/tenants":
            return self._serve_tenants(q)
        if path == "/.geo/status":
            return self._geo_left_out()
        # debug/observability surface (exact paths, ahead of the namespace)
        if serve_debug_http(self, path):
            return
        entry = self.filer.find_entry(path)
        if entry is None:
            return self._json(404, {"error": f"{path}: not found"})
        if entry.is_directory:
            return self._list_dir(path, q)
        return self._read_file(path, entry)

    def do_HEAD(self):
        with http_request(self, "filer", "get"):
            self._admitted(self._do_get)

    def _serve_tenants(self, q: dict):
        """The shard's tenant plane in one JSON: quota config + usage per
        tenant, the admission controller's live state, and this store's
        entry count (the `filer.ring` shell command's data source).

        ``?set=<tenant>&quota_bytes=&quota_objects=&weight=`` updates a
        tenant's config — the HTTP twin of a gRPC KvPut, which already
        exposes the same store to anyone with cluster reach."""
        fs = self.filer_server
        if q.get("set", [""])[0]:
            tenant = q["set"][0]
            kw = {}
            for key in ("quota_bytes", "quota_objects"):
                if q.get(key, [""])[0]:
                    try:
                        kw[key] = int(q[key][0])
                    except ValueError:
                        return self._json(400, {
                            "error": f"{key} must be an integer"})
            if q.get("weight", [""])[0]:
                try:
                    kw["weight"] = float(q["weight"][0])
                except ValueError:
                    return self._json(400, {"error": "bad weight"})
            conf = fs.tenants.set_config(tenant, **kw)
            return self._json(200, {"tenant": tenant, "config": conf})
        try:
            entries = self.filer.store.count_entries()
        except Exception:  # noqa: BLE001 — optional per-backend
            entries = None
        return self._json(200, {
            "tenants": fs.tenants.snapshot(),
            "admission": fs.admission.snapshot(),
            "entries": entries,
            "store": type(self.filer.store).__name__,
        })

    def _list_dir(self, path: str, q: dict):
        limit = int(q.get("limit", ["100"])[0])
        last = q.get("lastFileName", [""])[0]
        entries = list(
            self.filer.list_directory(
                "/" + path.strip("/") if path != "/" else "/",
                start_from=last,
                limit=limit + 1,
            )
        )
        more = len(entries) > limit
        entries = entries[:limit]
        return self._json(200, {
            "Path": path,
            "Entries": [_entry_json(path, e) for e in entries],
            "Limit": limit,
            "LastFileName": entries[-1].name if entries else "",
            "ShouldDisplayLoadMore": more,
        })

    def _read_file(self, path: str, entry: filer_pb2.Entry):
        mime = entry.attributes.mime or "application/octet-stream"
        size = filechunks.total_size(entry.chunks) or len(entry.content)
        etag = filechunks.etag(entry.chunks) if entry.chunks else ""
        extra = {"Accept-Ranges": "bytes", "Etag": f'"{etag}"'}
        start, length = 0, size
        rng = self.headers.get("Range")
        status = 200
        if rng and rng.startswith("bytes="):
            try:
                start_s, end_s = rng[len("bytes="):].split("-", 1)
                if not start_s:
                    start = max(0, size - int(end_s))
                    end = size - 1
                else:
                    start = int(start_s)
                    end = min(int(end_s), size - 1) if end_s else size - 1
                if start > end:
                    raise ValueError
                length = end - start + 1
                extra["Content-Range"] = f"bytes {start}-{end}/{size}"
                status = 206
            except ValueError:
                return self._json(416, {"error": "bad range"})
        if self.command == "HEAD":
            return self._send(status, b"\0" * 0, mime,
                              {**extra, "Content-Length": str(length)})
        try:
            data = self.filer_server.read_entry_range(entry, start, length)
        except Exception as e:
            # only reached after replica failover AND the refreshed-lookup
            # (EC degraded-read) round both failed; the trace id links the
            # 5xx to the per-location failures in /debug/traces
            return self._json(500, {
                "error": str(e),
                "trace": trace.current_trace_id() or "",
            })
        self._send(status, data, mime, extra)

    # -- geo replication (replication/geo.py: ROADMAP A-7c) -----------------

    def _geo_left_out(self):
        # a POST's body goes unread: the connection must not be reused
        self.close_connection = True
        return self._send(501, json.dumps({
            "error": "geo replication (replication/geo.py) is not ported "
                     "yet (ROADMAP A-7c)"}).encode(),
            extra={"Connection": "close"})

    # -- write -------------------------------------------------------------

    def do_POST(self):
        if self.path.startswith("/.geo/"):
            with http_request(self, "filer", "geo"):
                return self._geo_left_out()
        with http_request(self, "filer", "post"):
            self._admitted(self._upload)

    def do_PUT(self):
        with http_request(self, "filer", "post"):
            self._admitted(self._upload)

    def _quota_reject(self, e: QuotaExceededError):
        return self._send(403, json.dumps({"error": str(e)}).encode(),
                          extra={"X-Seaweed-Reject": "quota"})

    def _upload(self):
        u = urllib.parse.urlparse(self.path)
        path = urllib.parse.unquote(u.path)
        q = urllib.parse.parse_qs(u.query)
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "")
        name_hint = b""
        if ctype.startswith("multipart/form-data"):
            from ..volume.http_handlers import _parse_multipart

            body, name_hint, part_mime = _parse_multipart(body, ctype)
            if part_mime:
                ctype = part_mime.decode()
        if path.endswith("/"):
            # upload INTO a directory: use the part filename
            if not name_hint:
                return self._json(400, {"error": "no filename for directory upload"})
            path = path + name_hint.decode(errors="replace")
        collection = q.get("collection", [""])[0] or self.filer.bucket_collection(path)
        ttl = q.get("ttl", [""])[0]
        if q.get("op", [""])[0] == "append":
            try:
                entry = self.filer_server.append_file(
                    path, body, mime=ctype, collection=collection,
                    replication=q.get("replication", [""])[0], ttl=ttl,
                )
            except QuotaExceededError as e:
                return self._quota_reject(e)
            except Exception as e:
                return self._json(500, {
                    "error": str(e),
                    "trace": trace.current_trace_id() or "",
                })
            return self._json(201, {
                "name": entry.name,
                "size": filechunks.total_size(entry.chunks),
            })
        try:
            entry = self.filer_server.write_file(
                path, body,
                mime=ctype if ctype and not ctype.startswith("multipart") else "",
                collection=collection,
                replication=q.get("replication", [""])[0],
                ttl=ttl,
                signatures=_signatures(q),
            )
        except QuotaExceededError as e:
            return self._quota_reject(e)
        except Exception as e:
            return self._json(500, {
                "error": str(e),
                "trace": trace.current_trace_id() or "",
            })
        self._json(201, {
            "name": entry.name,
            "size": filechunks.total_size(entry.chunks) or len(entry.content),
        })

    # -- delete ------------------------------------------------------------

    def do_DELETE(self):
        with http_request(self, "filer", "delete"):
            self._admitted(self._do_delete)

    def _do_delete(self):
        u = urllib.parse.urlparse(self.path)
        path = urllib.parse.unquote(u.path)
        q = urllib.parse.parse_qs(u.query)
        recursive = q.get("recursive", ["false"])[0] == "true"
        directory, name = split_path(path)
        try:
            self.filer.delete_entry(
                directory, name, is_recursive=recursive,
                ignore_recursive_error=q.get("ignoreRecursiveError", ["false"])[0] == "true",
                signatures=_signatures(q),
            )
        except FileNotFoundError:
            return self._json(404, {"error": f"{path}: not found"})
        except IsADirectoryError as e:
            return self._json(400, {"error": str(e)})
        self._send(204)


def _signatures(q: dict) -> list[int]:
    """?signature=N (repeatable): mutation provenance markers so metadata
    subscribers can skip events they caused themselves (filer.sync loop
    prevention, command/filer_sync.go)."""
    out = []
    for v in q.get("signature", []):
        try:
            out.append(int(v))
        except ValueError:
            continue
    return out


def _entry_json(dir_path: str, e: filer_pb2.Entry) -> dict:
    return {
        "FullPath": join_path("/" + dir_path.strip("/") if dir_path != "/" else "/", e.name),
        "IsDirectory": e.is_directory,
        "FileSize": filechunks.total_size(e.chunks) or e.attributes.file_size or len(e.content),
        "Mtime": e.attributes.mtime,
        "Crtime": e.attributes.crtime,
        "Mime": e.attributes.mime,
        "Chunks": len(e.chunks),
    }



shield_handler(FilerHttpHandler, "_json")


def serve_http(filer_server, host: str, port: int):
    handler = type(
        "BoundFilerHttpHandler", (FilerHttpHandler,),
        {"filer_server": filer_server},
    )
    # opts into the event loop only under SEAWEEDFS_TPU_EVENTLOOP=all
    httpd = make_http_server((host, port), handler, surface="filer")
    httpd.serve_thread = threading.Thread(
        target=httpd.serve_forever, name="filer-http", daemon=True)
    httpd.serve_thread.start()
    return httpd
