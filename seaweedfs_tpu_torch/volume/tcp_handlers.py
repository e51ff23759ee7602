"""Experimental raw-TCP needle data path.

The port's copy of seaweedfs_tpu/volume/tcp_handlers.py; its server
joins every connection's thread when it is closed.

Reference: weed/server/volume_server_tcp_handlers_write.go — a
line-oriented protocol that skips HTTP entirely for small-blob hot
paths:

  +<fid>\\n [u32 size][data]   put      -> +OK\\n | -ERR msg\\n
  -<fid>\\n                    delete   -> +OK\\n | -ERR msg\\n
  ?<fid>\\n                    get      -> +OK <size>\\n[data] | -ERR\\n
  !\\n                         flush

Documented divergences from the reference's experimental stub:
  * gets are framed with `+OK <size>` (the reference streams unframed
    bytes, which no client can parse);
  * every response is flushed per command (request/response clients
    would deadlock on the reference's explicit-'!' flushing);
  * writes fan out to replica peers like the HTTP plane, so a TCP put
    on a replication>000 volume cannot silently diverge the replicas;
  * the listener binds 127.0.0.1 by default, and write/delete commands
    are refused when the server requires write JWTs — the protocol has
    no credential field to carry one.
"""

from __future__ import annotations

import socketserver
import struct
import threading

from ..storage.file_id import FileId
from ..storage.needle import Needle
from ..util import glog
from ..util.httpd import LISTEN_BACKLOG, ConnectionThreadsMixin


class _Handler(socketserver.StreamRequestHandler):
    rbufsize = 1 << 20
    wbufsize = 1 << 20

    def handle(self) -> None:
        server = self.server.volume_server  # type: ignore[attr-defined]
        store = server.store
        while True:
            line = self.rfile.readline()
            if not line:
                return
            cmd = line.rstrip(b"\n").decode("utf-8", "replace")
            if not cmd:
                continue
            op, fid_str = cmd[0], cmd[1:]
            try:
                if op == "+":
                    # consume the frame BEFORE any validation: an early
                    # -ERR would leave the length prefix + payload in the
                    # stream to be parsed as commands (desync)
                    (size,) = struct.unpack(">I", self._read_exact(4))
                    data = self._read_exact(size)
                    if server.jwt_signing_key:
                        raise PermissionError(
                            "writes require a jwt; the tcp protocol "
                            "carries none — use the http data path")
                    fid = FileId.parse(fid_str)
                    n = Needle(cookie=fid.cookie, id=fid.key, data=data)
                    store.write_needle(fid.volume_id, n)
                    err = server.replicate_write(
                        fid, f"/{fid_str}", data, {})
                    if err:
                        raise IOError(f"replication: {err}")
                    self.wfile.write(b"+OK\n")
                elif op == "-":
                    if server.jwt_signing_key:
                        raise PermissionError(
                            "deletes require a jwt; the tcp protocol "
                            "carries none — use the http data path")
                    fid = FileId.parse(fid_str)
                    # same anti-tamper contract as the HTTP delete path:
                    # the cookie must match before anything is removed
                    n = store.read_needle(fid.volume_id, fid.key)
                    if n.cookie != fid.cookie:
                        raise PermissionError("cookie mismatch")
                    store.delete_needle(fid.volume_id, fid.key)
                    server.replicate_delete(fid, f"/{fid_str}")
                    self.wfile.write(b"+OK\n")
                elif op == "?":
                    fid = FileId.parse(fid_str)
                    n = store.read_needle(fid.volume_id, fid.key,
                                          expected_cookie=fid.cookie)
                    data = bytes(n.data)
                    self.wfile.write(f"+OK {len(data)}\n".encode())
                    self.wfile.write(data)
                elif op == "!":
                    pass
                else:
                    self.wfile.write(b"-ERR unknown command\n")
            except Exception as e:  # noqa: BLE001 — per-command errors
                self.wfile.write(f"-ERR {e}\n".encode())
            # responses flush per command: an unflushed reply deadlocks
            # request/response clients
            self.wfile.flush()

    def _read_exact(self, size: int) -> bytes:
        out = bytearray()
        while len(out) < size:
            chunk = self.rfile.read(size - len(out))
            if not chunk:
                raise EOFError("connection closed mid-frame")
            out += chunk
        return bytes(out)


class TcpServer(ConnectionThreadsMixin, socketserver.ThreadingTCPServer):
    request_queue_size = LISTEN_BACKLOG
    allow_reuse_address = True
    conn_thread_prefix = "volume-tcp-conn"

    def __init__(self, *args, **kwargs):
        self._track_init()
        super().__init__(*args, **kwargs)


def serve_tcp(volume_server, port: int, host: str = "127.0.0.1") -> TcpServer:
    """Serve the protocol on host:port from a thread of its own
    (`srv.serve_thread`); `shutdown()` then `server_close()` stop it and
    join every connection's thread."""
    srv = TcpServer((host, port), _Handler)
    srv.volume_server = volume_server  # type: ignore[attr-defined]
    srv.serve_thread = threading.Thread(  # type: ignore[attr-defined]
        target=srv.serve_forever, name="volume-tcp", daemon=True)
    srv.serve_thread.start()
    glog.info("volume tcp data path on %s:%d", host, port)
    return srv
