"""Shared HTTP serving plane for every gateway/server in the framework.

The port's copy of seaweedfs_tpu/util/httpd.py, with one difference: a
closed server joins its threads.  `server_close` of the event loop shuts
the parked and in-flight sockets down and waits for its workers, and the
thread-per-connection server joins each connection's thread
(`ConnectionThreadsMixin`), where the reference leaves daemon threads
blocked on keep-alive sockets.  The env names stay the reference's.

Two front ends behind one `make_http_server` seam:

* ``FrameworkHTTPServer`` — the thread-per-connection fallback
  (``ThreadingHTTPServer`` + a real listen backlog + TCP_NODELAY).
  A keep-alive connection pins one thread for its whole life, so
  thousands of mostly-idle sockets mean thousands of threads.

* ``EventLoopHTTPServer`` — a ``selectors`` event loop owns every
  socket while it is idle: one thread accepts, accumulates request
  headers non-blocking, and only hands a connection to a BOUNDED worker
  pool once a full request head has arrived.  The worker reuses the
  ordinary ``BaseHTTPRequestHandler`` subclass for exactly ONE request
  (body reads block only that worker), then parks the socket back on
  the loop.  Thousands of idle keep-alive connections cost a few bytes
  of buffer each instead of a thread.  ``SEAWEEDFS_TPU_EVENTLOOP``
  selects it: ``volume`` (default — the volume data port only),
  ``all`` (every surface that routes through make_http_server), or
  ``off``.

Responses from both front ends go out through ``_BufferedSocketWriter``:
``send_response``/``send_header``/body writes coalesce and reach the
kernel as ONE ``sendmsg`` (the old unbuffered wfile paid one syscall
per header block and one per body, and the header/body split is exactly
the short-write+delayed-ACK shape Nagle punishes).

``http.server``'s default listen backlog (request_queue_size) is 5 — a
burst of concurrent clients (the reference benchmark's c=16, replication
fan-out storms) overflows it and the kernel resets connections that never
reach accept().  ``SEAWEEDFS_TPU_LISTEN_BACKLOG`` tunes the shared
backlog (default 128), clamped to the kernel's somaxconn — asking for
more than somaxconn silently truncates anyway, so the clamp keeps the
configured number honest.

TCP_NODELAY is set on every accepted connection: with Nagle on, a
keep-alive request/response exchange stalls ~40ms per round trip
(Nagle x delayed-ACK interaction) — measured as a 120x small-file
throughput cliff (363 req/s -> 44k req/s at c=16x1KB on loopback).
The reference's Go net/http enables it by default.
"""

from __future__ import annotations

import os
import selectors
import socket
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

LISTEN_BACKLOG = 128

# a request head larger than this answers 431 and closes — the loop
# must never buffer unbounded header bytes for a client that never
# sends the terminating blank line
MAX_HEADER_BYTES = 64 << 10


def _somaxconn() -> int:
    try:
        with open("/proc/sys/net/core/somaxconn") as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return getattr(socket, "SOMAXCONN", LISTEN_BACKLOG)


def listen_backlog() -> int:
    """Env-tunable listen backlog, clamped to [1, somaxconn]."""
    try:
        want = int(os.environ.get(
            "SEAWEEDFS_TPU_LISTEN_BACKLOG", str(LISTEN_BACKLOG)))
    except ValueError:
        want = LISTEN_BACKLOG
    return max(1, min(want, _somaxconn()))


def eventloop_enabled(surface: str) -> bool:
    """One flag gates the front-end choice: SEAWEEDFS_TPU_EVENTLOOP =
    "volume" (default; only the volume data port), "all", or "off"."""
    mode = os.environ.get(
        "SEAWEEDFS_TPU_EVENTLOOP", "volume").strip().lower()
    if mode in ("off", "0", "none", "false", "threaded"):
        return False
    if mode == "all":
        return True
    return surface == "volume"


def make_http_server(server_address, handler_cls, surface: str):
    """The front-end seam every serve_http goes through: an event-loop
    server when the surface opted in, the threading server otherwise.
    Both expose serve_forever/shutdown/server_close/server_address."""
    if eventloop_enabled(surface):
        return EventLoopHTTPServer(server_address, handler_cls,
                                   surface=surface)
    return FrameworkHTTPServer(server_address, handler_cls)


class ConnectionThreadsMixin:
    """Thread per connection, each one joined by `server_close`.

    ThreadingMixIn's daemon threads outlive `server_close`: a keep-alive
    client pins its thread in a blocking read until it hangs up.  Here
    every connection's thread is tracked with its socket; `server_close`
    shuts the sockets down (which wakes those reads) and joins the
    threads, so a stopped server leaves no connection thread behind."""

    conn_thread_prefix = "http-conn"

    def _track_init(self) -> None:
        self._conn_lock = threading.Lock()
        self._conn_threads: dict = {}  # thread -> its connection's socket

    def process_request(self, request, client_address):
        try:
            request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # e.g. AF_UNIX test sockets
        t = threading.Thread(target=self.process_request_thread,
                             args=(request, client_address), daemon=True,
                             name=f"{self.conn_thread_prefix}-{client_address}")
        with self._conn_lock:
            self._conn_threads[t] = request
        t.start()

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self._conn_lock:
                self._conn_threads.pop(threading.current_thread(), None)

    def server_close(self):
        super().server_close()
        with self._conn_lock:
            live = list(self._conn_threads.items())
        for _t, sock in live:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t, _sock in live:
            t.join(timeout=10.0)


class FrameworkHTTPServer(ConnectionThreadsMixin, ThreadingHTTPServer):
    request_queue_size = LISTEN_BACKLOG

    def __init__(self, *args, **kwargs):
        self._track_init()
        # instance attr read by TCPServer.__init__'s listen() call
        self.request_queue_size = listen_backlog()
        super().__init__(*args, **kwargs)


def _drain_chunked(handler, cap: int) -> bool:
    """Consume a chunked request body up to `cap` payload bytes.
    -> True when fully drained (keep-alive safe), False on malformed
    framing, EOF, or overflow (caller must close the connection)."""
    total = 0
    while True:
        line = handler.rfile.readline(1024)
        if not line or not line.endswith(b"\n"):
            return False
        try:
            size = int(line.strip().split(b";")[0] or b"x", 16)
        except ValueError:
            return False
        if size == 0:
            # trailer section: lines until the terminating blank one
            while True:
                tl = handler.rfile.readline(1024)
                if tl in (b"\r\n", b"\n", b""):
                    return tl != b""
        total += size
        if total > cap:
            return False
        remaining = size + 2  # chunk bytes + trailing CRLF
        while remaining > 0:
            piece = handler.rfile.read(min(remaining, 1 << 16))
            if not piece:
                return False
            remaining -= len(piece)


def drain_request_body(handler, cap: int = 1 << 20) -> None:
    """Discard an unneeded request body in bounded chunks so the next
    request on a keep-alive connection doesn't parse leftover payload
    bytes as a request line.  Small chunked bodies are drained through
    their framing (a 100-byte chunked POST must not cost the client its
    connection); bodies over `cap` — chunked or not — close the
    connection instead of buffering gigabytes to throw away.  The one
    early-reply body-hygiene helper for every handler class."""
    te = (handler.headers.get("Transfer-Encoding") or "").lower()
    if "chunked" in te:
        if not _drain_chunked(handler, cap):
            handler.close_connection = True
        return
    try:
        length = int(handler.headers.get("Content-Length") or 0)
    except ValueError:
        length = 0
    if length > cap:
        handler.close_connection = True
        return
    while length > 0:
        chunk = handler.rfile.read(min(length, 1 << 16))
        if not chunk:
            break
        length -= len(chunk)


def shield_handler(cls, send_json_attr: str) -> None:
    """Wrap a BaseHTTPRequestHandler subclass's do_* verbs so an
    unhandled exception answers 500 (via the named send-json method)
    instead of slamming the socket shut.  The connection always closes
    after a shielded exception: if part of a response already went out,
    appending a 500 would corrupt the keep-alive stream, so the client
    must re-dial either way."""
    from . import glog

    def wrap(name: str):
        inner = getattr(cls, name)

        def safe(self):
            try:
                inner(self)
            except (BrokenPipeError, ConnectionResetError):
                raise  # the CLIENT went away; nothing to answer
            except Exception as e:  # noqa: BLE001 — boundary guard
                glog.warning("%s %s failed: %r", name[3:], self.path, e)
                try:
                    getattr(self, send_json_attr)(500, {"error": str(e)})
                except Exception:
                    pass  # headers already sent / socket gone
                self.close_connection = True

        safe.__name__ = name
        setattr(cls, name, safe)

    for name in ("do_GET", "do_HEAD", "do_POST", "do_PUT", "do_DELETE"):
        if hasattr(cls, name):
            wrap(name)


# -- single-syscall response writes ------------------------------------------


class _BufferedSocketWriter:
    """wfile replacement that coalesces the header block and body into
    ONE sendmsg per flush.  BaseHTTPRequestHandler flushes after every
    request, so a normal response costs exactly one syscall; bodies past
    the cap flush incrementally so a large GET never doubles in RAM."""

    _FLUSH_CAP = 256 << 10
    _IOV_MAX = 512  # stay far under the kernel's IOV limit

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._parts: list[bytes] = []
        self._size = 0
        self.closed = False  # socketserver's finish() checks this

    def write(self, data) -> int:
        data = bytes(data)
        if not data:
            return 0
        self._parts.append(data)
        self._size += len(data)
        # 1xx interim responses (Expect: 100-continue) must reach the
        # client NOW — it won't send the body until it sees them
        if (self._size >= self._FLUSH_CAP
                or (data[:10] in (b"HTTP/1.1 1", b"HTTP/1.0 1"))):
            self.flush()
        return len(data)

    def flush(self) -> None:
        parts, self._parts, self._size = self._parts, [], 0
        if not parts:
            return
        if len(parts) > self._IOV_MAX:
            parts = [b"".join(parts)]
        try:
            while parts:
                sent = self._sock.sendmsg(parts)
                while parts and sent >= len(parts[0]):
                    sent -= len(parts[0])
                    parts.pop(0)
                if parts and sent:
                    parts[0] = parts[0][sent:]
        except AttributeError:  # no sendmsg on this socket type
            self._sock.sendall(b"".join(parts))

    def close(self) -> None:
        self.closed = True
        try:
            self.flush()
        except OSError:
            pass  # client gone mid-flush; the socket closes right after


class BufferedResponseMixin:
    """Mixin for thread-per-connection handlers: swap the unbuffered
    makefile wfile for the coalescing writer, so even the legacy front
    end answers with a single sendmsg per response."""

    def setup(self):
        super().setup()
        self.wfile = _BufferedSocketWriter(self.connection)


# -- event-loop front end ----------------------------------------------------


class _PrefixedRFile:
    """rfile over (already-buffered header bytes + the socket).  The
    loop read the request head before dispatch; the handler re-parses it
    from this prefix, then body reads fall through to blocking recv on
    the worker.  leftover() hands unconsumed bytes (pipelined requests)
    back to the loop when the connection re-parks."""

    def __init__(self, prefix: bytes, sock: socket.socket):
        self._buf = bytearray(prefix)
        self._sock = sock
        self._eof = False

    def _more(self) -> bool:
        if self._eof:
            return False
        data = self._sock.recv(65536)  # timeout/OSError propagate
        if not data:
            self._eof = True
            return False
        self._buf += data
        return True

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            while self._more():
                pass
            out = bytes(self._buf)
            self._buf.clear()
            return out
        while len(self._buf) < n and self._more():
            pass
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def readline(self, limit: int = -1) -> bytes:
        while True:
            i = self._buf.find(b"\n")
            if i >= 0:
                end = i + 1
                if limit is not None and 0 <= limit < end:
                    end = limit
                out = bytes(self._buf[:end])
                del self._buf[:end]
                return out
            if limit is not None and 0 <= limit <= len(self._buf):
                out = bytes(self._buf[:limit])
                del self._buf[:limit]
                return out
            if not self._more():
                out = bytes(self._buf)
                self._buf.clear()
                return out

    def leftover(self) -> bytes:
        return bytes(self._buf)

    def close(self) -> None:
        pass


class _Conn:
    __slots__ = ("sock", "addr", "buf", "last")

    def __init__(self, sock, addr):
        self.sock = sock
        self.addr = addr
        self.buf = bytearray()
        self.last = time.monotonic()


class EventLoopHTTPServer:
    """selectors-based HTTP front end: idle sockets live on the loop,
    ready requests run on a bounded worker pool through the SAME
    BaseHTTPRequestHandler subclasses the threading server uses (one
    handle_one_request per dispatch), so every handler, shield, guard
    and telemetry path is shared between front ends."""

    def __init__(self, server_address, handler_cls, surface: str = "volume"):
        from ..stats.metrics import HTTPD_INFLIGHT, HTTPD_OPEN_SOCKETS

        self.RequestHandlerClass = handler_cls
        self.surface = surface
        try:
            workers = int(os.environ.get("SEAWEEDFS_TPU_LOOP_WORKERS", "32"))
        except ValueError:
            workers = 32
        self._workers = max(1, workers)
        try:
            self._request_timeout = float(os.environ.get(
                "SEAWEEDFS_TPU_LOOP_REQUEST_TIMEOUT_S", "60"))
        except ValueError:
            self._request_timeout = 60.0
        try:
            self._idle_timeout = float(os.environ.get(
                "SEAWEEDFS_TPU_LOOP_IDLE_TIMEOUT_S", "120"))
        except ValueError:
            self._idle_timeout = 120.0
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind(server_address)
        self._listen.listen(listen_backlog())
        self._listen.setblocking(False)
        self.server_address = self._listen.getsockname()
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._pool = ThreadPoolExecutor(
            max_workers=self._workers,
            thread_name_prefix=f"httpd-{surface}")
        self._rearm: deque = deque()  # conns coming back from workers
        self._shutdown_evt = threading.Event()
        self._stopped = threading.Event()
        self._conns: set[_Conn] = set()
        self._open_gauge = HTTPD_OPEN_SOCKETS.labels(surface)
        self._inflight_gauge = HTTPD_INFLIGHT.labels(surface)

    # -- loop thread ------------------------------------------------------

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        from . import glog

        self._sel.register(self._listen, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        last_sweep = time.monotonic()
        try:
            while not self._shutdown_evt.is_set():
                try:
                    events = self._sel.select(timeout=1.0)
                    for key, _mask in events:
                        tag = key.data
                        if tag == "accept":
                            self._accept()
                        elif tag == "wake":
                            self._drain_wake()
                        else:
                            self._readable(tag)
                    self._process_rearms()
                    now = time.monotonic()
                    if now - last_sweep >= 5.0:
                        self._sweep_idle(now)
                        last_sweep = now
                except OSError:
                    if self._shutdown_evt.is_set():
                        break
                    raise
                except Exception as e:  # noqa: BLE001 — loop must survive
                    glog.warning("httpd %s loop error: %r", self.surface, e)
        finally:
            self._stopped.set()

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self._listen.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            sock.setblocking(False)
            conn = _Conn(sock, addr)
            self._conns.add(conn)
            self._open_gauge.set(len(self._conns))
            try:
                self._sel.register(sock, selectors.EVENT_READ, conn)
            except (ValueError, KeyError, OSError):
                self._close_conn(conn, registered=False)

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError, OSError):
            pass

    def _readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)
            return
        conn.buf += data
        conn.last = time.monotonic()
        if b"\r\n\r\n" in conn.buf:
            self._dispatch(conn)
        elif len(conn.buf) > MAX_HEADER_BYTES:
            try:
                conn.sock.sendall(
                    b"HTTP/1.1 431 Request Header Fields Too Large\r\n"
                    b"Content-Length: 0\r\nConnection: close\r\n\r\n")
                # drain what the client already sent: closing with unread
                # bytes in the receive buffer RSTs the 431 off the wire
                for _ in range(64):
                    if not conn.sock.recv(65536):
                        break
            except OSError:
                pass
            self._close_conn(conn)

    def _dispatch(self, conn: _Conn) -> None:
        """Loop thread: full request head buffered — hand the socket to
        a worker.  The selector forgets it until the worker parks it
        back (or closes it)."""
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        conn.sock.settimeout(self._request_timeout)
        self._inflight_gauge.inc()
        self._pool.submit(self._handle, conn)

    def _handle(self, conn: _Conn) -> None:
        """Worker: run exactly ONE request through the handler class,
        then park the connection back on the loop (keep-alive) or close
        it."""
        keep = False
        rfile = None
        try:
            handler = self.RequestHandlerClass.__new__(
                self.RequestHandlerClass)
            handler.request = conn.sock
            handler.connection = conn.sock
            handler.client_address = conn.addr
            handler.server = self
            rfile = _PrefixedRFile(bytes(conn.buf), conn.sock)
            handler.rfile = rfile
            handler.wfile = _BufferedSocketWriter(conn.sock)
            handler.close_connection = True
            handler.handle_one_request()
            try:
                handler.wfile.flush()
            except OSError:
                handler.close_connection = True
            keep = not handler.close_connection
        except Exception:  # noqa: BLE001 — a broken conn never kills a worker
            keep = False
        finally:
            self._inflight_gauge.dec()
        if keep and not self._shutdown_evt.is_set():
            conn.buf = bytearray(rfile.leftover())
            conn.last = time.monotonic()
            try:
                conn.sock.setblocking(False)
            except OSError:
                keep = False
        if keep and not self._shutdown_evt.is_set():
            self._rearm.append(conn)
            self._wake()
        else:
            self._close_conn(conn, registered=False)

    def _process_rearms(self) -> None:
        while self._rearm:
            conn = self._rearm.popleft()
            if b"\r\n\r\n" in conn.buf:
                # a pipelined request is already complete: straight back
                # to a worker, no select round-trip
                conn.sock.settimeout(self._request_timeout)
                self._inflight_gauge.inc()
                self._pool.submit(self._handle, conn)
                continue
            try:
                self._sel.register(conn.sock, selectors.EVENT_READ, conn)
            except (ValueError, KeyError, OSError):
                self._close_conn(conn, registered=False)

    def _sweep_idle(self, now: float) -> None:
        if self._idle_timeout <= 0:
            return
        stale = [
            key.data for key in list(self._sel.get_map().values())
            if isinstance(key.data, _Conn)
            and now - key.data.last > self._idle_timeout
        ]
        for conn in stale:
            self._close_conn(conn)

    def _close_conn(self, conn: _Conn, registered: bool = True) -> None:
        if registered:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self._conns.discard(conn)
        self._open_gauge.set(len(self._conns))

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    # -- lifecycle (ThreadingHTTPServer-compatible surface) ---------------

    def shutdown(self) -> None:
        self._shutdown_evt.set()
        self._wake()
        self._stopped.wait(5.0)

    def server_close(self) -> None:
        self._shutdown_evt.set()
        self._wake()
        try:
            self._listen.close()
        except OSError:
            pass
        # wake workers blocked on a client's socket, let each finish its
        # one request, and join them: a closed server leaves no worker
        for conn in list(self._conns):
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._pool.shutdown(wait=True, cancel_futures=True)
        for conn in list(self._conns):
            self._close_conn(conn, registered=False)
        try:
            self._sel.close()
        except (OSError, RuntimeError):
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
