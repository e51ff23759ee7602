"""The port's HTTP serving plane (seaweedfs_tpu_torch/util/httpd.py) held
to the cases of tests/test_httpd_loop.py, each run on the reference's
module and on the port's: keep-alive parking, pipelining, chunked-body
drain, 431 for an oversized head, the idle sweep, shutdown, the backlog
clamp and front-end knobs, the single-syscall buffered writer, and the
/debug/profile lanes behind the event loop.  The port's servers also join
their threads when closed, where the reference leaves daemon threads
parked on keep-alive sockets: that is checked for both front ends.

Waits are on the servers' own state (their connection sets, the
profiler's run lock) under a deadline, never on a fixed sleep."""

from __future__ import annotations

import importlib
import json
import socket
import threading
import time
import urllib.request
import weakref
from http.server import BaseHTTPRequestHandler

import pytest

PACKAGES = ("seaweedfs_tpu", "seaweedfs_tpu_torch")


@pytest.fixture(params=PACKAGES, ids=("reference", "port"))
def pkg(request):
    return request.param


def _httpd(pkg):
    return importlib.import_module(f"{pkg}.util.httpd")


def _handler_for(pkg):
    httpd = _httpd(pkg)
    telemetry = importlib.import_module(f"{pkg}.telemetry")

    class EchoHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _reply(self, code: int, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(body)

        def do_GET(self):
            if telemetry.serve_debug_http(self, self.path.partition("?")[0]):
                return
            self._reply(200, b"path=%s" % self.path.encode())

        def do_HEAD(self):
            self._reply(200, b"path=%s" % self.path.encode())

        def do_POST(self):
            if self.path == "/drain":
                # early reply without reading the body: the hygiene helper
                # must keep the connection usable for small chunked bodies
                httpd.drain_request_body(self, cap=1 << 16)
                self._reply(200, b"drained")
                return
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length)
            self._reply(200, b"len=%d" % len(body))

    return EchoHandler


def _start(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return t


@pytest.fixture
def loop_server(pkg):
    srv = _httpd(pkg).EventLoopHTTPServer(("127.0.0.1", 0),
                                          _handler_for(pkg))
    _start(srv)
    yield srv
    srv.shutdown()
    srv.server_close()


def _connect(srv) -> socket.socket:
    s = socket.create_connection(srv.server_address, timeout=10)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


_RESP_LEFTOVER: "weakref.WeakKeyDictionary[socket.socket, bytes]" = (
    weakref.WeakKeyDictionary())


def _read_response(sock) -> tuple[int, bytes]:
    """One HTTP/1.1 response off the socket (Content-Length framing);
    bytes past its body belong to the next pipelined response."""
    buf = _RESP_LEFTOVER.pop(sock, b"")
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        assert chunk, f"connection closed mid-headers: {buf!r}"
        buf += chunk
    head, rest = buf.split(b"\r\n\r\n", 1)
    status = int(head.split(b" ", 2)[1])
    length = 0
    for line in head.split(b"\r\n")[1:]:
        k, _, v = line.partition(b":")
        if k.strip().lower() == b"content-length":
            length = int(v.strip())
    while len(rest) < length:
        chunk = sock.recv(65536)
        assert chunk, "connection closed mid-body"
        rest += chunk
    if len(rest) > length:
        _RESP_LEFTOVER[sock] = rest[length:]
    return status, rest[:length]


def _until(cond, what: str, timeout: float = 5.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"never saw {what}"
        time.sleep(0.01)


def test_keepalive_sequential_requests(loop_server):
    s = _connect(loop_server)
    try:
        for i in range(5):
            s.sendall(b"GET /r%d HTTP/1.1\r\nHost: x\r\n\r\n" % i)
            code, body = _read_response(s)
            assert code == 200 and body == b"path=/r%d" % i
    finally:
        s.close()


def test_pipelined_requests(loop_server):
    s = _connect(loop_server)
    try:
        s.sendall(
            b"GET /a HTTP/1.1\r\nHost: x\r\n\r\n"
            b"GET /b HTTP/1.1\r\nHost: x\r\n\r\n"
            b"GET /c HTTP/1.1\r\nHost: x\r\n\r\n")
        for path in (b"/a", b"/b", b"/c"):
            code, body = _read_response(s)
            assert code == 200 and body == b"path=" + path
    finally:
        s.close()


def test_post_body_and_keepalive(loop_server):
    s = _connect(loop_server)
    try:
        payload = b"z" * 5000
        s.sendall(
            b"POST /p HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: %d\r\n\r\n" % len(payload) + payload)
        code, body = _read_response(s)
        assert code == 200 and body == b"len=5000"
        s.sendall(b"GET /after HTTP/1.1\r\nHost: x\r\n\r\n")
        code, body = _read_response(s)
        assert code == 200 and body == b"path=/after"
    finally:
        s.close()


@pytest.mark.parametrize("chunks", [
    b"5\r\nhello\r\n3\r\nxyz\r\n0\r\n\r\n",
    b"4\r\nabcd\r\n0\r\nX-Trailer: 1\r\n\r\n",
], ids=("plain", "trailers"))
def test_chunked_drain_keeps_connection(loop_server, chunks):
    s = _connect(loop_server)
    try:
        s.sendall(b"POST /drain HTTP/1.1\r\nHost: x\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n" + chunks)
        code, body = _read_response(s)
        assert code == 200 and body == b"drained"
        # the framing was fully consumed: the next request parses clean
        s.sendall(b"GET /next HTTP/1.1\r\nHost: x\r\n\r\n")
        code, body = _read_response(s)
        assert code == 200 and body == b"path=/next"
    finally:
        s.close()


def test_oversized_header_431(loop_server):
    s = _connect(loop_server)
    try:
        s.sendall(b"GET / HTTP/1.1\r\nHost: x\r\nX-Big: ")
        s.sendall(b"a" * (70 << 10))  # past MAX_HEADER_BYTES, no blank line
        code, _body = _read_response(s)
        assert code == 431
        s.settimeout(5)
        assert s.recv(1024) == b""  # and the loop closed the connection
    finally:
        s.close()


def test_many_idle_sockets_stay_off_threads(loop_server):
    """Idle keep-alive connections cost loop buffers, not worker threads:
    an active request still answers while 200 sockets sit parked."""
    idle = []
    try:
        for _ in range(200):
            idle.append(_connect(loop_server))
        _until(lambda: len(loop_server._conns) >= 200, "200 parked sockets")
        assert loop_server._workers < 200
        s = _connect(loop_server)
        try:
            s.sendall(b"GET /live HTTP/1.1\r\nHost: x\r\n\r\n")
            code, body = _read_response(s)
            assert code == 200 and body == b"path=/live"
        finally:
            s.close()
        assert loop_server._open_gauge.value >= 200
    finally:
        for s in idle:
            s.close()


def test_concurrent_clients(loop_server):
    errs = []

    def worker(i):
        try:
            s = _connect(loop_server)
            try:
                for k in range(3):
                    s.sendall(b"GET /c%d-%d HTTP/1.1\r\nHost: x\r\n\r\n"
                              % (i, k))
                    code, body = _read_response(s)
                    assert code == 200
                    assert body == b"path=/c%d-%d" % (i, k)
            finally:
                s.close()
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errs, errs


def test_connection_close_honored(loop_server):
    s = _connect(loop_server)
    try:
        s.sendall(b"GET /bye HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
        code, body = _read_response(s)
        assert code == 200 and body == b"path=/bye"
        s.settimeout(5)
        assert s.recv(1024) == b""
    finally:
        s.close()


def test_idle_sweep_closes_stale_conns(pkg, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_LOOP_IDLE_TIMEOUT_S", "1")
    srv = _httpd(pkg).EventLoopHTTPServer(("127.0.0.1", 0),
                                          _handler_for(pkg))
    _start(srv)
    try:
        s = _connect(srv)
        _until(lambda: srv._conns, "the parked socket")
        # an immediate sweep rather than the 5 s cadence
        srv._sweep_idle(time.monotonic() + 10)
        s.settimeout(5)
        assert s.recv(1024) == b""
        s.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_shutdown_unblocks_and_closes(loop_server):
    s = _connect(loop_server)
    s.sendall(b"GET /x HTTP/1.1\r\nHost: x\r\n\r\n")
    code, _ = _read_response(s)
    assert code == 200
    loop_server.shutdown()
    assert loop_server._stopped.is_set()
    s.close()


def test_listen_backlog_env_clamp(pkg, monkeypatch):
    httpd = _httpd(pkg)
    monkeypatch.setenv("SEAWEEDFS_TPU_LISTEN_BACKLOG", "64")
    assert httpd.listen_backlog() == 64
    monkeypatch.setenv("SEAWEEDFS_TPU_LISTEN_BACKLOG", "0")
    assert httpd.listen_backlog() == 1  # floor
    monkeypatch.setenv("SEAWEEDFS_TPU_LISTEN_BACKLOG", "10000000")
    assert httpd.listen_backlog() == httpd._somaxconn()  # ceiling
    monkeypatch.setenv("SEAWEEDFS_TPU_LISTEN_BACKLOG", "garbage")
    assert httpd.listen_backlog() == 128  # default on parse failure


def test_eventloop_enabled_modes(pkg, monkeypatch):
    httpd = _httpd(pkg)
    monkeypatch.delenv("SEAWEEDFS_TPU_EVENTLOOP", raising=False)
    assert httpd.eventloop_enabled("volume") is True  # default: volume only
    assert httpd.eventloop_enabled("filer") is False
    monkeypatch.setenv("SEAWEEDFS_TPU_EVENTLOOP", "all")
    assert httpd.eventloop_enabled("filer") is True
    monkeypatch.setenv("SEAWEEDFS_TPU_EVENTLOOP", "off")
    assert httpd.eventloop_enabled("volume") is False


def test_make_http_server_seam(pkg, monkeypatch):
    httpd = _httpd(pkg)
    handler = _handler_for(pkg)
    for mode, surface, loop in (("off", "volume", False),
                                ("volume", "volume", True),
                                ("volume", "filer", False)):
        monkeypatch.setenv("SEAWEEDFS_TPU_EVENTLOOP", mode)
        srv = httpd.make_http_server(("127.0.0.1", 0), handler,
                                     surface=surface)
        assert isinstance(srv, httpd.EventLoopHTTPServer) is loop
        srv.server_close()


class _CountingSock:
    """sendmsg-counting socket stand-in for the coalescing writer."""

    def __init__(self, take: int | None = None):
        self.calls = 0
        self.data = b""
        self.take = take

    def sendmsg(self, parts):
        self.calls += 1
        blob = b"".join(bytes(p) for p in parts)
        n = len(blob) if self.take is None else min(self.take, len(blob))
        self.data += blob[:n]
        return n


def test_buffered_writer_single_syscall(pkg):
    sock = _CountingSock()
    w = _httpd(pkg)._BufferedSocketWriter(sock)
    for part in (b"HTTP/1.1 200 OK\r\n", b"Content-Length: 5\r\n", b"\r\n",
                 b"hello"):
        w.write(part)
    assert sock.calls == 0  # nothing reaches the kernel before flush
    w.flush()
    assert sock.calls == 1  # the header block and body in ONE sendmsg
    assert sock.data == (
        b"HTTP/1.1 200 OK\r\nContent-Length: 5\r\n\r\nhello")


def test_buffered_writer_interim_response_flushes_now(pkg):
    sock = _CountingSock()
    w = _httpd(pkg)._BufferedSocketWriter(sock)
    w.write(b"HTTP/1.1 100 Continue\r\n\r\n")
    assert sock.calls == 1 and b"100 Continue" in sock.data


def test_buffered_writer_partial_sends(pkg):
    sock = _CountingSock(take=3)
    w = _httpd(pkg)._BufferedSocketWriter(sock)
    w.write(b"abcdefghij")
    w.flush()
    assert sock.data == b"abcdefghij"


def test_volume_surface_runs_on_event_loop(pkg, monkeypatch):
    """The default wiring: the volume surface gets an EventLoopHTTPServer,
    and a request answers over it."""
    monkeypatch.delenv("SEAWEEDFS_TPU_EVENTLOOP", raising=False)
    httpd = _httpd(pkg)
    srv = httpd.make_http_server(("127.0.0.1", 0), _handler_for(pkg),
                                 surface="volume")
    assert isinstance(srv, httpd.EventLoopHTTPServer)
    _start(srv)
    try:
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/status" % srv.server_address[1],
                timeout=10) as r:
            assert r.status == 200 and r.read() == b"path=/status"
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("mode", ["volume", "off"], ids=("loop", "threaded"))
def test_port_server_close_joins_its_threads(monkeypatch, mode):
    """The port's difference: after shutdown + server_close, neither the
    event loop's workers nor the threaded front end's connection threads
    are alive, although a client still holds a keep-alive connection."""
    from seaweedfs_tpu_torch.util import httpd

    monkeypatch.setenv("SEAWEEDFS_TPU_EVENTLOOP", mode)
    before = set(threading.enumerate())
    srv = httpd.make_http_server(("127.0.0.1", 0),
                                 _handler_for("seaweedfs_tpu_torch"),
                                 surface="volume")
    loop = _start(srv)
    s = _connect(srv)
    try:
        for i in range(3):
            s.sendall(b"GET /k%d HTTP/1.1\r\nHost: x\r\n\r\n" % i)
            assert _read_response(s) == (200, b"path=/k%d" % i)
        srv.shutdown()
        srv.server_close()
        loop.join(10)
        assert not loop.is_alive()
        # the front end's own threads: the loop's workers, the threaded
        # server's connection threads
        left = [t.name for t in set(threading.enumerate()) - before
                if t.is_alive() and t.name.startswith(("httpd-",
                                                       "http-conn"))]
        assert not left, left
        s.settimeout(5)
        assert s.recv(1024) == b""  # the server hung up
    finally:
        s.close()


# -- /debug/profile behind the event loop ------------------------------------


def _get(srv, path: str) -> tuple[int, bytes]:
    s = _connect(srv)
    try:
        s.sendall(b"GET %s HTTP/1.1\r\nHost: x\r\n\r\n" % path.encode())
        return _read_response(s)
    finally:
        s.close()


def test_debug_profile_single_flight_409(loop_server, pkg):
    profiler = importlib.import_module(f"{pkg}.util.profiler")
    results = {}

    def long_run():
        results["first"] = _get(loop_server,
                                "/debug/profile?seconds=1.5&hz=20")

    t = threading.Thread(target=long_run)
    t.start()
    _until(profiler._RUN_LOCK.locked, "the profile run holding its lock")
    code, body = _get(loop_server, "/debug/profile?seconds=1&hz=20")
    assert code == 409 and b"already in progress" in body
    t.join(timeout=10)
    assert results["first"][0] == 200  # the in-flight run is unharmed


def test_debug_profile_bad_params_400(loop_server):
    for q in ("seconds=0", "seconds=999", "hz=0", "hz=100000",
              "seconds=nan&hz=banana"):
        code, _ = _get(loop_server, "/debug/profile?" + q)
        assert code == 400, q


def test_debug_profile_kill_switch_403(loop_server, monkeypatch):
    monkeypatch.setenv("SEAWEEDFS_TPU_PROFILER_DISABLED", "1")
    code, body = _get(loop_server, "/debug/profile?seconds=1")
    assert code == 403 and b"disabled" in body
    code, _ = _get(loop_server, "/debug/profile/history")
    assert code == 403
    # the cheap status stub stays open with the sampler closed
    code, body = _get(loop_server, "/debug/profile?status=1")
    assert code == 200 and "max_rss_kb" in json.loads(body)


def test_debug_profile_history_ring_rotation(pkg, monkeypatch):
    """The continuous sampler's ring rotates windows, the oldest evicted
    once `retain` is exceeded."""
    profiler = importlib.import_module(f"{pkg}.util.profiler")
    monkeypatch.setenv(profiler.CONTINUOUS_HZ_VAR, "40")
    monkeypatch.setenv(profiler.CONTINUOUS_WINDOW_VAR, "0.1")
    monkeypatch.setenv(profiler.CONTINUOUS_RETAIN_VAR, "3")
    cp = profiler.ContinuousProfiler()
    cp.start()
    try:
        _until(lambda: len(cp.history()["windows"]) >= 3, "3 windows", 10)
        first_seen = cp.history()["windows"][0]["start"]
        _until(lambda: cp.history()["windows"][0]["start"] != first_seen,
               "the ring rotating", 10)
        doc = cp.history()
        complete = [w for w in doc["windows"] if not w.get("partial")]
        assert len(complete) <= 3
        assert doc["running"] is True
        sampled = [w for w in complete if w["samples"]]
        assert sampled and "collapsed" in sampled[0]
    finally:
        cp.stop()
    assert cp.history()["running"] is False


def test_each_package_keeps_its_own_profiler_and_registry():
    """Process-global state is per package: the port's continuous sampler,
    run lock and metric registry are not the reference's."""
    from seaweedfs_tpu.stats import metrics as ref_metrics
    from seaweedfs_tpu.util import profiler as ref_profiler
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.util import profiler

    assert profiler._RUN_LOCK is not ref_profiler._RUN_LOCK
    assert metrics.REGISTRY is not ref_metrics.REGISTRY
    port_families = set(metrics.REGISTRY._metrics)
    assert "seaweedfs_httpd_inflight_requests" in port_families
    # the families of planes the port leaves out (the filer fleet and
    # geo, ROADMAP A-7) are the reference's only
    assert "seaweedfs_geo_lag_seconds" in ref_metrics.REGISTRY._metrics
    assert "seaweedfs_geo_lag_seconds" not in port_families
