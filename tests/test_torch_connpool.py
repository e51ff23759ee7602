"""The port's keep-alive connection pool (seaweedfs_tpu_torch/util/connpool.py)
held to the pool cases of tests/test_hotpath.py, each run on the
reference's module and on the port's: one socket for sequential requests,
POST bodies on a kept socket, one replay of a stale pooled socket, no
retry on a fresh connection's error, HTTPError like urlopen's, and the
idle bound.  The pool is per package: the port's replica fan-out never
shares a socket with the reference's."""

from __future__ import annotations

import http.server
import importlib
import json
import threading
import urllib.error

import pytest

from helpers import free_port


@pytest.fixture(params=("seaweedfs_tpu", "seaweedfs_tpu_torch"),
                ids=("reference", "port"))
def connpool(request):
    return importlib.import_module(f"{request.param}.util.connpool")


class _CountingHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def setup(self):
        super().setup()
        self.server.conn_count += 1
        self.server.live_socks.append(self.connection)

    def log_message(self, fmt, *args):
        pass

    def do_GET(self):
        body = json.dumps({"path": self.path}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        payload = self.rfile.read(length)
        body = json.dumps({"echo_len": len(payload)}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _NotFound(_CountingHandler):
    def do_GET(self):
        body = b'{"error": "nope"}'
        self.send_response(404)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _counting_server(port: int, handler=_CountingHandler):
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), handler)
    httpd.conn_count = 0
    httpd.live_socks = []
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _stop_server(httpd):
    httpd.shutdown()
    httpd.server_close()
    for sock in httpd.live_socks:  # kill keep-alive conns, not just accept
        try:
            sock.shutdown(2)
            sock.close()
        except OSError:
            pass


@pytest.fixture
def served():
    """A counting server on a test-band port, stopped after the test (a
    test may replace it: the fixture stops whichever is current)."""
    box = {"port": free_port()}
    box["httpd"] = _counting_server(box["port"])
    yield box
    _stop_server(box["httpd"])


def test_pool_reuses_one_socket_for_sequential_requests(connpool, served):
    port = served["port"]
    pool = connpool.ConnectionPool()
    try:
        for i in range(5):
            with pool.request("GET", f"http://127.0.0.1:{port}/r{i}") as r:
                assert r.status == 200
                assert json.loads(r.read())["path"] == f"/r{i}"
        # five sequential requests, ONE accepted TCP connection
        assert served["httpd"].conn_count == 1
        assert pool.idle_count("127.0.0.1", port) == 1
    finally:
        pool.close_all()


def test_pool_interleaves_posts_and_bodies(connpool, served):
    port = served["port"]
    pool = connpool.ConnectionPool()
    try:
        for size in (0, 1, 4096):
            with pool.request("POST", f"http://127.0.0.1:{port}/w",
                              body=b"x" * size) as r:
                assert json.loads(r.read())["echo_len"] == size
        assert served["httpd"].conn_count == 1
    finally:
        pool.close_all()


def test_pool_retries_stale_socket_once(connpool, served):
    """A pooled keep-alive socket whose peer restarted is replayed once on
    a fresh dial instead of failing the request."""
    port = served["port"]
    pool = connpool.ConnectionPool()
    try:
        with pool.request("GET", f"http://127.0.0.1:{port}/warm") as r:
            r.read()
        assert pool.idle_count("127.0.0.1", port) == 1
        # the peer goes away and comes back: the pooled socket is now dead
        _stop_server(served["httpd"])
        served["httpd"] = _counting_server(port)
        with pool.request("GET", f"http://127.0.0.1:{port}/again") as r:
            assert r.status == 200
            r.read()
        assert served["httpd"].conn_count == 1  # the retry dialed anew
    finally:
        pool.close_all()


def test_pool_fails_fast_on_fresh_connection_errors(connpool):
    """Errors on a never-used connection are NOT retried by the pool."""
    pool = connpool.ConnectionPool()
    with pytest.raises(OSError):
        pool.request("GET", f"http://127.0.0.1:{free_port()}/x", timeout=2)


def test_pool_raises_httperror_like_urlopen(connpool):
    port = free_port()
    httpd = _counting_server(port, _NotFound)
    pool = connpool.ConnectionPool()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            pool.request("GET", f"http://127.0.0.1:{port}/missing")
        assert ei.value.code == 404
        assert b"nope" in ei.value.read()
        # the error response was drained: the socket is reusable
        assert pool.idle_count("127.0.0.1", port) == 1
    finally:
        pool.close_all()
        _stop_server(httpd)


def test_pool_bounds_idle_connections(connpool, served):
    port = served["port"]
    pool = connpool.ConnectionPool(max_idle_per_host=2)
    try:
        # three conns held concurrently, all released: only two kept
        rs = [pool.request("GET", f"http://127.0.0.1:{port}/c{i}")
              for i in range(3)]
        for r in rs:
            r.read()
        assert served["httpd"].conn_count == 3
        assert pool.idle_count("127.0.0.1", port) == 2
    finally:
        pool.close_all()


def test_pool_metrics_land_in_each_packages_registry(served):
    """A request through the port's pool counts in the port's registry
    and not in the reference's."""
    from seaweedfs_tpu.stats import metrics as ref_metrics
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.util import connpool

    port = served["port"]
    dial, ref_dial = (metrics.CONNPOOL_DIAL.labels(),
                      ref_metrics.CONNPOOL_DIAL.labels())
    before = (dial.value, ref_dial.value)
    pool = connpool.ConnectionPool()
    try:
        with pool.request("GET", f"http://127.0.0.1:{port}/m") as r:
            r.read()
    finally:
        pool.close_all()
    assert (dial.value - before[0], ref_dial.value - before[1]) == (1, 0)
    assert connpool.POOL is not importlib.import_module(
        "seaweedfs_tpu.util.connpool").POOL
