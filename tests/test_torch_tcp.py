"""The port's raw-TCP needle path (seaweedfs_tpu_torch/volume/tcp_handlers.py)
against the reference's: a reference VolumeServer (`cpu`) and a port one
(`torch_cpu`), each with a `tcp_port`, get the same seeded frames — puts,
gets, deletes, gets of deleted and missing needles, a wrong cookie, a bad
fid, an unknown command, and writes refused on a server that requires
write JWTs — and must answer byte for byte alike.  The port's server
joins its TCP threads when it stops, a client connection still open."""

from __future__ import annotations

import os
import socket
import struct
import sys
import threading

import numpy as np
import pytest

from helpers import free_port
from seaweedfs_tpu.volume.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs
from seaweedfs_tpu_torch.volume.server import VolumeServer
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

VID = 4


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    master = chip_smoke.MiniMaster(rpc, master_pb2, free_port() + 10000)
    out = {}
    try:
        for kind, cls, kw in (("reference", RefVolumeServer, {}),
                              ("port", VolumeServer,
                               {"codec_name": "torch_cpu"})):
            srv = cls([str(tmp_path_factory.mktemp(kind))], [master.address],
                      ip="127.0.0.1", port=free_port(), tcp_port=free_port(),
                      pulse_seconds=1.0, **kw)
            srv.start()
            out[kind] = srv
            rpc.volume_server_stub(f"127.0.0.1:{srv.grpc_port}",
                                   timeout=30).AllocateVolume(
                vs.AllocateVolumeRequest(volume_id=VID))
        yield out
    finally:
        for srv in out.values():
            srv.stop()
        master.stop()


class _Client:
    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        self.rf = self.sock.makefile("rb")

    def cmd(self, line: bytes, payload: bytes | None = None) -> bytes:
        frame = line + b"\n"
        if payload is not None:
            frame += struct.pack(">I", len(payload)) + payload
        self.sock.sendall(frame)
        head = self.rf.readline()
        if line.startswith(b"?") and head.startswith(b"+OK "):
            return head + self.rf.read(int(head[4:]))
        return head

    def close(self) -> None:
        self.rf.close()
        self.sock.close()


def _script(seed: int) -> list[tuple[bytes, bytes | None]]:
    """The seeded frames every server gets: 64 puts (1 B..64 KiB), gets of
    each, 16 deletes, gets of the deleted, and malformed commands."""
    rng = np.random.default_rng(seed)
    fids = []
    frames: list[tuple[bytes, bytes | None]] = []
    for key in range(1, 65):
        cookie = int(rng.integers(0, 2**32))
        fid = f"{VID},{key:x}{cookie:08x}"
        fids.append((fid, key, cookie))
        size = int(rng.integers(1, 1 << 16))
        frames.append((b"+" + fid.encode(),
                       rng.integers(0, 256, size).astype(np.uint8).tobytes()))
    frames += [(b"?" + f.encode(), None) for f, _k, _c in fids]
    gone = sorted(rng.choice(64, 16, replace=False).tolist())
    for i in gone:
        fid, key, cookie = fids[i]
        bad = f"{VID},{key:x}{cookie ^ 1:08x}"
        frames.append((b"-" + bad.encode(), None))  # cookie mismatch
        frames.append((b"-" + fid.encode(), None))
        frames.append((b"?" + fid.encode(), None))
    frames += [(b"?" + f"{VID},{999:x}{0:08x}".encode(), None),  # missing
               (b"?" + f"{VID + 1},{1:x}{0:08x}".encode(), None),  # no vol
               (b"?notafid", None), (b"zwhat", None), (b"!", None),
               (b"+notafid", b"xyz")]  # the frame is consumed all the same
    live = next(i for i in range(64) if i not in gone)
    frames.append((b"?" + fids[live][0].encode(), None))  # still framed
    return frames


def _run(srv, frames) -> list[bytes]:
    c = _Client(srv.tcp_port)
    try:
        out = []
        for line, payload in frames:
            if line == b"!":  # flush: no answer line
                c.sock.sendall(b"!\n")
                continue
            out.append(c.cmd(line, payload))
        return out
    finally:
        c.close()


def test_tcp_frames_answer_as_the_reference(servers):
    frames = _script(seed=7)
    ref = _run(servers["reference"], frames)
    port = _run(servers["port"], frames)
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, (i, frames[i][0], a[:80], b[:80])
    puts = sum(1 for line, _ in frames if line.startswith(b"+"))
    assert port[:puts - 1].count(b"+OK\n") == puts - 1
    # every get of a stored needle returned its exact payload
    payloads = {line[1:]: p for line, p in frames if line.startswith(b"+")}
    for (line, _), got in zip(frames[64:128], port[64:128]):
        want = payloads[line[1:]]
        assert got == b"+OK %d\n" % len(want) + want


def test_tcp_writes_refused_when_jwts_are_required(servers):
    frames = [(b"+" + f"{VID},{5000:x}{7:08x}".encode(), b"payload"),
              (b"-" + f"{VID},{1:x}{0:08x}".encode(), None)]
    answers = {}
    for kind, srv in servers.items():
        srv.jwt_signing_key = b"cluster-key"
        try:
            answers[kind] = _run(srv, frames)
        finally:
            srv.jwt_signing_key = b""
    assert answers["port"] == answers["reference"]
    assert all(a.startswith(b"-ERR") and b"jwt" in a for a in answers["port"])


def test_port_tcp_server_stops_with_no_thread_left(tmp_path):
    master = chip_smoke.MiniMaster(rpc, master_pb2, free_port() + 10000)
    try:
        srv = VolumeServer([str(tmp_path)], [master.address], ip="127.0.0.1",
                           port=free_port(), tcp_port=free_port(),
                           codec_name="torch_cpu", pulse_seconds=1.0)
        srv.start()
        c = _Client(srv.tcp_port)
        try:
            assert c.cmd(b"zwhat").startswith(b"-ERR")
            conn = [t for t in threading.enumerate()
                    if t.name.startswith("volume-tcp-conn")]
            assert conn  # a thread serves the open connection
            srv.stop()
            assert not any(t.is_alive() for t in conn)
            assert not srv._tcpd.serve_thread.is_alive()
            assert c.rf.readline() == b""  # the server hung up
        finally:
            c.close()
    finally:
        master.stop()
