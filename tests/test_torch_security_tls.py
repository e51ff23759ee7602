"""gRPC mTLS and scaffold of the port, held against the reference
(tests/test_security_tls.py): certificates from either package's
`generate_dev_certs` load in both; a port master and volume server serve
under mTLS to the reference's client and a reference master and volume
server to the port's; a client without a certificate is refused; the
port refuses a certificate set that is incomplete or does not load; and
`scaffold`'s text is the reference's byte for byte for every -config."""

from __future__ import annotations

import time
from concurrent import futures

import grpc
import pytest
from helpers import free_port

from seaweedfs_tpu.pb import master_pb2 as ref_master_pb2
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vs_pb2
from seaweedfs_tpu.security import tls as ref_tls
from seaweedfs_tpu.util.config import Configuration as RefConfiguration
from seaweedfs_tpu.util.scaffold import scaffold as ref_scaffold
from seaweedfs_tpu_torch.pb import master_pb2, volume_server_pb2
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.security import tls
from seaweedfs_tpu_torch.util.config import Configuration
from seaweedfs_tpu_torch.util.scaffold import scaffold

pytest.importorskip("cryptography",
                    reason="generate_dev_certs needs cryptography")

COMPONENTS = ("master", "volume", "client")


@pytest.fixture()
def plaintext():
    """Both packages' gRPC substrate back to plaintext after each test."""
    yield
    rpc.configure_security(None, None)
    ref_rpc.configure_security(None, None)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """A certificate set from each package's generate_dev_certs."""
    return {"port": tls.generate_dev_certs(
                str(tmp_path_factory.mktemp("port_certs")), COMPONENTS),
            "ref": ref_tls.generate_dev_certs(
                str(tmp_path_factory.mktemp("ref_certs")), COMPONENTS)}


def _conf(cls, certs: dict, component: str):
    return cls({"grpc": {"ca": certs["ca"][0],
                         component: {"cert": certs[component][0],
                                     "key": certs[component][1]}}},
               path="<test>")


@pytest.mark.parametrize("maker", ["port", "ref"])
def test_dev_certs_load_in_both_packages(certs, maker):
    for component in COMPONENTS:
        for loader, cls in ((tls, Configuration), (ref_tls, RefConfiguration)):
            conf = _conf(cls, certs[maker], component)
            assert loader.load_server_credentials(conf, component) is not None
            assert loader.load_client_credentials(conf, component) is not None
    assert tls.load_server_credentials(Configuration({}, path=""),
                                       "master") is None


def _wait_nodes(count_fn, want: int) -> None:
    deadline = time.time() + 15
    while time.time() < deadline and count_fn() < want:
        time.sleep(0.1)
    assert count_fn() == want, "the volume server's heartbeat over mTLS"


def test_port_servers_under_mtls_serve_the_reference_client(
        tmp_path, certs, plaintext):
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.volume.server import VolumeServer

    c = certs["port"]
    rpc.configure_security(
        tls.load_server_credentials(_conf(Configuration, c, "master"),
                                    "master"),
        tls.load_client_credentials(_conf(Configuration, c, "volume"),
                                    "volume"))
    ref_rpc.configure_security(None, ref_tls.load_client_credentials(
        _conf(RefConfiguration, c, "client"), "client"))
    master = MasterServer(ip="127.0.0.1", port=free_port(),
                          volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer([str(tmp_path / "v")],
                      [f"127.0.0.1:{master.grpc_port}"], ip="127.0.0.1",
                      port=free_port(), codec_name="cpu", pulse_seconds=0.5)
    vs.start()
    try:
        _wait_nodes(lambda: len(master.topo.nodes), 1)
        resp = ref_rpc.master_stub(f"127.0.0.1:{master.grpc_port}",
                                   timeout=10).Assign(
            ref_master_pb2.AssignRequest(count=1))
        assert resp.fid and not resp.error
        status = ref_rpc.volume_server_stub(
            f"127.0.0.1:{vs.grpc_port}", timeout=10).VolumeServerStatus(
            ref_vs_pb2.VolumeServerStatusRequest())
        assert status.disk_statuses
    finally:
        vs.stop()
        master.stop()


def test_reference_servers_under_mtls_serve_the_port_client(
        tmp_path, certs, plaintext):
    from seaweedfs_tpu.master.server import MasterServer
    from seaweedfs_tpu.volume.server import VolumeServer

    c = certs["ref"]
    ref_rpc.configure_security(
        ref_tls.load_server_credentials(
            _conf(RefConfiguration, c, "master"), "master"),
        ref_tls.load_client_credentials(
            _conf(RefConfiguration, c, "volume"), "volume"))
    rpc.configure_security(None, tls.load_client_credentials(
        _conf(Configuration, c, "client"), "client"))
    master = MasterServer(ip="127.0.0.1", port=free_port(),
                          volume_size_limit_mb=64)
    master.start()
    vs = VolumeServer(directories=[str(tmp_path / "v")],
                      master_addresses=[f"127.0.0.1:{master.grpc_port}"],
                      ip="127.0.0.1", port=free_port(), pulse_seconds=0.5)
    vs.start()
    try:
        _wait_nodes(lambda: len(master.topo.nodes), 1)
        resp = rpc.master_stub(f"127.0.0.1:{master.grpc_port}",
                               timeout=10).Assign(
            master_pb2.AssignRequest(count=1))
        assert resp.fid and not resp.error
        status = rpc.volume_server_stub(
            f"127.0.0.1:{vs.grpc_port}", timeout=10).VolumeServerStatus(
            volume_server_pb2.VolumeServerStatusRequest())
        assert status.disk_statuses
    finally:
        vs.stop()
        master.stop()


def _volume_list(channel) -> None:
    channel.unary_unary(
        "/master_pb.Seaweed/VolumeList",
        request_serializer=master_pb2.VolumeListRequest.SerializeToString,
        response_deserializer=master_pb2.VolumeListResponse.FromString,
    )(master_pb2.VolumeListRequest(), timeout=5)


@pytest.mark.parametrize("client", ["plaintext", "tls_without_cert",
                                    "certified"])
def test_mtls_rejects_unauthenticated_client(certs, plaintext, client):
    """The port's serve() under mTLS: a plaintext dial and a TLS dial
    without a client certificate fail, a certified one is answered."""
    c = certs["port"]
    rpc.configure_security(tls.load_server_credentials(
        _conf(Configuration, c, "master"), "master"), None)

    class Master:
        def VolumeList(self, request, context):
            return master_pb2.VolumeListResponse(volume_size_limit_mb=7)

    port = free_port()
    server = rpc.serve([(rpc.MASTER, Master())], port, host="127.0.0.1",
                       max_workers=2)
    with open(c["ca"][0], "rb") as f:
        ca = f.read()
    if client == "plaintext":
        ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    elif client == "tls_without_cert":
        ch = grpc.secure_channel(f"127.0.0.1:{port}",
                                 grpc.ssl_channel_credentials(ca))
    else:
        ch = grpc.secure_channel(
            f"127.0.0.1:{port}", tls.load_client_credentials(
                _conf(Configuration, c, "client"), "client"))
    try:
        if client == "certified":
            _volume_list(ch)
        else:
            with pytest.raises(grpc.RpcError):
                _volume_list(ch)
    finally:
        ch.close()
        server.stop(0).wait()
        server.pool.shutdown(wait=True)


def test_incomplete_or_unloadable_certificates_raise(tmp_path, certs):
    """The port's deliberate difference: a named but incomplete set, a
    missing file or a key that is not its certificate's raise ValueError
    (the reference returns None for the first, plaintext, and defers the
    others to the first handshake)."""
    c = certs["port"]
    partial = Configuration({"grpc": {"master": {
        "cert": c["master"][0], "key": c["master"][1]}}}, path="<test>")
    assert ref_tls.load_server_credentials(
        RefConfiguration(partial.data, path="<test>"), "master") is None
    with pytest.raises(ValueError, match="no ca"):
        tls.load_server_credentials(partial, "master")
    missing = Configuration({"grpc": {"ca": str(tmp_path / "nope.crt"),
                                      "master": {"cert": c["master"][0],
                                                 "key": c["master"][1]}}},
                            path="<test>")
    with pytest.raises(ValueError, match="cannot load"):
        tls.load_server_credentials(missing, "master")
    swapped = Configuration({"grpc": {"ca": c["ca"][0], "master": {
        "cert": c["master"][0], "key": c["volume"][1]}}}, path="<test>")
    with pytest.raises(ValueError, match="cannot load"):
        tls.load_client_credentials(swapped, "master")
    bare = Configuration({"master": {"cert": c["master"][0],
                                     "key": c["master"][1]},
                          "grpc": {"ca": c["ca"][0]}}, path="<test>")
    assert tls.load_server_credentials(bare, "master") is not None


@pytest.mark.parametrize("config", ["security", "master", "filer",
                                    "notification", "replication", "shell"])
def test_scaffold_is_the_references_byte_for_byte(config):
    assert scaffold(config) == ref_scaffold(config)
    assert scaffold(config).encode() == ref_scaffold(config).encode()
