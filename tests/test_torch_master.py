"""The port's master held against the reference's: both get the same
heartbeat streams over gRPC, and Assign, LookupVolume, LookupEcVolume,
VolumeList, Statistics, the heartbeat acks and the HTTP API (/dir/assign,
/dir/lookup, /dir/status, /vol/status) answer equal, each master's own
address replaced by a name, fid keys compared by format and order (the
cookie is random in both).  Then the packages cross-wired: port volume
servers register with the reference master and reference volume servers
with the port's.  Last, the geo registry the port leaves out answers 501
or ValueError, the SLO, canary, flight-recorder, federation and quorum
surfaces and the maintenance plane's (/cluster/lifecycle, the Lifecycle
rpc, /vol/repair's massRepair) answer as the reference's, and stop()
leaves no thread of the master's, a quorum member's included.
"""

import json
import os
import queue
import re
import threading
import time
import urllib.error
import urllib.request

import grpc
import pytest
from helpers import free_port

from seaweedfs_tpu.master.server import MasterServer as RefMaster
from seaweedfs_tpu.pb import master_pb2 as ref_pb
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu_torch.master.server import MasterServer as PortMaster
from seaweedfs_tpu_torch.pb import master_pb2 as port_pb
from seaweedfs_tpu_torch.pb import rpc as port_rpc

PKG = {"ref": (RefMaster, ref_pb, ref_rpc),
       "port": (PortMaster, port_pb, port_rpc)}
DEADLINE_S = 20.0


def _http(url: str, method: str = "GET", data: bytes | None = None):
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait(cond, what: str, timeout: float = DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"{what}: not within {timeout} s")


class _HeartbeatStream:
    """One volume server's SendHeartbeat stream, driven beat by beat: each
    send() waits for the master's ack of that beat."""

    def __init__(self, rpc, address: str):
        self.q: queue.Queue = queue.Queue()
        self.acks: list = []

        def beats():
            while True:
                hb = self.q.get()
                if hb is None:
                    return
                yield hb

        self.call = rpc.master_stub(address).SendHeartbeat(beats())
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        try:
            for ack in self.call:
                self.acks.append(ack)
        except grpc.RpcError:
            pass

    def send(self, hb):
        n = len(self.acks)
        self.q.put(hb)
        _wait(lambda: len(self.acks) > n, "heartbeat ack")
        return self.acks[-1]

    def close(self):
        self.q.put(None)
        self.call.cancel()
        self.reader.join(timeout=10)


def _beats() -> list[tuple[str, dict]]:
    """Two nodes' full beats, then an incremental one: volumes of three
    layouts (writable, read-only, replicated), EC shards of volume 9."""
    def vol(vid, **kw):
        return {"id": vid, "size": 1000 * vid, "file_count": vid,
                "version": 3, **kw}
    return [
        ("n1", {"ip": "10.9.0.1", "port": 8080, "public_url": "pub1:8080",
                "max_volume_counts": {"": 8}, "max_file_key": 41,
                "data_center": "dc1", "rack": "r1",
                "volumes": [vol(1), vol(2, read_only=True),
                            vol(3, collection="pics", replica_placement=1)],
                "ec_shards": [{"id": 9, "collection": "ec",
                               "ec_index_bits": 0b00000000111111}]}),
        ("n2", {"ip": "10.9.0.2", "port": 8081, "public_url": "pub2:8081",
                "max_volume_counts": {"": 5}, "max_file_key": 7,
                "data_center": "dc1", "rack": "r2",
                "volumes": [vol(3, collection="pics", replica_placement=1),
                            vol(4)],
                "ec_shards": [{"id": 9, "collection": "ec",
                               "ec_index_bits": 0b11111111000000}]}),
        ("n2", {"ip": "10.9.0.2", "port": 8081,
                "new_volumes": [{"id": 5, "collection": "",
                                 "replica_placement": 0, "version": 3}],
                "deleted_ec_shards": [{"id": 9, "collection": "ec",
                                       "ec_index_bits": 1 << 13}]}),
    ]


@pytest.fixture(scope="module")
def masters():
    """A reference and a port master (liveness off: pulse 3600 s), each
    fed the same heartbeat streams; -> {pkg: (master, streams, acks)}."""
    out = {}
    for pkg, (Master, pb, rpc) in PKG.items():
        m = Master(ip="127.0.0.1", port=free_port(), volume_size_limit_mb=64,
                   pulse_seconds=3600.0)
        m.start()
        streams, acks = {}, []
        for node, fields in _beats():
            if node not in streams:
                streams[node] = _HeartbeatStream(
                    rpc, f"127.0.0.1:{m.grpc_port}")
            acks.append(streams[node].send(pb.Heartbeat(**fields)))
        out[pkg] = (m, streams, acks)
    yield out
    for m, streams, _acks in out.values():
        for s in streams.values():
            s.close()
        m.stop()


def _norm(obj, master):
    """Replace the master's own addresses by names, recursively."""
    text = json.dumps(obj, sort_keys=True)
    text = text.replace(f"127.0.0.1:{master.grpc_port}", "MASTER_GRPC")
    text = text.replace(f"127.0.0.1:{master.port}", "MASTER")
    return json.loads(text)


def _msg(m, master) -> dict:
    from google.protobuf import json_format

    return _norm(json_format.MessageToDict(
        m, preserving_proto_field_name=True), master)


def test_heartbeat_acks_are_equal(masters):
    ref, port = (masters[p] for p in ("ref", "port"))
    assert [_msg(a, port[0]) for a in port[2]] \
        == [_msg(a, ref[0]) for a in ref[2]]
    assert port[2][0].volume_size_limit == 64 << 20


@pytest.mark.parametrize("rpc_name,request_fields", [
    ("LookupVolume", {"volume_or_file_ids": ["1", "3,0a1b2c3d", "9", "77",
                                             "x"]}),
    ("LookupEcVolume", {"volume_id": 9}),
    ("VolumeList", {}),
    ("Statistics", {}),
    ("Statistics", {"collection": "pics"}),
    ("CollectionList", {}),
    ("GetMasterConfiguration", {}),
    ("ListMasterClients", {}),
])
def test_rpcs_answer_equal(masters, rpc_name, request_fields):
    got = {}
    for pkg, (m, _s, _a) in masters.items():
        _M, pb, rpc = PKG[pkg]
        req = getattr(pb, rpc_name + "Request")(**request_fields)
        resp = getattr(rpc.master_stub(f"127.0.0.1:{m.grpc_port}"),
                       rpc_name)(req)
        got[pkg] = _msg(resp, m)
    assert got["port"] == got["ref"]


def test_lookup_ec_volume_not_found_is_the_same_status(masters):
    codes = {}
    for pkg, (m, _s, _a) in masters.items():
        _M, pb, rpc = PKG[pkg]
        with pytest.raises(grpc.RpcError) as e:
            rpc.master_stub(f"127.0.0.1:{m.grpc_port}").LookupEcVolume(
                pb.LookupEcVolumeRequest(volume_id=404))
        codes[pkg] = (e.value.code(), e.value.details())
    assert codes["port"] == codes["ref"]


_FID = re.compile(r"^(\d+),([0-9a-f]+)([0-9a-f]{8})$")


def _fid_parts(fid: str) -> tuple[int, int]:
    m = _FID.match(fid)
    assert m, fid
    return int(m.group(1)), int(m.group(2), 16)


def test_assigns_answer_equal_by_format_and_order(masters):
    """Assign over gRPC and /dir/assign over HTTP, alternating: the same
    volumes, urls and counts; keys from the same sequencer (bumped past
    the heartbeats' max_file_key) in the same order; cookies of 8 hex
    digits."""
    got = {}
    for pkg, (m, _s, _a) in masters.items():
        _M, pb, rpc = PKG[pkg]
        stub = rpc.master_stub(f"127.0.0.1:{m.grpc_port}")
        rows = []
        for i in range(6):
            if i % 2:
                r = stub.Assign(pb.AssignRequest(count=1 + i))
                fid, url, pub, count = r.fid, r.url, r.public_url, r.count
                assert not r.error
            else:
                code, body = _http(f"http://127.0.0.1:{m.port}/dir/assign"
                                   f"?count={1 + i}")
                assert code == 200, body
                d = json.loads(body)
                fid, url, pub, count = (d["fid"], d["url"], d["publicUrl"],
                                        d["count"])
            rows.append((*_fid_parts(fid), url, pub, count))
        got[pkg] = rows
    assert got["port"] == got["ref"]
    keys = [r[1] for r in got["port"]]
    assert keys[0] == 42 and keys == sorted(keys)  # past max_file_key 41


@pytest.mark.parametrize("path", [
    "/dir/lookup?volumeId=3", "/dir/lookup?fileId=1,0102030405",
    "/dir/lookup?volumeId=9", "/dir/lookup?volumeId=404",
    "/dir/lookup?volumeId=abc", "/vol/status", "/cluster/healthz",
    "/stats/health", "/nope",
])
def test_http_api_answers_equal(masters, path):
    got = {}
    for pkg, (m, _s, _a) in masters.items():
        code, body = _http(f"http://127.0.0.1:{m.port}{path}")
        got[pkg] = (code, _norm(json.loads(body), m))
    assert got["port"] == got["ref"]


def test_dir_status_answers_equal_but_for_the_left_out_planes(masters):
    """/dir/status: the same topology, leader, health, Lifecycle and
    Health (SLO and canary) blocks; the only plane the port leaves out,
    the geo registry, has no block in the reference's document either."""
    docs = {}
    for pkg, (m, _s, _a) in masters.items():
        code, body = _http(f"http://127.0.0.1:{m.port}/dir/status")
        assert code == 200
        doc = _norm(json.loads(body), m)
        for node in doc["DataNodes"].values():
            node.pop("secondsSinceLastBeat")
        docs[pkg] = doc
    assert set(docs["ref"]) == set(docs["port"])
    assert docs["port"]["Health"]["slo"]["specs"] == 10
    assert docs["port"] == docs["ref"]


@pytest.mark.parametrize("path", ["/cluster/geo"])
def test_left_out_surfaces_answer_501_naming_the_plane(masters, path):
    m = masters["port"][0]
    code, body = _http(f"http://127.0.0.1:{m.port}{path}")
    doc = json.loads(body)
    assert code == 501 and "not ported yet" in doc["error"]
    assert "ROADMAP A-7" in doc["plane"]
    code, body = _http(f"http://127.0.0.1:{m.port}{path}", "POST", b"{}")
    assert code == 501


def _plane_doc(path: str, doc: dict) -> dict:
    """The plane's document with what differs between two masters by
    construction (times, addresses, process-wide counters, and the alert
    states the engines judge from each package's process-wide gauges)
    taken out."""
    if path == "/cluster/alerts":
        return {"specs": doc["specs"], "states": sorted(doc["states"]),
                "windowScale": doc["windowScale"],
                "intervalS": doc["intervalS"],
                "canary": {k: doc["canary"][k] for k in (
                    "interval_s", "running", "tick", "byteMismatches")},
                "debugBundles": doc["debugBundles"]}
    if path == "/cluster/debug":
        return {k: doc[k] for k in ("debugDir", "retain", "bundles")}
    if path == "/cluster/hot":
        return {"nodes": sorted(doc["nodes"]), "dims": sorted(doc["dims"])}
    if path.startswith("/cluster/traces"):
        return {"traceId": doc["traceId"], "spans": doc["spans"],
                "nodes": sorted(doc["nodes"])}
    return doc


@pytest.mark.parametrize("path", [
    "/cluster/alerts", "/cluster/debug", "/cluster/hot",
    "/cluster/traces?trace=" + "a" * 32, "/cluster/traces",
    "/cluster/metrics?family=no-dash", "/cluster/debug?bundle=bundle-none",
])
def test_plane_surfaces_answer_as_the_reference(masters, path):
    """The SLO, flight-recorder, hot-key and trace surfaces answer the
    same status and the same document (but for each master's own
    addresses and times) on a single master with no alert, no bundle and
    no trace; a bad query is refused alike."""
    got = {}
    for pkg, (m, _s, _a) in masters.items():
        code, body = _http(f"http://127.0.0.1:{m.port}{path}")
        doc = json.loads(body)
        if code == 200:
            doc = _plane_doc(path, _norm(doc, m))
        got[pkg] = (code, doc)
    assert got["port"] == got["ref"]


def test_cluster_metrics_federates_as_the_reference(masters):
    """/cluster/metrics: the same families from both masters (each
    master's own exposition and its volume servers' with instance and
    type labels), up for every scraped node; /cluster/raft on a single
    master answers like the reference's (no quorum: not a raft peer)."""
    fams = {}
    for pkg, (m, _s, _a) in masters.items():
        code, body = _http(f"http://127.0.0.1:{m.port}/cluster/metrics"
                           "?family=seaweedfs_federation")
        assert code == 200
        fams[pkg] = sorted(line.split("{", 1)[0] for line in
                           body.decode().splitlines()
                           if line and not line.startswith("#"))
        code, body = _http(f"http://127.0.0.1:{m.port}/cluster/raft",
                           "POST", b"{}")
        fams[pkg + "_raft"] = code
    assert fams["port"] == fams["ref"] and fams["port"]
    assert fams["port_raft"] == fams["ref_raft"]


def _lifecycle_docs(masters, action: str) -> dict:
    """pkg -> the Lifecycle rpc's report, with times, paths and each
    master's own address normalized away."""
    docs = {}
    for pkg, (m, _s, _a) in masters.items():
        _M, pb, rpc = PKG[pkg]
        resp = rpc.master_stub(f"127.0.0.1:{m.grpc_port}").Lifecycle(
            pb.LifecycleRequest(action=action))
        doc = json.loads(resp.report)
        for k in ("lastCycle", "deadlineLeftSeconds"):
            doc.pop(k, None)
        docs[pkg] = doc
    return docs


def test_lifecycle_rpc_answers_as_the_reference(masters):
    """The Lifecycle rpc's status, dry-run plan and mass-repair status
    answer alike on a master with no lifecycle loop (the same default
    policies, the same empty journal), and a bad action is refused
    INVALID_ARGUMENT by both."""
    for action in ("status", "mass_repair_status"):
        docs = _lifecycle_docs(masters, action)
        assert docs["port"] == docs["ref"], action
    st = _lifecycle_docs(masters, "status")["port"]
    assert st["enabled"] is False and "*" in st["policies"]
    for pkg, (m, _s, _a) in masters.items():
        _M, pb, rpc = PKG[pkg]
        stub = rpc.master_stub(f"127.0.0.1:{m.grpc_port}")
        plan = json.loads(stub.Lifecycle(pb.LifecycleRequest(
            action="run", apply=False)).report)
        assert plan["results"] == []
        with pytest.raises(grpc.RpcError) as e:
            stub.Lifecycle(pb.LifecycleRequest(action="nope"))
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_cluster_lifecycle_and_vol_repair_answer_as_the_reference(masters):
    """/cluster/lifecycle and /vol/repair's massRepair block: the same
    documents from both masters."""
    for path, key in (("/cluster/lifecycle", None),
                      ("/vol/repair", "massRepair")):
        docs = {}
        for pkg, (m, _s, _a) in masters.items():
            code, body = _http(f"http://127.0.0.1:{m.port}{path}")
            assert code == 200, (pkg, path)
            doc = json.loads(body)
            doc = doc[key] if key else doc
            for k in ("lastCycle", "deadlineLeftSeconds"):
                doc.pop(k, None)
            docs[pkg] = doc
        assert docs["port"] == docs["ref"], path


def test_tier_backend_policy_is_accepted_as_the_reference(tmp_path):
    """A policy naming a tier backend is taken at the constructor and at
    set_policies, persisted, and read back by a reference master the same
    way."""
    from seaweedfs_tpu.master.server import MasterServer as RefMaster

    doc = {"*": {"ec_cooldown_seconds": 0, "tier_backend": "s3.cold"}}
    m = PortMaster(ip="127.0.0.1", port=free_port(), lifecycle_policy=doc)
    assert m.lifecycle.policies.for_collection("x").tier_backend == "s3.cold"
    m = PortMaster(ip="127.0.0.1", port=free_port(),
                   lifecycle_dir=str(tmp_path))
    m.lifecycle.set_policies({"photos": {"tier_backend": "s3.cold",
                                         "tier_idle_seconds": 60}})
    pol = m.lifecycle.policies.for_collection("photos")
    assert (pol.tier_backend, pol.tier_idle_seconds) == ("s3.cold", 60)
    ref = RefMaster(ip="127.0.0.1", port=free_port(),
                    lifecycle_dir=str(tmp_path))
    assert ref.lifecycle.policies.to_dict() == m.lifecycle.policies.to_dict()


def test_maintenance_plane_arguments_are_live(tmp_path):
    """The lifecycle and repair arguments build the plane the reference
    builds: a controller with the given interval, journal, rate and
    policy, and an orchestrator with the given deadline (on by
    default)."""
    m = PortMaster(ip="127.0.0.1", port=free_port(),
                   lifecycle_interval=5.0, lifecycle_dir=str(tmp_path),
                   lifecycle_rate_mbps=8.0,
                   lifecycle_policy={"*": {"ec_cooldown_seconds": 30}},
                   repair_deadline_s=60.0)
    lc, mr = m.lifecycle, m.mass_repair
    assert (lc.interval_s, lc.rate_mbps) == (5.0, 8.0)
    assert lc.journal.path == str(tmp_path / "lifecycle.journal.jsonl")
    assert lc.policies.for_collection("x").ec_cooldown_seconds == 30
    assert (tmp_path / "lifecycle.policy.json").exists()
    assert mr.deadline_s == 60.0 and mr.enabled
    assert mr.journal is lc.journal


@pytest.mark.parametrize("kwargs", [
    {"peer_clusters": ["127.0.0.1:1"]},
    {"slo_interval": 15.0}, {"slo_specs": []}, {"slo_window_scale": 0.1},
    {"canary_interval": 1.0}, {"canary_s3": "127.0.0.1:8333"},
    {"alert_webhook": "http://127.0.0.1:1/a"}, {"debug_dir": "d"},
])
def test_left_out_plane_arguments_raise(kwargs, tmp_path):
    """`peer_clusters` (the geo registry, ROADMAP A-7) raises naming it;
    every argument of the SLO engine, the canary and the flight recorder
    builds its plane as the reference's master does."""
    from seaweedfs_tpu.master.server import MasterServer as RefMaster

    name = next(iter(kwargs))
    if name == "peer_clusters":
        with pytest.raises(ValueError, match="A-7"):
            PortMaster(ip="127.0.0.1", port=free_port(), **kwargs)
        return
    if name == "debug_dir":
        kwargs = {name: str(tmp_path / "d")}
    planes = {}
    for pkg, cls in (("port", PortMaster), ("ref", RefMaster)):
        m = cls(ip="127.0.0.1", port=free_port(), **kwargs)
        planes[pkg] = (
            m.slo.interval_s, m.slo.window_scale,
            [s.name for s in m.slo.specs], len(m.slo._sinks),
            m.canary.interval_s, m.canary.s3_address, m.flight.debug_dir,
            m.flight.retain)
    assert planes["port"] == planes["ref"]


def test_quorum_and_etcd_refuse_to_start(tmp_path):
    """A peer list naming more masters builds a raft node over them, as
    the reference does; a list without this master and the etcd
    sequencer (ROADMAP A-7) still refuse."""
    port = free_port()
    m = PortMaster(ip="127.0.0.1", port=port, raft_state_dir=str(tmp_path),
                   peers=[f"127.0.0.1:{port}", "127.0.0.1:1"])
    assert m.raft is not None and m.raft.peers == ["127.0.0.1:1"]
    assert m.raft.state_path == str(tmp_path / f"raft-{port}.json")
    assert not m.is_leader() and not m.control_warmed()
    assert m.lifecycle.journal.proposer is not None
    with pytest.raises(ValueError, match="not in -peers"):
        PortMaster(ip="127.0.0.1", port=port, peers=["127.0.0.1:1"])
    # a one-master peer list naming itself is the single-master case
    PortMaster(ip="127.0.0.1", port=port, peers=[f"127.0.0.1:{port}"])
    with pytest.raises(ValueError, match="A-7"):
        PortMaster(ip="127.0.0.1", port=port, sequencer="etcd")


def test_stop_leaves_no_master_thread():
    """Every thread the master started is joined by stop() (threads of
    the module's other masters are not this one's)."""
    before = set(threading.enumerate())
    m = PortMaster(ip="127.0.0.1", port=free_port(), metrics_port=free_port(),
                   maintenance_interval=0.2, pulse_seconds=0.2,
                   lifecycle_interval=0.2)
    m.start()
    stream = _HeartbeatStream(port_rpc, f"127.0.0.1:{m.grpc_port}")
    stream.send(port_pb.Heartbeat(ip="10.9.0.9", port=8089,
                                  has_no_volumes=True))
    sub = port_rpc.master_stub(f"127.0.0.1:{m.grpc_port}").KeepConnected(
        iter([port_pb.KeepConnectedRequest(name="t", client_type="filer",
                                           http_address="127.0.0.1:1")]))
    assert next(sub).url == "10.9.0.9:8089"
    # keep-alive HTTP connections hold connection threads open
    import http.client

    conns = []
    for path in ("/dir/status", "/metrics"):
        c = http.client.HTTPConnection("127.0.0.1", m.port, timeout=10)
        c.request("GET", path)
        c.getresponse().read()
        conns.append(c)
    names = {t.name for t in set(threading.enumerate()) - before}
    assert {"master-liveness", "master-maintenance", "master-http",
            "master-lifecycle-controller"} <= names
    assert any(n.startswith("master-grpc") for n in names)
    m.stop()
    stream.close()
    sub.cancel()
    for c in conns:
        c.close()
    left = [t.name for t in set(threading.enumerate()) - before
            if t.name.startswith("master-")]
    assert left == []
    # a quorum member with every plane's loop on: raft's loops, role
    # callbacks and rpc pool, the SLO engine, the canary, the federation
    # pool and the flight recorder's captures are joined too
    import tempfile

    ports = [free_port(), free_port()]
    peers = [f"127.0.0.1:{p}" for p in ports]
    with tempfile.TemporaryDirectory() as d:
        quorum = [PortMaster(ip="127.0.0.1", port=p, peers=peers,
                             raft_state_dir=d, pulse_seconds=0.2,
                             slo_interval=0.1, canary_interval=0.1,
                             debug_dir=os.path.join(d, f"debug{p}"))
                  for p in ports]
        for q in quorum:
            q.start()
        _wait(lambda: any(q.is_leader() and q.control_warmed()
                          for q in quorum), "a warmed quorum leader")
        leader = next(q for q in quorum if q.is_leader())
        assert leader.flight.capture(trigger="manual")["name"]
        names = {t.name for t in set(threading.enumerate()) - before}
        assert {"master-slo-engine", "master-canary"} <= names
        assert any(n.startswith("master-raft-elect") for n in names)
        for q in quorum:
            q.stop()
    left = [t.name for t in set(threading.enumerate()) - before
            if t.name.startswith("master-")]
    assert left == []


@pytest.fixture(scope="module")
def cross_wired(tmp_path_factory):
    """Port volume servers (codec cpu) under the reference master, and
    reference volume servers under the port's."""
    from seaweedfs_tpu.volume.server import VolumeServer as RefVS
    from seaweedfs_tpu_torch.volume.server import VolumeServer as PortVS

    out = {}
    for master_pkg, Master, VS, kw in (
            ("ref", RefMaster, PortVS, {"codec_name": "cpu"}),
            ("port", PortMaster, RefVS, {})):
        m = Master(ip="127.0.0.1", port=free_port(), volume_size_limit_mb=64)
        m.start()
        servers = []
        for i in range(2):
            d = tmp_path_factory.mktemp(f"x{master_pkg}{i}")
            s = VS([str(d)], [f"127.0.0.1:{m.grpc_port}"], ip="127.0.0.1",
                   port=free_port(), pulse_seconds=0.5, rack="r0",
                   max_volume_count=10, **kw)
            s.start()
            servers.append(s)
        _wait(lambda m=m: len(m.topo.nodes) == 2, "two nodes registered")
        out[master_pkg] = (m, servers)
    yield out
    for m, servers in out.values():
        for s in servers:
            s.stop()
        m.stop()


@pytest.mark.parametrize("master_pkg", ["ref", "port"])
def test_cross_wired_write_lookup_read(cross_wired, master_pkg):
    m, servers = cross_wired[master_pkg]
    code, body = _http(f"http://127.0.0.1:{m.port}/dir/assign"
                       "?replication=001")
    assert code == 200, body
    a = json.loads(body)
    payload = b"cross-wired needle " * 64
    code, _ = _http(f"http://{a['url']}/{a['fid']}", "POST", payload)
    assert code == 201
    vid = a["fid"].split(",")[0]
    code, body = _http(f"http://127.0.0.1:{m.port}/dir/lookup?volumeId={vid}")
    locs = [loc["url"] for loc in json.loads(body)["locations"]]
    assert sorted(locs) == sorted(f"127.0.0.1:{s.port}" for s in servers)
    for url in locs:  # both replicas serve it
        assert _http(f"http://{url}/{a['fid']}") == (200, payload)
    # the heartbeat carries the grown volume into the topology
    _wait(lambda: sum(int(vid) in n.volumes
                      for n in m.topo.nodes.values()) == 2,
          "the grown volume in the topology")
