"""The port's SELECT engine (seaweedfs_tpu_torch/query/engine.py) and its
`Query` rpc, held against the reference.

The engine's output must equal the reference's byte for byte on seeded
JSON lines, JSON documents and CSV tables, for every operand and for
nested, missing and positional fields.  Over the wire, the cases of
tests/test_query.py run on a port VolumeServer (`torch_cpu`): a
reference MasterServer assigns the fids, the needles are POSTed to the
port server's HTTP plane, and the reference's stub sends `Query` and
`VolumeNeedleStatus`.  A needle of an EC volume is queried through
`read_needle`, healthy and with four data shards lost (its lost
intervals decoded on the server's codec).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

from helpers import free_port
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vs
from seaweedfs_tpu.query import engine as ref_engine
from seaweedfs_tpu_torch.query import engine
from torch_threads import one_torch_thread  # noqa: F401

OPS = ("", "=", "!=", "<", "<=", ">", ">=")


def _json_lines(seed: int, n: int = 64) -> bytes:
    rng = np.random.default_rng(seed)
    cities = ["sf", "nyc", "la", "sea"]
    out = []
    for i in range(n):
        doc = {"user": f"u{i}", "score": int(rng.integers(0, 100)),
               "ratio": round(float(rng.random()), 3),
               "ok": bool(rng.integers(0, 2)),
               "addr": {"city": cities[int(rng.integers(0, 4))]},
               "tags": [int(x) for x in rng.integers(0, 9, 3)]}
        if rng.random() < 0.2:
            del doc["score"]  # a missing field never matches
        out.append(json.dumps(doc))
        if rng.random() < 0.1:
            out.append("not json")  # skipped by both engines
    return "\n".join(out).encode()


def _csv(seed: int, n: int = 48) -> bytes:
    rng = np.random.default_rng(seed)
    rows = ["city,pop,grade", "# a comment row"]
    for i in range(n):
        rows.append(f"c{i},{int(rng.integers(0, 10000))},"
                    f"{'abc'[int(rng.integers(0, 3))]}")
    return ("\n".join(rows) + "\n").encode()


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("field,value,selections", [
    ("score", "50", ["user"]),
    ("addr.city", "sf", []),
    ("tags.1", "4", ["user", "tags.1"]),
    ("ok", "true", ["user", "ok", "missing"]),
    ("ratio", "0.5", ["ratio"]),
    ("user", "u3", ["addr"]),
])
def test_json_lines_equal_the_reference(op, field, value, selections):
    data = _json_lines(seed=len(field) + len(op))
    args = dict(field=field, op=op, value=value)
    got = engine.query_json_lines(data, selections, **args)
    assert got == ref_engine.query_json_lines(data, selections, **args)


def test_json_document_equals_the_reference():
    doc = json.dumps({"a": {"b": [1, 2, {"c": "x"}]}, "n": 7}).encode()
    for sel, field, op, value in ((["a.b.2.c"], "n", ">", "3"),
                                  ([], "n", "<", "3"),
                                  (["n"], "a.b.0", "=", "1")):
        args = dict(field=field, op=op, value=value, document=True)
        assert engine.query_json_lines(doc, sel, **args) \
            == ref_engine.query_json_lines(doc, sel, **args)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("header,field,selections", [
    ("USE", "pop", ["city", "grade"]),
    ("USE", "grade", []),
    ("USE", "nope", ["city", "nope"]),
    ("NONE", "_2", ["_1"]),
    ("IGNORE", "_3", ["_3", "_1"]),
])
def test_csv_equals_the_reference(op, header, field, selections):
    data = _csv(seed=len(op) + len(header))
    value = "b" if field in ("grade", "_3") else "5000"
    args = dict(field=field, op=op, value=value, header=header)
    got = engine.query_csv_lines(data, selections, **args)
    assert got == ref_engine.query_csv_lines(data, selections, **args)


def test_engine_cases_of_the_reference_suite():
    data = (b'{"name":"a","age":30,"addr":{"city":"sf"}}\n'
            b'{"name":"b","age":5,"addr":{"city":"nyc"}}\n'
            b'{"name":"c","age":40,"addr":{"city":"sf"}}\n')
    out = engine.query_json_lines(data, ["name"], field="age", op=">=",
                                  value="30")
    assert [json.loads(r) for r in out.splitlines()] == [
        {"name": "a"}, {"name": "c"}]
    out = engine.query_json_lines(data, [], field="addr.city", op="=",
                                  value="nyc")
    rows = [json.loads(r) for r in out.splitlines()]
    assert len(rows) == 1 and rows[0]["name"] == "b"
    out = engine.query_json_lines(data, ["age"], field="name", op="!=",
                                  value="b")
    assert [json.loads(r)["age"] for r in out.splitlines()] == [30, 40]
    data = b"name,age,city\na,30,sf\nb,5,nyc\nc,40,sf\n"
    assert engine.query_csv_lines(data, ["name", "city"], field="age",
                                  op=">", value="10") == b"a,sf\nc,sf\n"
    assert engine.query_csv_lines(b"a,30\nb,5\n", ["_1"], field="_2",
                                  op="<", value="10", header="NONE") == b"b\n"


# -- over the wire ------------------------------------------------------------

EC_VID = 9
EC_LOST = [0, 1, 2, 3]


def _write_ec_volume(directory: str, payloads: dict) -> dict:
    """Volume EC_VID of `payloads` ({key: bytes}) written by the
    reference's Volume, encoded by the reference; -> {key: cookie}."""
    from seaweedfs_tpu.storage import Needle, SuperBlock
    from seaweedfs_tpu.storage.ec.encoder import (
        generate_ec_files, write_sorted_file_from_idx)
    from seaweedfs_tpu.storage.volume import Volume

    rng = np.random.default_rng(43)
    vol = Volume(directory, "", EC_VID, super_block=SuperBlock())
    cookies = {}
    for key, payload in payloads.items():
        cookies[key] = int(rng.integers(0, 2**32))
        vol.append_needle(Needle(cookie=cookies[key], id=key, data=payload))
    vol.close()
    base = os.path.join(directory, str(EC_VID))
    generate_ec_files(base, codec_name="cpu")
    write_sorted_file_from_idx(base)
    return cookies


@pytest.fixture(scope="module")
def port_cluster(tmp_path_factory):
    """A reference MasterServer and a port VolumeServer (`torch_cpu`) that
    also holds EC volume EC_VID, encoded by the reference from JSON-lines
    needles."""
    import time

    from seaweedfs_tpu.master.server import MasterServer
    from seaweedfs_tpu_torch.volume.server import VolumeServer

    d = str(tmp_path_factory.mktemp("queryvol"))
    ec_dir = str(tmp_path_factory.mktemp("queryec"))
    rng = np.random.default_rng(41)
    payloads = {key: _json_lines(seed=100 + key, n=int(rng.integers(8, 200)))
                for key in range(1, 25)}
    cookies = _write_ec_volume(ec_dir, payloads)
    for name in os.listdir(ec_dir):
        if ".ec" in name or name.endswith(".vif"):
            shutil.copy(os.path.join(ec_dir, name), d)
    master = MasterServer(ip="127.0.0.1", port=free_port(),
                          volume_size_limit_mb=64)
    master.start()
    vsrv = VolumeServer([d], [f"127.0.0.1:{master.grpc_port}"],
                        ip="127.0.0.1", port=free_port(),
                        codec_name="torch_cpu", pulse_seconds=0.5)
    vsrv.start()
    try:
        deadline = time.monotonic() + 20
        while not master.topo.nodes:
            assert time.monotonic() < deadline, "the master never saw us"
            time.sleep(0.05)
        yield master, vsrv, cookies, payloads
    finally:
        vsrv.stop()
        master.stop()


def _upload(master, payload: bytes, name: str = "q.json") -> str:
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{master.port}/dir/assign", timeout=10) as r:
        a = json.loads(r.read())
    body = (f"--qb\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{name}\"\r\nContent-Type: application/json"
            f"\r\n\r\n").encode() + payload + b"\r\n--qb--\r\n"
    req = urllib.request.Request(
        f"http://{a['url']}/{a['fid']}", data=body, method="POST",
        headers={"Content-Type": "multipart/form-data; boundary=qb"})
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 201
    return a["fid"]


def _json_query(fids, selections, field, op, value):
    return ref_vs.QueryRequest(
        selections=selections, from_file_ids=fids,
        filter=ref_vs.QueryRequest.Filter(field=field, operand=op,
                                          value=value),
        input_serialization=ref_vs.QueryRequest.InputSerialization(
            json_input=ref_vs.QueryRequest.InputSerialization.JSONInput(
                type="LINES")))


def _stub(vsrv):
    return ref_rpc.volume_server_stub(f"127.0.0.1:{vsrv.grpc_port}",
                                      timeout=20)


def test_query_rpc_json_where(port_cluster):
    master, vsrv, _c, _p = port_cluster
    lines = b"\n".join(json.dumps({"user": f"u{i}", "score": i * 10}).encode()
                       for i in range(8))
    fid = _upload(master, lines)
    req = _json_query([fid], ["user"], "score", ">=", "50")
    records = b"".join(s.records for s in _stub(vsrv).Query(req))
    assert [json.loads(r)["user"] for r in records.splitlines()] == [
        "u5", "u6", "u7"]


def test_query_rpc_csv(port_cluster):
    master, vsrv, _c, _p = port_cluster
    fid = _upload(master, b"city,pop\nsf,800\nnyc,8000\nla,4000\n")
    req = ref_vs.QueryRequest(
        selections=["city"], from_file_ids=[fid],
        filter=ref_vs.QueryRequest.Filter(field="pop", operand=">",
                                          value="1000"),
        input_serialization=ref_vs.QueryRequest.InputSerialization(
            csv_input=ref_vs.QueryRequest.InputSerialization.CSVInput(
                file_header_info="USE")))
    records = b"".join(s.records for s in _stub(vsrv).Query(req))
    assert records == b"nyc\nla\n"


def test_query_rpc_errors(port_cluster):
    import grpc

    master, vsrv, _c, _p = port_cluster
    fid = _upload(master, b'{"a": 1}')
    vid, rest = fid.split(",", 1)
    bad_cookie = f"{vid},{rest[:-8]}{int(rest[-8:], 16) ^ 1:08x}"
    missing = f"{vid},{int(rest[:-8], 16) + 99999:x}{rest[-8:]}"
    for fids, code in (([bad_cookie], grpc.StatusCode.PERMISSION_DENIED),
                       ([missing], grpc.StatusCode.NOT_FOUND)):
        with pytest.raises(grpc.RpcError) as ei:
            list(_stub(vsrv).Query(_json_query(fids, [], "a", "=", "1")))
        assert ei.value.code() == code
    with pytest.raises(grpc.RpcError) as ei:
        list(_stub(vsrv).Query(ref_vs.QueryRequest(from_file_ids=[fid])))
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_volume_needle_status(port_cluster):
    from seaweedfs_tpu.storage.file_id import FileId

    master, vsrv, _c, _p = port_cluster
    fid = FileId.parse(_upload(master, b"status-check-payload"))
    resp = _stub(vsrv).VolumeNeedleStatus(ref_vs.VolumeNeedleStatusRequest(
        volume_id=fid.volume_id, needle_id=fid.key))
    assert (resp.needle_id, resp.cookie, resp.size) == (
        fid.key, fid.cookie, len(b"status-check-payload"))


def test_query_rpc_on_ec_needles_healthy_and_degraded(port_cluster):
    """Each EC needle queried through the rpc equals the engine run on the
    needle's payload, with all 14 shards and with .ec00-.ec03 gone."""
    _master, vsrv, cookies, payloads = port_cluster
    stub = _stub(vsrv)
    stub.VolumeEcShardsMount(ref_vs.VolumeEcShardsMountRequest(
        volume_id=EC_VID, shard_ids=list(range(14))))
    def check():
        for key, payload in payloads.items():
            fid = f"{EC_VID},{key:x}{cookies[key]:08x}"
            req = _json_query([fid], ["user", "score"], "score", ">", "40")
            got = b"".join(s.records for s in stub.Query(req))
            assert got == ref_engine.query_json_lines(
                payload, ["user", "score"], field="score", op=">",
                value="40")

    from seaweedfs_tpu_torch.stats.metrics import (EC_INTERVAL_CACHE,
                                                   EC_OP_HISTOGRAM)

    check()
    stub.VolumeEcShardsUnmount(ref_vs.VolumeEcShardsUnmountRequest(
        volume_id=EC_VID, shard_ids=EC_LOST))
    if vsrv.store.needle_cache is not None:
        vsrv.store.needle_cache.clear()
    decodes = EC_OP_HISTOGRAM.labels("reconstruct", "torch_cpu")
    before = (EC_INTERVAL_CACHE.labels("miss").value, decodes.count)
    check()
    # the lost intervals were decoded on the server's codec
    assert EC_INTERVAL_CACHE.labels("miss").value > before[0]
    assert decodes.count > before[1]
