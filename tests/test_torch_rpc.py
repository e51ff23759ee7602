"""The port's copies of the small modules the volume server's gRPC side
needs, held against the reference:

  * util/failsafe.py — every test of tests/test_failsafe.py, its own body
    run against the port's module (the test's `failsafe` global rebound);
  * storage/file_id.py, wdclient/location_cache.py (on a fake clock) and
    telemetry/trace.py's traceparent parsing — the same inputs through
    both packages;
  * telemetry/middleware.py's record_op and pb/rpc.py — a port rpc counts
    its request and its wire bytes, carries the caller's trace into the
    server, and clamps its timeout to an ambient failsafe deadline.
"""

import inspect
import types

import pytest

import test_failsafe as ref_tests
from seaweedfs_tpu.storage.file_id import FileId as RefFileId
from seaweedfs_tpu.storage.file_id import parse_volume_or_file_id as ref_pvf
from seaweedfs_tpu.telemetry import trace as ref_trace
from seaweedfs_tpu.wdclient.location_cache import (
    TieredLocationCache as RefCache,
)
from seaweedfs_tpu_torch.pb import master_pb2, rpc
from seaweedfs_tpu_torch.stats.metrics import (
    GRPC_BYTES,
    REQUEST_COUNTER,
    RETRY_COUNTER,
)
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.file_id import parse_volume_or_file_id
from seaweedfs_tpu_torch.telemetry import trace
from seaweedfs_tpu_torch.util import failsafe
from seaweedfs_tpu_torch.wdclient.location_cache import TieredLocationCache

from helpers import free_port


def _reference_cases():
    """(id, function, kwargs) for every test of tests/test_failsafe.py,
    parametrized ones expanded."""
    out = []
    for name, fn in sorted(vars(ref_tests).items()):
        if not name.startswith("test_") or not inspect.isfunction(fn):
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out.append((name, fn, {}))
            continue
        (argnames, values), = [m.args for m in marks]
        keys = [a.strip() for a in argnames.split(",")]
        for i, vals in enumerate(values):
            out.append((f"{name}[{i}]", fn, dict(zip(keys, vals))))
    return out


CASES = _reference_cases()


@pytest.fixture()
def _port_breakers():
    failsafe.reset_breakers()
    yield
    failsafe.reset_breakers()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_failsafe_passes_the_reference_tests(case, _port_breakers):
    _name, fn, kwargs = case
    assert set(inspect.signature(fn).parameters) == set(kwargs)
    # the test and the module's helpers it calls, all over one namespace
    # whose `failsafe` is the port's
    g = {**fn.__globals__, "failsafe": failsafe}
    for k, v in list(g.items()):
        if inspect.isfunction(v) and v.__module__ == ref_tests.__name__:
            g[k] = types.FunctionType(v.__code__, g, v.__name__,
                                      v.__defaults__, v.__closure__)
    g[fn.__name__](**kwargs)


def test_failsafe_records_into_the_port_registry():
    assert failsafe.RETRY_COUNTER is RETRY_COUNTER


@pytest.mark.parametrize("fid", [
    "3,01637037d6", "3,01637037d6.jpg", "7,a1b2c3d4e5f60708_3",
    "4294967295,ffffffffffffffff00000000", " 12,100000001 "])
def test_file_id_matches_reference(fid):
    got, want = FileId.parse(fid), RefFileId.parse(fid)
    assert (got.volume_id, got.key, got.cookie) == \
        (want.volume_id, want.key, want.cookie)
    assert str(got) == str(want)
    assert parse_volume_or_file_id(fid.strip()) == ref_pvf(fid.strip())


@pytest.mark.parametrize("fid", ["3", "3,0163", "x,01637037d6"])
def test_file_id_rejects_as_the_reference(fid):
    with pytest.raises(ValueError):
        RefFileId.parse(fid)
    with pytest.raises(ValueError):
        FileId.parse(fid)


def test_location_cache_tiers_match_reference():
    """The same lookups (found, empty, failed) at the same fake times give
    both caches the same answers and the same upstream call counts."""
    script = [{1: ["a"]}, {}, IOError("down"), {2: ["b"]}, {}]
    times = [0, 1, 301, 302, 303.5, 305, 316, 317, 330, 640]

    def run(cls):
        clock = {"t": 0.0}
        answers = iter(script)

        def lookup():
            a = next(answers, {9: ["z"]})
            if isinstance(a, Exception):
                raise a
            return a

        c = cls(lookup, clock=lambda: clock["t"])
        seen = []
        for t in times:
            clock["t"] = t
            seen.append(dict(c.get()))
            if t == 316:
                c.invalidate()
        return seen, c.lookups, c.errors

    assert run(TieredLocationCache) == run(RefCache)


@pytest.mark.parametrize("value", [
    None, "", "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01", "ff-" + "a" * 32 + "-"
    + "b" * 16 + "-01", "00-" + "A" * 32 + "-" + "B" * 16 + "-00",
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01", "00-abc-def-01"])
def test_traceparent_matches_reference(value):
    assert trace.parse_traceparent(value) == ref_trace.parse_traceparent(value)
    with trace.remote_context(value):
        with ref_trace.remote_context(value):
            assert trace.traceparent_header() == \
                ref_trace.traceparent_header()


class _Echo:
    """A master servicer whose LookupEcVolume answers with the trace id it
    was called under and how long the caller's deadline left it."""

    def LookupEcVolume(self, request, context):
        ctx = trace.current_context()
        resp = master_pb2.LookupEcVolumeResponse(
            volume_id=int(context.time_remaining() or 0))
        resp.shard_id_locations.add(shard_id=request.volume_id).locations.add(
            url=ctx[0] if ctx else "")
        return resp


def test_rpc_counts_traces_and_clamps_to_the_deadline():
    port = free_port() + 10000
    server = rpc.serve([(rpc.MASTER, _Echo())], port, host="127.0.0.1")
    addr = f"127.0.0.1:{port}"
    try:
        reqs = REQUEST_COUNTER.labels("masterGrpc", "LookupEcVolume")
        rx = GRPC_BYTES.labels("masterGrpc", "LookupEcVolume", "rx")
        n0, b0 = reqs.value, rx.value
        stub = rpc.master_stub(addr, timeout=60)
        req = master_pb2.LookupEcVolumeRequest(volume_id=7)
        with trace.start_span("caller") as span:
            with failsafe.deadline_scope(5.0):
                resp = stub.LookupEcVolume(req)
        assert resp.shard_id_locations[0].locations[0].url == span.trace_id
        assert 0 < resp.volume_id <= 5  # the 60 s stub timeout clamped
        assert reqs.value == n0 + 1
        assert rx.value == b0 + req.ByteSize()
        with failsafe.deadline_scope(0.0):
            with pytest.raises(failsafe.DeadlineExceeded):
                stub.LookupEcVolume(req)
        assert reqs.value == n0 + 1  # a spent budget sends nothing
    finally:
        server.stop(grace=None).wait()
        rpc.close_channels(addr)
    assert addr not in rpc._channels
