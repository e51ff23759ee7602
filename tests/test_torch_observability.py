"""The port's trace stitching, metrics federation and cluster.status held
against the reference's (tests/test_stitch_federation.py,
tests/test_cluster_observability.py, and the stitch and cluster.status
tests of tests/test_observability.py).

The same node results go through both packages' `stitch_trace` and the
same expositions and heartbeat snapshots through both
`FederatedExposition`s: the outputs must be equal, the rendered
expositions byte for byte.  Then the plane on a live cluster of port
processes (a master and two volume servers on `cpu`): one replicated
write stitched across both volume processes from the master's
/cluster/traces, /cluster/metrics federating both with a dead node
served stale from its heartbeat snapshot, and /debug/profile under load.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
from helpers import free_port

from seaweedfs_tpu.master import observability as ref_obs
from seaweedfs_tpu.telemetry import federation as ref_fed
from seaweedfs_tpu.telemetry import stitch as ref_stitch
from seaweedfs_tpu_torch.master import observability as port_obs
from seaweedfs_tpu_torch.telemetry import federation as port_fed
from seaweedfs_tpu_torch.telemetry import stitch as port_stitch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STITCH = {"ref": ref_stitch, "port": port_stitch}
FED = {"ref": ref_fed, "port": port_fed}
TID = "ab" * 16


def _span(span_id, parent, start, dur_ms, name="op", tid=TID):
    return {"traceId": tid, "spanId": span_id, "parentId": parent,
            "name": name, "start": start, "durationMs": dur_ms,
            "attrs": {}, "status": "ok"}


def _stitched(results, tid=TID) -> dict:
    out = {pkg: mod.stitch_trace(tid, json.loads(json.dumps(results)))
           for pkg, mod in STITCH.items()}
    assert json.dumps(out["port"]) == json.dumps(out["ref"])
    return out["port"]


# -- stitch: clock skew ------------------------------------------------------


def test_estimate_skew_symmetric_path():
    for mod in STITCH.values():
        assert mod.estimate_skew(100.5, 100.0, 0.2) == pytest.approx(0.4)
        assert mod.estimate_skew(99.0, 100.0, 0.2) == pytest.approx(-1.1)


def test_stitch_negative_skew_reorders_spans():
    doc = _stitched([
        {"instance": "m:1", "type": "master",
         "spans": [_span("aa" * 8, "", 100.0, 10.0)],
         "skew_s": 0.0, "rtt_s": 0.0},
        {"instance": "v:1", "type": "volume",
         "spans": [_span("bb" * 8, "aa" * 8, 98.5, 5.0)],
         "skew_s": -2.0, "rtt_s": 0.01},
    ])
    assert [s["spanId"] for s in doc["spans"]] == ["aa" * 8, "bb" * 8]
    assert doc["spans"][1]["startAdjusted"] == 100.5
    assert doc["nodes"]["v:1"]["clockSkewMs"] == -2000.0
    assert doc["durationMs"] == 505.0


def test_stitch_missing_skew_field_defaults_to_zero():
    doc = _stitched([{"instance": "v:1", "type": "volume",
                      "spans": [_span("aa" * 8, "", 50.0, 1.0)]}])
    assert doc["spans"][0]["startAdjusted"] == 50.0
    assert doc["nodes"]["v:1"]["clockSkewMs"] == 0.0


def test_stitch_marks_orphans_and_empty_input():
    doc = _stitched([
        {"instance": "a:1", "type": "filer",
         "spans": [_span("aa" * 8, "", 10.0, 1.0),
                   _span("bb" * 8, "aa" * 8, 10.1, 1.0),
                   _span("cc" * 8, "99" * 8, 10.2, 1.0)],
         "skew_s": 0.0, "rtt_s": 0.0},
    ])
    by_id = {s["spanId"]: s for s in doc["spans"]}
    assert not by_id["aa" * 8]["orphan"] and not by_id["bb" * 8]["orphan"]
    assert by_id["cc" * 8]["orphan"]
    empty = _stitched([])
    assert empty["spans"] == [] and "durationMs" not in empty


def test_stitch_trace_merges_skews_and_marks_orphans():
    t0 = 1_722_729_600.0
    tid = "cd" * 16
    out = _stitched([
        {"instance": "f:8888", "type": "filer", "skew_s": 0.0,
         "rtt_s": 0.001,
         "spans": [_span("f" * 16, "", t0, 30.0, "filer.post", tid)]},
        {"instance": "v:8080", "type": "volume", "skew_s": 10.0,
         "rtt_s": 0.002,
         "spans": [_span("e" * 16, "f" * 16, t0 + 10.005, 5.0,
                         "volumeServer.post", tid),
                   _span("d" * 16, "0" * 16, t0 + 10.010, 1.0, "orphaned",
                         tid)]},
    ], tid)
    assert [s["name"] for s in out["spans"]] == [
        "filer.post", "volumeServer.post", "orphaned"]
    by_name = {s["name"]: s for s in out["spans"]}
    assert abs(by_name["volumeServer.post"]["startAdjusted"]
               - (t0 + 0.005)) < 1e-6
    assert not by_name["volumeServer.post"]["orphan"]
    assert by_name["orphaned"]["orphan"]
    assert out["nodes"]["v:8080"]["clockSkewMs"] == 10000.0
    for mod in STITCH.values():
        assert abs(mod.estimate_skew(100.2, 100.0, 0.1) - 0.15) < 1e-9


# -- federation: parse + snapshot fallback -----------------------------------


def test_parse_exposition_groups_histograms_and_drops_malformed():
    text = "\n".join([
        "# HELP x_seconds latency",
        "# TYPE x_seconds histogram",
        'x_seconds_bucket{le="0.5"} 3',
        "x_seconds_sum 1.5",
        "x_seconds_count 3",
        "# TYPE y_total counter",
        "y_total 7 1700000000",
        'broken{no_close 9',
        "bare_untyped 1",
    ])
    got = {pkg: mod.parse_exposition(text) for pkg, mod in FED.items()}
    assert got["port"] == got["ref"]
    families, samples = got["port"]
    assert families["x_seconds"][0] == "histogram"
    by_family: dict = {}
    for family, name, value in samples:
        by_family.setdefault(family, []).append((name, value))
    assert {n for n, _v in by_family["x_seconds"]} == {
        'x_seconds_bucket{le="0.5"}', "x_seconds_sum", "x_seconds_count"}
    assert ("y_total", "7") in by_family["y_total"]
    assert "bare_untyped" in by_family
    assert not any("broken" in f for f in by_family)


def test_snapshot_fallback_renders_with_registry_kinds():
    """A node served from its heartbeat snapshot: the family's kind and
    help from each package's registry, unknown names untyped, the stale
    and age meta-samples; the two renderings equal byte for byte."""
    out = {}
    for pkg, mod in FED.items():
        fed = mod.FederatedExposition()
        fed.add_snapshot({"instance": "10.0.0.9:8080", "type": "volume"}, [
            ('seaweedfs_request_total{type="volumeServer",op="get"}', 42.0),
            ("totally_unknown_total", 7.0),
        ], age_seconds=12.5)
        out[pkg] = fed.render()
    assert "# TYPE seaweedfs_request_total counter" in out["port"]
    assert "# TYPE totally_unknown_total untyped" in out["port"]
    assert 'seaweedfs_federation_stale{instance="10.0.0.9:8080"' in out["port"]
    assert "seaweedfs_federation_snapshot_age_seconds" in out["port"]
    assert out["port"] == out["ref"]


def test_one_registry_snapshot_federates_byte_equal():
    """One registry's exposition and its compact snapshot, from a live
    node and a down one, through both packages' federation."""
    from seaweedfs_tpu_torch.stats.metrics import Registry

    r = Registry()
    c = r.counter("t16_ops_total", "ops", labels=("op",))
    c.labels("get").inc(3)
    c.labels('we"ird').inc()
    r.gauge("t16_depth", "depth").set(7)
    h = r.histogram("t16_seconds", "latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(2.0)
    text = r.render()
    snap = r.snapshot_samples()
    out = {}
    for pkg, mod in FED.items():
        fed = mod.FederatedExposition()
        fed.add_live({"instance": "a:1", "type": "volume"}, text, 0.25)
        fed.add_snapshot({"instance": "b:1", "type": "volume"}, snap, 3.0)
        fed.add_down({"instance": "c:1", "type": "filer"})
        out[pkg] = fed.render()
    assert out["port"] == out["ref"]
    assert 't16_ops_total{instance="a:1",type="volume",op="get"} 3' \
        in out["port"]


def test_down_node_still_visible():
    for mod in FED.values():
        fed = mod.FederatedExposition()
        fed.add_down({"instance": "10.0.0.9:8080", "type": "volume"})
        assert 'seaweedfs_federation_up{instance="10.0.0.9:8080"' \
            in fed.render()


def test_inject_labels_orders_extras_first():
    for mod in FED.values():
        assert mod.inject_labels('x_total{op="get"}', {"instance": "a:1"}) \
            == 'x_total{instance="a:1",op="get"}'
        assert mod.inject_labels("x_total", {"instance": "a:1"}) == (
            'x_total{instance="a:1"}')


def test_federation_targets_staleness_cutoff():
    from seaweedfs_tpu_torch.master.server import MasterServer

    master = MasterServer(ip="127.0.0.1", port=free_port())
    now = time.monotonic()
    master.stats_snapshots["1.1.1.1:80"] = {
        "type": "volume", "samples": [("x_total", 1.0)],
        "captured_at_ms": 0, "received": now - 10.0}
    master.stats_snapshots["2.2.2.2:80"] = {
        "type": "volume", "samples": [("x_total", 1.0)],
        "captured_at_ms": 0,
        "received": now - port_obs.SNAPSHOT_RETENTION_S - 5}
    instances = {t["instance"] for t in port_obs.federation_targets(master)}
    assert "1.1.1.1:80" in instances and "2.2.2.2:80" not in instances
    assert port_obs.SNAPSHOT_RETENTION_S == ref_obs.SNAPSHOT_RETENTION_S
    assert port_obs.FEDERATION_TIMEOUT_S == ref_obs.FEDERATION_TIMEOUT_S


# -- shell cluster.status ----------------------------------------------------


def test_shell_cluster_status_renders():
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command

    m = MasterServer(ip="127.0.0.1", port=free_port())
    m.start()
    try:
        env = CommandEnv(f"127.0.0.1:{m.grpc_port}")
        out = run_command(env, "cluster.status")
        assert f"master 127.0.0.1:{m.port}" in out
        assert "volume servers (0):" in out
        assert "health: ok (10 SLOs, engine on-demand" in out
        assert "/cluster/metrics" in out
        assert json.loads(run_command(env, "cluster.status -json"))[
            "IsLeader"] is True
    finally:
        m.stop()


# -- the plane on live port processes ----------------------------------------

CLIENT_TRACE_ID = "0b5e" + "cd" * 14
TRACEPARENT = f"00-{CLIENT_TRACE_ID}-{'22' * 8}-01"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _spawn(args, cwd):
    return subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", *args], cwd=cwd,
        env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)


def _get(url, timeout=10) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def _wait(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            got = cond()
            if got:
                return got
        except (urllib.error.URLError, OSError, KeyError, ValueError):
            pass
        time.sleep(0.1)
    raise AssertionError(f"{what}: not within {timeout} s")


def test_cluster_observability_plane(tmp_path):
    """A port master and two port volume processes: one replicated write
    is one stitched trace from /cluster/traces with spans of both volume
    processes, the replica's parented across processes; /cluster/metrics
    federates both, and serves the SIGKILLed one stale from its last
    heartbeat snapshot; /debug/profile has stacks under load."""
    mport, v1, v2 = free_port(), free_port(), free_port()
    procs = {}
    try:
        procs["master"] = _spawn(["master", "-port", str(mport)],
                                 str(tmp_path))
        for name, port, rack in (("v1", v1, "r0"), ("v2", v2, "r1")):
            (tmp_path / name).mkdir()
            procs[name] = _spawn(
                ["volume", "-dir", str(tmp_path / name), "-port", str(port),
                 "-mserver", f"127.0.0.1:{mport}", "-ec.codec", "cpu",
                 "-rack", rack, "-max", "10"], str(tmp_path))
        _wait(lambda: len(json.loads(_get(
            f"http://127.0.0.1:{mport}/cluster/status"))["DataNodes"]) == 2,
            "both volume servers registered")

        a = json.loads(_get(f"http://127.0.0.1:{mport}/dir/assign"
                            "?replication=010", timeout=30))
        req = urllib.request.Request(
            f"http://{a['url']}/{a['fid']}", data=os.urandom(4096),
            method="POST", headers={"traceparent": TRACEPARENT})
        with urllib.request.urlopen(req, timeout=15) as r:
            assert r.status == 201

        def stitched():
            doc = json.loads(_get(f"http://127.0.0.1:{mport}/cluster/traces"
                                  f"?trace={CLIENT_TRACE_ID}"))
            posts = [s for s in doc["spans"]
                     if s["name"] == "volumeServer.post"]
            return doc if len({s["instance"] for s in posts}) == 2 else None

        doc = _wait(stitched, "the write stitched across both processes")
        assert doc["traceId"] == CLIENT_TRACE_ID
        posts = [s for s in doc["spans"] if s["name"] == "volumeServer.post"]
        primary = next(s for s in posts if s["instance"] == a["url"])
        replica = next(s for s in posts if s["instance"] != a["url"])
        primary_ids = {s["spanId"] for s in doc["spans"]
                       if s["instance"] == a["url"]}
        assert replica["parentId"] in primary_ids and not replica["orphan"]
        assert primary["parentId"] == "22" * 8
        for node in doc["nodes"].values():
            assert "clockSkewMs" in node
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"http://127.0.0.1:{mport}/cluster/traces?trace=nope")
        assert e.value.code == 400

        stop = threading.Event()

        def load():
            while not stop.is_set():
                try:
                    with urllib.request.urlopen(
                            f"http://{a['url']}/{a['fid']}", timeout=5) as r:
                        r.read()
                except OSError:
                    pass

        lt = threading.Thread(target=load, daemon=True)
        lt.start()
        try:
            prof = _get(f"http://{a['url']}/debug/profile?seconds=1&hz=97",
                        timeout=15)
        finally:
            stop.set()
            lt.join(timeout=10)
        stack, _, count = prof.splitlines()[0].rpartition(" ")
        assert int(count) >= 1 and stack

        text = _get(f"http://127.0.0.1:{mport}/cluster/metrics")
        for port in (v1, v2):
            assert (f'seaweedfs_federation_up{{instance="127.0.0.1:{port}"'
                    f',type="volume"}} 1') in text
        _wait(lambda: f"127.0.0.1:{v2}" in json.loads(_get(
            f"http://127.0.0.1:{mport}/cluster/status"))["StatsSnapshots"],
            "v2's heartbeat snapshot")
        procs.pop("v2").kill()
        _wait(lambda: (f'seaweedfs_federation_stale{{instance='
                       f'"127.0.0.1:{v2}",type="volume"}} 1') in _get(
            f"http://127.0.0.1:{mport}/cluster/metrics"),
            "the dead node served stale")
        text = _get(f"http://127.0.0.1:{mport}/cluster/metrics")
        assert (f'seaweedfs_federation_snapshot_age_seconds'
                f'{{instance="127.0.0.1:{v2}"') in text
        assert (f'seaweedfs_federation_up{{instance="127.0.0.1:{v1}"'
                f',type="volume"}} 1') in text
    finally:
        for p in procs.values():
            p.send_signal(signal.SIGTERM)
        for p in procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
