"""The port's SLO engine and canary held against the reference's
(tests/test_slo.py and tests/test_slo_cluster.py).

Every engine scenario feeds the same counter sequence, on a pinned clock,
to a reference engine and a port engine: the burn rates after each tick
and the alert transitions must be equal, and the reference test's own
assertions hold on the port's.  Seeded random sequences over the default
spec suite do the same at scale.  The exposition helpers, the sinks and
the tracer's important-span ring are compared alike.  The canary runs on
a port master and a port volume server (`cpu` codec): round trips with
byte identity, the EC drop-shard probe, /cluster/alerts and the shell,
the geo probe's staleness, and a dead volume server found.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from helpers import free_port, make_volume
from torch_threads import one_torch_thread  # noqa: F401

from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.telemetry import federation as ref_federation
from seaweedfs_tpu.telemetry import slo as ref_slo
from seaweedfs_tpu.telemetry import trace as ref_trace
from seaweedfs_tpu_torch.stats import metrics as port_metrics
from seaweedfs_tpu_torch.telemetry import federation as port_federation
from seaweedfs_tpu_torch.telemetry import slo as port_slo
from seaweedfs_tpu_torch.telemetry import trace as port_trace

SLO = {"ref": ref_slo, "port": port_slo}
METRICS = {"ref": ref_metrics, "port": port_metrics}
FEDERATION = {"ref": ref_federation, "port": port_federation}
TRACE = {"ref": ref_trace, "port": port_trace}

RATIO_SPEC = dict(
    name="avail", severity="page", kind="ratio",
    bad_family="probe_total", bad_labels={"result": "error"},
    total_family="probe_total",
    total_labels={"result": ("ok", "error")},
    objective=0.99,
)


def _scrape_of(state: dict):
    def scrape(_families):
        return "\n".join(f"{k} {v}" for k, v in state.items()) + "\n"
    return scrape


def _spec(pkg: str, window=(10.0, 60.0, 2.0), **kw):
    mod = SLO[pkg]
    return mod.SloSpec(**kw, window=mod.BurnWindow(*window))


def _run(pkg: str, spec_kw: dict, state0: dict, steps, window=(10.0, 60.0,
         2.0), exemplars=None, max_history: int = 256):
    """One engine over `steps` [(dt, {sample: delta or ("=", value)})]:
    -> (transitions, per-tick [(state, burnShort, burnLong, value)],
    the engine)."""
    mod = SLO[pkg]
    clock = {"t": 1000.0}
    state = dict(state0)
    transitions = []
    eng = mod.SloEngine(
        _scrape_of(state), specs=[_spec(pkg, window, **spec_kw)],
        sinks=[transitions.append], interval_s=0.0, window_scale=1.0,
        now=lambda: clock["t"], exemplars=exemplars,
        max_history=max_history)
    ticks = []
    eng.evaluate()
    for dt, updates in steps:
        clock["t"] += dt
        for k, v in updates.items():
            if isinstance(v, tuple):
                state[k] = v[1]
            else:
                state[k] = state.get(k, 0.0) + v
        eng.evaluate()
        st = eng._states[spec_kw["name"]]
        a = st.get("alert", {})
        ticks.append((st["state"], a.get("burnShort"), a.get("burnLong"),
                      a.get("value")))
    return transitions, ticks, eng


def _both(spec_kw, state0, steps, **kw):
    got = {pkg: _run(pkg, spec_kw, state0, steps, **kw)
           for pkg in ("ref", "port")}
    assert got["port"][0] == got["ref"][0]  # transitions
    assert got["port"][1] == got["ref"][1]  # burn rates, states
    return got["port"]


def test_sample_labels_parses_escapes():
    for mod in SLO.values():
        name, labels = mod.sample_labels(
            'x_total{a="b",path="q\\"uote",n="l\\nf"}')
        assert name == "x_total"
        assert labels == {"a": "b", "path": 'q"uote', "n": "l\nf"}
        assert mod.sample_labels("plain") == ("plain", {})


OK_S, ERR_S = 'probe_total{result="ok"}', 'probe_total{result="error"}'


def test_ratio_spec_fires_and_resolves():
    steps = [(5, {OK_S: 10})] + [(3, {OK_S: 5, ERR_S: 5})] * 3 \
        + [(3, {OK_S: 10})] * 6
    transitions, ticks, _eng = _both(
        RATIO_SPEC, {OK_S: 100.0, ERR_S: 0.0}, steps)
    assert ticks[0][0] == "ok" and ticks[3][0] == "firing"
    assert ticks[3][1] > 2 and ticks[3][2] > 2
    assert ticks[-1][0] == "ok"
    assert any(t["state"] == "firing" for t in transitions)
    assert any(t["state"] == "ok" and t.get("from") == "firing"
               for t in transitions)


def test_ratio_pending_when_only_short_window_burns():
    steps = [(5, {OK_S: 100})] * 20 + [(5, {ERR_S: 10, OK_S: 90})]
    _t, ticks, _e = _both(RATIO_SPEC, {OK_S: 1000.0, ERR_S: 0.0}, steps)
    assert ticks[-1][0] == "pending"


def test_counter_reset_does_not_go_negative():
    _t, ticks, _e = _both(RATIO_SPEC, {OK_S: 500.0, ERR_S: 20.0},
                          [(5, {OK_S: ("=", 10.0), ERR_S: ("=", 0.0)})])
    assert ticks[-1][0] == "ok"


def test_latency_spec_from_bucket_deltas():
    b05 = 'req_seconds_bucket{type="volumeServer",op="get",le="0.5"}'
    binf = 'req_seconds_bucket{type="volumeServer",op="get",le="+Inf"}'
    cnt = 'req_seconds_count{type="volumeServer",op="get"}'
    spec = dict(name="read-p99", severity="page", kind="latency",
                family="req_seconds",
                labels={"type": "volumeServer", "op": "get"},
                threshold_s=0.5, objective=0.99)
    _t, ticks, _e = _both(spec, {b05: 100.0, binf: 100.0, cnt: 100.0},
                          [(5, {b05: 10, binf: 100, cnt: 100})])
    assert ticks[-1][0] == "firing"
    assert ticks[-1][1] == pytest.approx(90.0)


def test_gauge_spec_pending_for_then_firing_then_resolved():
    spec = dict(name="backlog", severity="warn", kind="gauge",
                family="queue_depth", threshold=1.0, for_s=10.0)
    transitions, ticks, _e = _both(
        spec, {"queue_depth": 0.0},
        [(1, {"queue_depth": ("=", 3.0)}), (11, {}),
         (1, {"queue_depth": ("=", 0.0)})], window=(10.0, 60.0, 1.0))
    assert [t[0] for t in ticks] == ["pending", "firing", "ok"]
    assert ticks[1][3] == 3.0
    assert [t["state"] for t in transitions] == ["pending", "firing", "ok"]


def test_event_spec_counts_window_delta_and_rolls_off():
    key = 'exposed_total{exposure="1"}'
    spec = dict(name="exposure", severity="page", kind="event",
                family="exposed_total", threshold=1.0, for_s=0.0)
    _t, ticks, _e = _both(spec, {key: 0.0}, [(2, {key: 3}), (11, {})],
                          window=(10.0, 60.0, 1.0))
    assert ticks[0][0] == "firing" and ticks[0][3] == 3.0
    assert ticks[1][0] == "ok"


def test_gauge_label_filter_and_max_across_instances():
    spec = dict(name="lag", severity="warn", kind="gauge",
                family="lag_seconds", threshold=60.0, for_s=0.0)
    state = {'lag_seconds{instance="a",link="x"}': 5.0,
             'lag_seconds{instance="b",link="y"}': 80.0,
             'other_seconds{instance="a"}': 500.0}
    _t, ticks, _e = _both(spec, state, [(1, {})], window=(10.0, 60.0, 1.0))
    assert ticks[0][0] == "firing" and ticks[0][3] == 80.0


def test_firing_alert_embeds_exemplar_trace_ids():
    got = {}
    for pkg in ("ref", "port"):
        r = METRICS[pkg].Registry()
        hist = r.histogram("t13_probe_seconds", "x", labels=("probe",))
        hist.labels("volume_rt").observe(0.4, trace_id="ab" * 16)
        hist.labels("volume_rt").observe(0.1, trace_id="cd" * 16)
        transitions, _ticks, _e = _run(
            pkg, {**RATIO_SPEC, "exemplar_family": "t13_probe_seconds"},
            {OK_S: 10.0, ERR_S: 0.0}, [(5, {ERR_S: 10})],
            exemplars=r.exemplars)
        got[pkg] = transitions
    ex = got["port"][0]["exemplars"]
    assert got["port"][0]["state"] == "firing"
    assert ex[0]["traceId"] == "ab" * 16
    assert ex[0]["traceQuery"].endswith("ab" * 16)
    assert ex == got["ref"][0]["exemplars"]


def test_histogram_exemplar_keeps_slowest_and_rotates():
    for mod in METRICS.values():
        r = mod.Registry()
        hist = r.histogram("t13_rot_seconds", "x")
        hist.observe(0.3, trace_id="aa" * 16)
        hist.observe(0.26, trace_id="bb" * 16)  # same bucket, smaller
        assert [e["traceId"] for e in r.exemplars("t13_rot_seconds")] \
            == ["aa" * 16]
        for entry in hist.labels().exemplars.values():
            entry[2] -= 10_000  # aged past the window
        hist.observe(0.25, trace_id="cc" * 16)
        assert "cc" * 16 in {e["traceId"]
                             for e in r.exemplars("t13_rot_seconds")}


def test_webhook_sink_posts_alert_json():
    """Both packages' sinks post the same alert document to one hook; a
    dead hook raises into neither."""
    received = []
    posted = threading.Semaphore(0)

    class Hook(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = self.rfile.read(
                int(self.headers.get("Content-Length") or 0))
            received.append(json.loads(body))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()
            posted.release()

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Hook)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        alert = {"slo": "avail", "state": "firing", "severity": "page"}
        for mod in SLO.values():
            mod.WebhookSink(
                f"http://127.0.0.1:{httpd.server_address[1]}/alert")(alert)
            assert posted.acquire(timeout=5)
            mod.WebhookSink("http://127.0.0.1:9/alert", timeout_s=0.2)(
                {"slo": "x", "state": "firing", "severity": "page"})
        assert received == [alert, alert]
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)


def test_spec_from_dict_with_window_override():
    doc = {"name": "x", "severity": "warn", "kind": "gauge", "family": "f",
           "threshold": 2.0, "window": {"shortS": 5, "longS": 25,
                                        "factor": 3}}
    got = {pkg: mod.spec_from_dict(dict(doc)).to_dict()
           for pkg, mod in SLO.items()}
    assert (got["port"]["windowShortS"], got["port"]["windowLongS"],
            got["port"]["burnFactor"]) == (5.0, 25.0, 3.0)
    assert got["port"] == got["ref"]


def test_default_specs_equal():
    assert [s.to_dict() for s in port_slo.default_specs()] == [
        s.to_dict() for s in ref_slo.default_specs()]


def test_alert_history_is_bounded():
    spec = dict(name="b", severity="warn", kind="gauge",
                family="queue_depth", threshold=1.0, for_s=0.0)
    steps = [(1, {"queue_depth": ("=", float(i % 2 * 5))})
             for i in range(40)]
    got = {pkg: _run(pkg, spec, {"queue_depth": 0.0}, steps,
                     window=(1.0, 2.0, 1.0), max_history=8)[2]
           for pkg in ("ref", "port")}
    assert len(got["port"].alert_history) == 8
    assert list(got["port"].alert_history) == list(got["ref"].alert_history)


@pytest.mark.parametrize("seed", range(6))
def test_seeded_counter_sequences_burn_alike(seed):
    """The default spec suite over a seeded random walk of the families
    it reads (canary probes, request latency buckets, mass-repair
    volumes, raft leader changes, queue depths): both engines' burn
    rates, states and transitions equal tick for tick."""
    rng = np.random.default_rng(seed)
    fams = {
        'seaweedfs_canary_probe_total{instance="m",type="master",'
        'probe="volume_rt",result="ok"}': "counter",
        'seaweedfs_canary_probe_total{instance="m",type="master",'
        'probe="volume_rt",result="error"}': "counter",
        'seaweedfs_canary_probe_total{instance="m",type="master",'
        'probe="ec_degraded",result="error"}': "counter",
        'seaweedfs_request_seconds_bucket{instance="v",type="volumeServer",'
        'op="get",le="0.5"}': "counter",
        'seaweedfs_request_seconds_bucket{instance="v",type="volumeServer",'
        'op="get",le="+Inf"}': "counter",
        'seaweedfs_request_seconds_count{instance="v",type="volumeServer",'
        'op="get"}': "counter",
        'seaweedfs_repair_batch_volumes_total{instance="m"}': "counter",
        'seaweedfs_raft_leader_changes_total{instance="m",node="m"}':
            "counter",
        'seaweedfs_repair_batch_queue_depth{instance="m"}': "gauge",
        'seaweedfs_lifecycle_queue_depth{instance="m"}': "gauge",
        'seaweedfs_volume_underreplicated{instance="m"}': "gauge",
    }
    states = {n: 0.0 for n in fams}
    steps = []
    for _ in range(60):
        upd = {}
        for n, kind in fams.items():
            if kind == "gauge":
                upd[n] = ("=", float(rng.integers(0, 300)))
            elif rng.random() < 0.5:
                upd[n] = float(rng.integers(0, 20))
        steps.append((float(rng.integers(1, 8)), upd))
    got = {}
    for pkg, mod in SLO.items():
        clock = {"t": 5000.0}
        state = dict(states)
        transitions = []
        eng = mod.SloEngine(_scrape_of(state), sinks=[transitions.append],
                            interval_s=0.0, window_scale=0.01,
                            now=lambda clock=clock: clock["t"])
        ticks = []
        for dt, upd in steps:
            clock["t"] += dt
            for k, v in upd.items():
                state[k] = v[1] if isinstance(v, tuple) else state[k] + v
            eng.evaluate()
            ticks.append({s: (st["state"], st["alert"]["burnShort"],
                              st["alert"]["burnLong"])
                          for s, st in eng._states.items()})
        got[pkg] = (transitions, ticks)
    assert got["port"] == got["ref"]
    assert got["port"][0], "the walk made no transition"


def test_tracer_important_ring_survives_healthy_flood():
    for mod in TRACE.values():
        tr = mod.Tracer(max_spans=10, max_important=8)
        bad = mod.Span(trace_id="de" * 16, span_id="11" * 8, parent_id="",
                       name="volumeServer.get", start=time.time(),
                       duration=0.01, status="error: IOError")
        slow = mod.Span(trace_id="fa" * 16, span_id="22" * 8, parent_id="",
                        name="filer.post", start=time.time(), duration=99.0)
        tr.record(bad)
        tr.record(slow)
        for i in range(50):
            tr.record(mod.Span(trace_id=f"{i:032x}", span_id=f"{i:016x}",
                               parent_id="", name="ok", start=time.time(),
                               duration=0.001))
        trace_ids = {s.trace_id for s in tr.spans()}
        assert bad.trace_id in trace_ids and slow.trace_id in trace_ids
        assert tr.recent_traces(100, trace_id=bad.trace_id)
        tr2 = mod.Tracer(max_spans=10, max_important=8)
        tr2.record(bad)
        assert len(tr2.spans()) == 1


def test_parse_family_prefixes_validation():
    for mod in METRICS.values():
        assert mod.parse_family_prefixes("") is None
        assert mod.parse_family_prefixes("seaweedfs_canary") == [
            "seaweedfs_canary"]
        assert mod.parse_family_prefixes("a_x, b_y") == ["a_x", "b_y"]
        for bad in ("bad-name", "1leading",
                    ",".join(f"f{i}" for i in range(17))):
            with pytest.raises(ValueError):
                mod.parse_family_prefixes(bad)


def test_registry_render_family_filter():
    out = {}
    for pkg, mod in METRICS.items():
        r = mod.Registry()
        r.counter("t13f_a_total", "x").inc()
        r.counter("t13f_b_total", "x").inc()
        text = r.render(["t13f_a"])
        assert "t13f_a_total" in text and "t13f_b_total" not in text
        assert "t13f_b_total" in r.render()
        out[pkg] = (text, r.render())
    assert out["port"] == out["ref"]


def test_federated_exposition_family_filter_keeps_meta():
    out = {}
    for pkg, mod in FEDERATION.items():
        fed = mod.FederatedExposition(["keep_me"])
        node = {"instance": "1.2.3.4:80", "type": "volume"}
        fed.add_live(node, "keep_me_total 3\ndrop_me_total 9\n", 0.01)
        out[pkg] = fed.render()
    assert "keep_me_total" in out["port"] and "drop_me_total" not in out["port"]
    assert 'seaweedfs_federation_up{instance="1.2.3.4:80"' in out["port"]
    assert out["port"] == out["ref"]


# -- the canary on a port master and a port volume server ---------------------


def _wait(cond, what: str, timeout: float = 15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"{what}: not within {timeout} s")


def _stage_ec(tmp, vs, vid: int, seed: int):
    """A tiny EC volume encoded by the reference, mounted whole on `vs`."""
    from seaweedfs_tpu.storage.ec import constants as ecc
    from seaweedfs_tpu.storage.ec.encoder import (
        generate_ec_files,
        write_sorted_file_from_idx,
    )

    stage = tmp / f"stage{vid}"
    stage.mkdir()
    svol = make_volume(str(stage), volume_id=vid, n_needles=8, seed=seed)
    base = svol.file_name()
    svol.close()
    generate_ec_files(base, large_block_size=10000, small_block_size=100,
                      codec_name="cpu", slice_size=1 << 20)
    write_sorted_file_from_idx(base)
    tbase = vs.store.locations[0].base_name(vid, "")
    shutil.copy(base + ".ecx", tbase + ".ecx")
    for sid in range(ecc.TOTAL_SHARDS):
        shutil.copy(base + ecc.to_ext(sid), tbase + ecc.to_ext(sid))
    vs.store.mount_ec_shards(vid, "", list(range(ecc.TOTAL_SHARDS)))
    ev = vs.store.find_ec_volume(vid)
    ev.large_block_size = 10000
    ev.small_block_size = 100
    return tbase


def _start(tmp, pulse=0.5, **master_kw):
    import urllib.request

    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.volume.server import VolumeServer

    master = MasterServer(ip="127.0.0.1", port=free_port(),
                          pulse_seconds=pulse, **master_kw)
    master.start()
    vol_dir = tmp / "vol"
    vol_dir.mkdir()
    vs = VolumeServer(
        directories=[str(vol_dir)],
        master_addresses=[f"127.0.0.1:{master.grpc_port}"],
        ip="127.0.0.1", port=free_port(), pulse_seconds=0.5,
        max_volume_count=16, codec_name="cpu")
    vs.start()
    _wait(lambda: master.topo.nodes, "node registered")
    urllib.request.urlopen(
        f"http://127.0.0.1:{master.port}/dir/assign", timeout=10).read()

    def has_volume():
        with master.topo.lock:
            return any(n.volumes for n in master.topo.nodes.values())

    _wait(has_volume, "a writable volume")
    return master, vs


@pytest.fixture(scope="module")
def canary_cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_canary")
    master, vs = _start(tmp)
    _stage_ec(tmp, vs, 99, 7)

    def ec_listed():
        with master.topo.lock:
            return any(n.ec_shards for n in master.topo.nodes.values())

    _wait(ec_listed, "ec shards in topology")
    yield master, vs
    vs.stop()
    master.stop()


def _probe_count(probe: str, result: str) -> float:
    total = 0.0
    for name, v in port_metrics.REGISTRY.snapshot_samples(
            max_samples=1 << 20):
        if (name.startswith("seaweedfs_canary_probe_total")
                and f'probe="{probe}"' in name
                and f'result="{result}"' in name):
            total += v
    return total


def test_canary_round_trip_live(canary_cluster):
    master, _vs = canary_cluster
    ok_before = _probe_count("volume_rt", "ok")
    ec_before = _probe_count("ec_degraded", "ok")
    st = master.canary.run_once()
    assert st["byteMismatches"] == 0
    vt = st["probes"]["volume_rt"]["targets"]
    assert vt and all(t["result"] == "ok" for t in vt.values())
    ec = st["probes"]["ec_degraded"]["targets"]
    assert ec and all(t["result"] == "ok" for t in ec.values())
    assert st["probes"]["metadata_rt"]["skipped"]
    assert st["probes"]["geo_sentinel"]["skipped"] == \
        "no -peerClusters configured"
    assert _probe_count("volume_rt", "ok") > ok_before
    assert _probe_count("ec_degraded", "ok") > ec_before
    ex = port_metrics.REGISTRY.exemplars("seaweedfs_canary_probe_seconds")
    assert ex and all(len(e["traceId"]) == 32 for e in ex)


def test_canary_ec_probe_reconstructs(canary_cluster):
    _master, vs = canary_cluster
    res = vs.store.find_ec_volume(99).canary_read()
    assert res["reconstructed"] and res["droppedShard"] is not None
    assert res["bytes"] > 0


def test_cluster_alerts_endpoint_and_shell(canary_cluster):
    import urllib.error
    import urllib.request

    from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command

    master, _vs = canary_cluster
    master.canary.run_once()
    with urllib.request.urlopen(
            f"http://127.0.0.1:{master.port}/cluster/alerts",
            timeout=10) as r:
        doc = json.loads(r.read())
    assert "availability" in doc["states"]
    assert doc["canary"]["tick"] >= 1
    env = CommandEnv(f"127.0.0.1:{master.grpc_port}")
    text = run_command(env, "cluster.alerts")
    assert "SLOs (" in text and "canary:" in text
    assert "health:" in run_command(env, "cluster.status")
    bad = urllib.request.Request(
        f"http://127.0.0.1:{master.port}/cluster/metrics?family=no-dash")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(bad, timeout=10)
    assert ei.value.code == 400


def test_geo_sentinel_probe_measures_remote_payload_age(monkeypatch):
    """With a peer cluster on a stub master (the port's master itself
    refuses `peer_clusters`, ROADMAP A-7), the port's geo probe reads the
    sentinel back from the remote filer and reports its age, as the
    reference's does; an unreachable peer counts as an error."""
    from seaweedfs_tpu_torch.telemetry import canary as port_canary

    class StubMaster:
        ip, port = "127.0.0.1", 1234
        peer_clusters = ["peer-master:9333"]
        lifecycle = None

        def clients_snapshot(self):
            return {"filer@a": {"type": "filer",
                                "http_address": "local-filer:8888"}}

    now = [2000.0]
    monkeypatch.setattr(port_canary.time, "time", lambda: now[0])
    prober = port_canary.CanaryProber(StubMaster())
    calls = []
    lag_s = 7.5

    def fake_http(method, url, body=b"", headers=None):
        calls.append((method, url))
        if "/cluster/status" in url:
            return json.dumps(
                {"Filers": {"x": {"httpAddress": "remote-filer:8888"}}}
            ).encode()
        if url.startswith("http://remote-filer:8888"):
            return json.dumps({"ts": now[0] - lag_s}).encode()
        return b""

    prober._http = fake_http
    prober.probe_geo_sentinel()
    st = prober.status()["probes"]["geo_sentinel"]
    assert st["targets"]["peer-master:9333"]["result"] == "ok"
    assert ("PUT", "http://local-filer:8888/.canary/geo-sentinel") in calls
    assert port_metrics.CANARY_STALENESS.labels(
        "geo_sentinel").value == pytest.approx(lag_s)

    def broken_http(method, url, body=b"", headers=None):
        if "/cluster/status" in url:
            raise IOError("peer down")
        return fake_http(method, url, body, headers)

    prober._http = broken_http
    prober.probe_geo_sentinel()
    st = prober.status()["probes"]["geo_sentinel"]
    assert st["targets"]["peer-master:9333"]["result"] == "error"


def test_canary_detects_dead_volume_server(tmp_path):
    master, vs = _start(tmp_path, pulse=30.0)  # slow sweep: node stays
    try:
        assert master.canary.run_once()["byteMismatches"] == 0
        vs.stop()  # the process is gone but the topology still lists it
        st = master.canary.run_once()
        vt = st["probes"]["volume_rt"]["targets"]
        assert any(t["result"] == "error" for t in vt.values())
    finally:
        master.stop()


# -- chaos: the judgment loop on a live cluster (tests/test_slo_cluster.py) --


@pytest.mark.chaos
def test_chaos_ec_canary_pages_on_decode_rot(tmp_path):
    """A port volume server whose EC decode serves garbage (a flipped
    shard byte) fails the drop-shard canary."""
    from seaweedfs_tpu.storage.ec import constants as ecc

    master, vs = _start(tmp_path)
    try:
        tbase = _stage_ec(tmp_path, vs, 7, 3)

        def ec_listed():
            with master.topo.lock:
                return any(n.ec_shards for n in master.topo.nodes.values())

        _wait(ec_listed, "ec shards in topology")
        st = master.canary.run_once()
        assert all(t["result"] == "ok" for t in
                   st["probes"]["ec_degraded"]["targets"].values())
        ev = vs.store.find_ec_volume(7)
        ev._interval_cache and ev._interval_cache.clear()
        with open(tbase + ecc.to_ext(1), "r+b") as f:
            f.seek(10)
            b = f.read(1)
            f.seek(10)
            f.write(bytes([b[0] ^ 0xFF]))
        st = master.canary.run_once()
        results = [t["result"] for t in
                   st["probes"]["ec_degraded"]["targets"].values()]
        assert "error" in results, st["probes"]["ec_degraded"]
    finally:
        vs.stop()
        master.stop()


@pytest.mark.chaos
def test_chaos_kill_volume_server_fires_and_resolves(tmp_path):
    """A port master with second-scale burn windows and a port volume
    server: a clean soak fires no page, the server's death fires the
    availability page, and it resolves once the dead node leaves the
    probe set."""
    master, vs = _start(tmp_path, pulse=1.0, slo_interval=0.4,
                        slo_window_scale=0.005)
    try:
        for _ in range(8):
            master.canary.run_once()
        master.slo.evaluate()
        assert not [h for h in master.slo.alert_history
                    if h["severity"] == "page" and h["state"] == "firing"]
        vs.stop()

        def fired():
            master.canary.run_once()
            return any(h["slo"] == "availability" and h["state"] == "firing"
                       for h in master.slo.alert_history)

        _wait(fired, "the availability page", 30.0)

        def resolved():
            master.canary.run_once()
            return master.slo.status(evaluate_if_idle=False)["states"][
                "availability"]["state"] == "ok"

        _wait(resolved, "the page resolved", 60.0)
    finally:
        master.stop()
