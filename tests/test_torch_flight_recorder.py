"""The port's flight recorder and hot-key tables held against the
reference's (tests/test_flight_recorder.py).

The space-saving sketch and the hot-key recorder get the same records in
both packages and must report the same tables (the recorder's window on
a pinned clock, not a sleep).  The bundle journey runs on a port master
and a port volume server.  The sink's gating is checked on the capture
threads themselves, not on sleeps.  And the reference fault the port
repairs: with `time.monotonic` pinned to 100.0 (a machine up 100 s) and
the cooldown at an hour, the reference drops the first page's bundle and
the port captures it.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
from helpers import free_port
from torch_threads import one_torch_thread  # noqa: F401

from seaweedfs_tpu.master import flight as ref_flight
from seaweedfs_tpu.telemetry import hotkeys as ref_hotkeys
from seaweedfs_tpu_torch.master import flight as port_flight
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.telemetry import hotkeys as port_hotkeys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOTKEYS = {"ref": ref_hotkeys, "port": port_hotkeys}
FLIGHT = {"ref": ref_flight, "port": port_flight}


def _get_json(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _wait(cond, deadline_s, what):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise TimeoutError(what)


def _clock(module, **fns):
    """A stand-in for `module`'s `time`: the real module with `fns`
    replacing some of its functions."""
    return types.SimpleNamespace(**{
        **{k: getattr(time, k) for k in dir(time) if not k.startswith("_")},
        **fns})


# -- space-saving sketch and hot-key recorder --------------------------------


def test_space_saving_heavy_hitter_guarantee():
    tops = {}
    for pkg, hk in HOTKEYS.items():
        s = hk.SpaceSaving(k=8)
        for i in range(500):
            s.record(f"cold-{i}")
            s.record("hot", 2)
        assert len(s) <= 8
        top = s.top(1)[0]
        assert top["key"] == "hot"
        assert top["count"] - top["error"] <= 1000 <= top["count"]
        tops[pkg] = s.top()
    assert tops["port"] == tops["ref"]


def test_space_saving_eviction_inherits_error():
    got = {}
    for pkg, hk in HOTKEYS.items():
        s = hk.SpaceSaving(k=2)
        s.record("a", 5)
        s.record("b", 3)
        s.record("c")  # evicts b (min=3); c inherits 3 as its error floor
        got[pkg] = {e["key"]: e for e in s.top()}
    assert set(got["port"]) == {"a", "c"}
    assert got["port"]["c"]["count"] == 4 and got["port"]["c"]["error"] == 3
    assert got["port"] == got["ref"]


def test_hotkey_recorder_window_rotation_and_gauge_bound(monkeypatch):
    """The same records on both recorders, the window turned by a pinned
    clock: the same current and previous tables, and the port's top-key
    gauge children stay bounded."""
    from seaweedfs_tpu_torch.stats.metrics import HOTKEY_TOP

    now = [1000.0]
    snaps = {}
    for pkg, hk in HOTKEYS.items():
        monkeypatch.setattr(hk, "time", _clock(hk, time=lambda: now[0]))
        now[0] = 1000.0
        r = hk.HotKeyRecorder(k=16, window_s=0.1)
        for i in range(40):
            r.record("needle", f"3,{i:08x}")
        r.record("bucket", "photos", 7)
        first = r.snapshot()
        assert first["dims"]["bucket"]["current"][0]["key"] == "photos"
        now[0] += 0.15
        second = r.snapshot()  # lazy rotation on read
        assert second["dims"]["bucket"]["previous"][0]["key"] == "photos"
        assert second["dims"]["bucket"]["current"] == []
        snaps[pkg] = [{d: t for d, t in s["dims"].items()}
                      for s in (first, second)]
    assert snaps["port"] == snaps["ref"]
    with HOTKEY_TOP._lock:
        children = len(HOTKEY_TOP._children)
    assert children <= len(port_hotkeys.DIMENSIONS) * \
        port_hotkeys.TOP_GAUGE_KEYS


def test_hotkeys_kill_switch(monkeypatch):
    for hk in HOTKEYS.values():
        monkeypatch.setenv(hk.DISABLE_VAR, "0")
        hk.reset()
        try:
            hk.record("needle", "3,01010101")
            snap = hk.snapshot()
            assert snap["enabled"] is False
            assert snap["dims"]["needle"]["current"] == []
        finally:
            hk.reset()


# -- bundle journey on an in-process cluster ---------------------------------


def test_flight_recorder_bundle_journey(tmp_path, monkeypatch):
    """A port master with -debugDir and a port volume server: the hot
    needle per node and merged at /cluster/hot, a manual capture covering
    both, the listing, the bundle's sections, 404 and the traversal
    guard, retention at 2 (second-resolution names on a pinned clock),
    the single-flight 409, and /cluster/alerts listing the bundles."""
    from seaweedfs_tpu_torch.volume.server import VolumeServer

    monkeypatch.setenv("SEAWEEDFS_TPU_DEBUG_BUNDLE_RETAIN", "2")
    port_hotkeys.reset()
    debug_dir = tmp_path / "debug-bundles"
    master = MasterServer(ip="127.0.0.1", port=free_port(),
                          pulse_seconds=0.5, debug_dir=str(debug_dir))
    master.start()
    vol_dir = tmp_path / "vol"
    vol_dir.mkdir()
    vs = VolumeServer(
        directories=[str(vol_dir)],
        master_addresses=[f"127.0.0.1:{master.grpc_port}"],
        ip="127.0.0.1", port=free_port(), pulse_seconds=0.5,
        max_volume_count=8, codec_name="cpu")
    vs.start()
    base = f"http://127.0.0.1:{master.port}"
    try:
        _wait(lambda: master.topo.nodes, 15, "node registered")
        _get_json(f"{base}/vol/grow?count=2")
        a = _get_json(f"{base}/dir/assign?count=1")
        req = urllib.request.Request(
            f"http://{a['url']}/{a['fid']}", data=b"x" * 256,
            headers={"Content-Type": "application/octet-stream"},
            method="POST")
        urllib.request.urlopen(req, timeout=10).read()
        urllib.request.urlopen(
            f"http://{a['url']}/{a['fid']}", timeout=10).read()

        hot = _get_json(f"http://{a['url']}/debug/hot")
        assert a["fid"] in {e["key"] for e in hot["dims"]["needle"]["current"]}
        merged = _get_json(f"{base}/cluster/hot?n=16")
        assert a["fid"] in {e["key"]
                            for e in merged["dims"]["needle"]["current"]}
        assert f"127.0.0.1:{vs.port}" in merged["nodes"]
        assert _get_json(f"{base}/cluster/hot")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get_json(f"{base}/cluster/hot?n=0")
        assert ei.value.code == 400

        meta = _get_json(f"{base}/cluster/debug/capture", timeout=30)
        assert meta["trigger"] == "manual" and meta["sizeBytes"] > 0
        assert f"127.0.0.1:{vs.port}" in meta["nodes"]
        assert f"127.0.0.1:{master.port}" in meta["nodes"]
        doc = _get_json(f"{base}/cluster/debug")
        assert doc["debugDir"] == str(debug_dir) and doc["retain"] == 2
        assert [b["name"] for b in doc["bundles"]] == [meta["name"]]

        bundle = _get_json(f"{base}/cluster/debug?bundle={meta['name']}")
        assert bundle["trigger"] == "manual"
        vol_sections = bundle["nodes"][f"127.0.0.1:{vs.port}"]
        assert "seaweedfs_" in vol_sections["metrics"]
        assert "traces" in vol_sections["spans"]
        assert "windows" in vol_sections["profile"]
        assert a["fid"] in json.dumps(vol_sections["hot"])
        assert "states" in bundle["cluster"]["sloStates"]
        assert "lifecycle" in bundle["cluster"]

        with pytest.raises(urllib.error.HTTPError) as ei:
            _get_json(f"{base}/cluster/debug?bundle=bundle-nope")
        assert ei.value.code == 404
        assert master.flight.bundle("../../etc/passwd") is None
        assert master.flight.bundle("bundle-x/../y") is None

        # retention: two more captures, each stamped a second later on a
        # pinned clock, prune down to the newest 2
        stamp = [time.time() + 10]

        def gmtime(*_a):
            stamp[0] += 1.0
            return time.gmtime(stamp[0])

        monkeypatch.setattr(port_flight, "time",
                            _clock(port_flight, gmtime=gmtime))
        for _ in range(2):
            _get_json(f"{base}/cluster/debug/capture", timeout=30)
        names = [b["name"] for b in master.flight.list_bundles()]
        assert len(names) == 2 and meta["name"] not in names

        assert master.flight._capture_lock.acquire(blocking=False)
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get_json(f"{base}/cluster/debug/capture")
            assert ei.value.code == 409
        finally:
            master.flight._capture_lock.release()

        alerts = _get_json(f"{base}/cluster/alerts")
        assert sorted(b["name"] for b in alerts["debugBundles"]) \
            == sorted(names)
    finally:
        vs.stop()
        master.stop()
        port_hotkeys.reset()


def test_flight_recorder_memory_ring_and_sink_gating(tmp_path):
    """No -debugDir: bundles land in a bounded in-memory ring.  The SLO
    sink captures only on a firing transition (no capture thread starts
    for ok or pending) and a second page within the cooldown starts
    none either."""
    master = MasterServer(ip="127.0.0.1", port=free_port(),
                          pulse_seconds=0.5)
    master.start()
    try:
        fr = master.flight
        assert fr.debug_dir == "" and fr.list_bundles() == []
        fr.cooldown_s = 3600.0
        fr.sink({"state": "ok", "slo": "availability"})
        fr.sink({"state": "pending", "slo": "availability"})
        assert fr._threads == [] and fr.list_bundles() == []

        fr.sink({"state": "firing", "slo": "availability",
                 "severity": "page", "exemplars": []})
        assert len(fr._threads) == 1
        fr._threads[0].join(timeout=20)
        assert len(fr.list_bundles()) == 1
        fr.sink({"state": "firing", "slo": "availability",
                 "severity": "page", "exemplars": []})
        assert len(fr._threads) == 1  # the cooldown coalesced it
        assert len(fr.list_bundles()) == 1

        doc = fr.bundle(fr.list_bundles()[0]["name"])
        assert doc["trigger"] == "alert"
        assert doc["alert"]["slo"] == "availability"

        fr.cooldown_s = 0.0
        for _ in range(fr.retain + 2):
            fr.capture(trigger="manual")
        assert len(fr.list_bundles()) == fr.retain
    finally:
        master.stop()


class _StubMaster:
    """What FlightRecorder.sink reads before it starts a capture."""

    def __init__(self):
        self._stop = threading.Event()


@pytest.mark.parametrize("pkg,captures", [("ref", False), ("port", True)])
def test_first_page_captured_on_a_young_machine(monkeypatch, pkg,
                                                captures):
    """`time.monotonic` pinned to 100.0, a machine up 100 s, and the
    cooldown at an hour as the reference's own test sets it: the
    reference's cooldown clock starts at 0.0, so it drops the first page
    (a reference fault); the port's counts only from a capture that
    happened, so it captures."""
    mod = FLIGHT[pkg]
    monkeypatch.setattr(mod, "time", _clock(mod, monotonic=lambda: 100.0))
    fr = mod.FlightRecorder(_StubMaster(), cooldown_s=3600.0)
    started = []
    monkeypatch.setattr(fr, "_capture_safe",
                        lambda trigger, alert: started.append(trigger))
    fr.sink({"state": "firing", "slo": "availability", "severity": "page"})
    for th in getattr(fr, "_threads", []):
        th.join(timeout=10)
    deadline = time.monotonic() + 10
    while captures and not started and time.monotonic() < deadline:
        time.sleep(0.01)  # the reference's capture thread is not kept
    assert started == (["alert"] if captures else [])
    if pkg == "port":
        # the cooldown now counts from that capture
        fr._last_capture = 100.0
        fr.sink({"state": "firing", "slo": "availability"})
        assert started == ["alert"]


# -- chaos: alert-triggered auto-capture under load ---------------------------

PULSE_S = 3.0
WINDOW_SCALE = 0.005
CANARY_TICK_S = 0.3
SLO_TICK_S = 0.4


def _spawn_volume(tmp_path, i, master_port):
    d = tmp_path / f"vol{i}"
    d.mkdir()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
         "-dir", str(d), "-mserver", f"127.0.0.1:{master_port}",
         "-ip", "127.0.0.1", "-port", str(port), "-ec.codec", "cpu",
         "-rack", f"rack{i % 2}", "-max", "30"],
        cwd=str(tmp_path), env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    return proc, f"127.0.0.1:{port}"


@pytest.mark.chaos
def test_chaos_page_auto_captures_bundle(tmp_path, monkeypatch):
    """A port master and four port volume processes: a volume-holding
    node SIGKILLed under canary load fires the availability page, and
    the flight recorder captures a bundle on its own covering every live
    node with the alert's exemplar trace pinned."""
    monkeypatch.setenv("SEAWEEDFS_TPU_DEBUG_BUNDLE_COOLDOWN_S", "0")
    debug_dir = tmp_path / "debug-bundles"
    master = MasterServer(
        ip="127.0.0.1", port=free_port(), pulse_seconds=PULSE_S,
        slo_interval=SLO_TICK_S, canary_interval=0.0,
        slo_window_scale=WINDOW_SCALE, debug_dir=str(debug_dir))
    master.canary.timeout_s = 5.0
    master.start()
    procs = []
    try:
        nodes = []
        for i in range(4):
            proc, addr = _spawn_volume(tmp_path, i, master.port)
            procs.append(proc)
            nodes.append(addr)
        _wait(lambda: len(master.topo.nodes) == 4, 60, "4 registered")

        def covered():
            with master.topo.lock:
                return sum(1 for n in master.topo.nodes.values()
                           if n.volumes) == 4

        for _ in range(8):
            if covered():
                break
            _get_json(f"http://127.0.0.1:{master.port}/vol/grow?count=4")
            try:
                _wait(covered, 6, "every node holds a volume")
            except TimeoutError:
                pass
        assert covered()
        master.canary.interval_s = CANARY_TICK_S
        master.canary.start()
        _wait(lambda: master.canary.status()["tick"] >= 3, 30, "canary")
        pre = {b["name"] for b in master.flight.list_bundles()}
        victim = procs[0]
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=10)
        _wait(lambda: any(h["state"] == "firing"
                          and h["slo"] == "availability"
                          for h in list(master.slo.alert_history)),
              3 * PULSE_S + 30.0, "availability page alert")

        def alert_bundle():
            for b in master.flight.list_bundles():
                if "-alert-" in b["name"] and b["name"] not in pre:
                    return master.flight.bundle(b["name"])
            return None

        _wait(lambda: alert_bundle() is not None, 30, "bundle captured")
        bundle = alert_bundle()
        for addr in nodes[1:] + [f"127.0.0.1:{master.port}"]:
            assert addr in bundle["nodes"], sorted(bundle["nodes"])
            assert "seaweedfs_" in bundle["nodes"][addr].get("metrics", "")
        alert = bundle["alert"]
        assert alert["slo"] == "availability" and alert.get("exemplars")
        assert bundle["exemplarTrace"]["traceId"] \
            == alert["exemplars"][0]["traceId"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=10)
        master.stop()
