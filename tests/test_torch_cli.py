"""`python -m seaweedfs_tpu_torch` as an operator runs it: a master and
two volume servers as real processes (the cluster of
tests/test_cli_processes.py, with a second volume server where that one
has a filer, which the port does not have yet), needles written through
assigns and `ec.encode` run by `shell -c`; SIGTERM stops each process
cleanly.  The volume's `-tierBackends` and `-offset.5bytes` serve
needles from a remote tier and from a 5-byte-offset volume, and a master
takes a lifecycle policy naming a tier backend.  Then the refusals: a
`volume` with no codec on this card-less host names the card, the TPU
codec names are refused naming `cuda`, a subcommand, plane flag or TLS
setting not ported yet exits naming its ROADMAP item, the judgment,
flight-recorder and quorum flags build their planes, and the entry
point's modules import neither jax nor any module of seaweedfs_tpu."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
from helpers import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 30.0


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _cli(args, cwd, timeout=60, **env):
    return subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", *args], cwd=cwd,
        env=_env(**env), capture_output=True, text=True, timeout=timeout)


def _spawn(args, cwd, log):
    return subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", *args], cwd=cwd,
        env=_env(), stdout=log, stderr=subprocess.STDOUT)


def _get_json(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _wait(cond, what, procs=(), timeout=DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for p in procs:
            assert p.poll() is None, f"a process exited {p.returncode} " \
                                     f"while waiting for {what}"
        try:
            got = cond()
            if got:
                return got
        except (urllib.error.URLError, OSError, KeyError, ValueError):
            pass
        time.sleep(0.1)
    raise AssertionError(f"{what}: not within {timeout} s")


def test_cli_three_process_cluster_encodes_from_the_shell(tmp_path):
    mport = free_port()
    vports = [free_port(), free_port()]
    logs = {n: open(tmp_path / f"{n}.log", "wb")
            for n in ("master", "v0", "v1")}
    procs = {}
    try:
        procs["master"] = _spawn(
            ["master", "-port", str(mport), "-volumeSizeLimitMB", "64"],
            str(tmp_path), logs["master"])
        _wait(lambda: _get_json(
            f"http://127.0.0.1:{mport}/cluster/healthz")["ok"],
            "the master", procs.values())
        for i, vp in enumerate(vports):
            d = tmp_path / f"v{i}"
            d.mkdir()
            procs[f"v{i}"] = _spawn(
                ["volume", "-dir", str(d), "-port", str(vp), "-mserver",
                 f"127.0.0.1:{mport}", "-ec.codec=cpu", "-max", "20",
                 "-rack", f"rack{i}"], str(tmp_path), logs[f"v{i}"])
        _wait(lambda: len(_get_json(f"http://127.0.0.1:{mport}/dir/status")
                          ["DataNodes"]) == 2, "two volume servers",
              procs.values())
        fids = {}
        for i in range(12):
            a = _get_json(f"http://127.0.0.1:{mport}/dir/assign"
                          "?collection=cli")
            payload = f"needle {i} ".encode() * (50 + i)
            req = urllib.request.Request(f"http://{a['url']}/{a['fid']}",
                                         data=payload, method="POST")
            with urllib.request.urlopen(req, timeout=10) as r:
                assert r.status == 201
            fids[a["fid"]] = payload
        vid = int(next(iter(fids)).split(",")[0])
        fids = {f: p for f, p in fids.items()
                if int(f.split(",")[0]) == vid}
        out = _cli(["shell", "-master", f"127.0.0.1:{mport}", "-c",
                    f"ec.encode -volumeId={vid}"], str(tmp_path))
        assert out.returncode == 0, out.stderr
        assert f"ec.encode {vid}: spread" in out.stdout

        def fourteen():
            doc = _get_json(f"http://127.0.0.1:{mport}/dir/status")
            return sorted(s for n in doc["DataNodes"].values()
                          for s in n["ecShards"].get(str(vid), [])) \
                == list(range(14))
        _wait(fourteen, "14 shards at the master", procs.values())
        out = _cli(["shell", "-master", f"127.0.0.1:{mport}", "-c",
                    "volume.list"], str(tmp_path))
        assert out.returncode == 0 and f"ec{vid}[" in out.stdout
        for fid, payload in fids.items():
            for vp in vports:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{vp}/{fid}", timeout=10) as r:
                    assert r.read() == payload
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs = {}
        for name, p in procs.items():
            try:
                rcs[name] = p.wait(timeout=DEADLINE_S)
            except subprocess.TimeoutExpired:
                p.kill()
                rcs[name] = "killed"
        for f in logs.values():
            f.close()
    assert rcs == {"master": 0, "v0": 0, "v1": 0}
    for name in logs:
        text = (tmp_path / f"{name}.log").read_text(errors="replace")
        assert "Traceback" not in text, text[-3000:]


def test_volume_without_a_codec_needs_the_card(tmp_path):
    """No -ec.codec: the default is cuda, and this host has no card."""
    out = _cli(["volume", "-dir", str(tmp_path), "-port", str(free_port()),
                "-mserver", "127.0.0.1:1"], str(tmp_path),
               CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "CUDA card" in out.stderr and "-ec.codec=cpu" in out.stderr
    assert len(out.stderr.strip().splitlines()) == 1


@pytest.mark.parametrize("name", ["cuda_xor", "cuda_bitplane"])
def test_the_other_device_codecs_need_the_card(tmp_path, name):
    """-ec.codec=cuda_xor | cuda_bitplane are device codecs: on a host
    without a card the volume exits naming the card, as `cuda` does."""
    out = _cli(["volume", "-dir", str(tmp_path), "-port", str(free_port()),
                "-mserver", "127.0.0.1:1", f"-ec.codec={name}"],
               str(tmp_path), CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "CUDA card" in out.stderr and f"-ec.codec={name}" in out.stderr


@pytest.mark.parametrize("name", ["tpu", "tpu_xor", "tpu_mxu", "pallas",
                                  "tpu_pallas", "jax", "mxu"])
def test_tpu_codec_names_are_refused_naming_cuda(tmp_path, name):
    out = _cli(["volume", "-dir", str(tmp_path), "-port", str(free_port()),
                f"-ec.codec={name}"], str(tmp_path))
    assert out.returncode == 2
    assert "names a TPU codec" in out.stderr and "'cuda'" in out.stderr


@pytest.mark.parametrize("cmd", ["volume", "server"])
def test_tpu_codec_type_in_master_toml_is_refused(tmp_path, cmd):
    (tmp_path / "master.toml").write_text('[codec]\ntype = "tpu"\n')
    out = _cli([cmd, "-dir", str(tmp_path), "-port", str(free_port())],
               str(tmp_path))
    assert out.returncode == 2
    assert "codec.type" in out.stderr and "'cuda'" in out.stderr


def test_codec_type_in_master_toml_is_read(tmp_path):
    """master.toml's [codec].type is the volume's codec when the flag is
    not given: `cpu` there starts a server on this card-less host."""
    (tmp_path / "master.toml").write_text('[codec]\ntype = "cpu"\n')
    port = free_port()
    with open(tmp_path / "v.log", "wb") as log:
        p = _spawn(["volume", "-dir", str(tmp_path), "-port", str(port),
                    "-mserver", "127.0.0.1:1"], str(tmp_path), log)
        try:
            _wait(lambda: (tmp_path / "v.log").read_text().count(
                "codec=cpu"), "the server's start line", [p])
        finally:
            p.send_signal(signal.SIGTERM)
            assert p.wait(timeout=DEADLINE_S) == 0


@pytest.mark.parametrize("cmd,item", [
    ("filer", "A-7"), ("s3", "A-7"), ("mount", "A-7"), ("webdav", "A-7"),
    ("benchmark", "A-6"), ("scaffold", "A-6"), ("backup", "A-6"),
])
def test_subcommands_not_ported_exit_2_naming_the_roadmap(tmp_path, cmd,
                                                          item):
    out = _cli([cmd, "-port", "1"], str(tmp_path))
    assert out.returncode == 2
    assert "not ported yet" in out.stderr and f"ROADMAP {item}" in out.stderr
    assert len(out.stderr.strip().splitlines()) == 1


@pytest.mark.parametrize("argv,words", [
    (["master", "-peerClusters", "127.0.0.1:1"], "A-7"),
    (["server", "-filer", "-ec.codec=cpu"], "A-7"),
])
def test_left_out_plane_flags_exit_nonzero(tmp_path, argv, words):
    p = free_port()
    argv = [a.replace("{p}", str(p)) for a in argv] + [
        "-port", str(p)]
    if argv[0] != "master":
        argv += ["-dir", str(tmp_path)]
    out = _cli(argv, str(tmp_path))
    assert out.returncode != 0
    assert words in out.stderr and "not ported yet" in out.stderr


def _stop_all(procs, logs) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        assert p.wait(timeout=DEADLINE_S) == 0
    for log in logs:
        assert "Traceback" not in log.read_text()


@pytest.mark.parametrize("case", ["slo_canary_debug", "slo_default",
                                  "quorum"])
def test_judgment_and_quorum_flags_are_live(tmp_path, case):
    """The master's -sloInterval, -sloSpecs (a JSON file of specs),
    -canaryInterval, -alertWebhook and -debugDir build the SLO engine,
    the canary and the flight recorder, as /cluster/alerts and
    /cluster/debug show; -sloInterval defaults to the reference's 15 s;
    two masters naming each other in -peers, each with its -raftDir,
    elect one leader that both report, and the follower redirects an
    assign to it.  SIGTERM exits 0 everywhere."""
    procs, logs = [], []
    ports = [free_port() for _ in range(2 if case == "quorum" else 1)]
    flags = {p: [] for p in ports}
    if case == "slo_canary_debug":
        (tmp_path / "specs.json").write_text(json.dumps([{
            "name": "only", "severity": "warn", "kind": "gauge",
            "family": "seaweedfs_lifecycle_queue_depth",
            "threshold": 5.0}]))
        flags[ports[0]] = ["-sloInterval", "1", "-sloSpecs", "specs.json",
                           "-canaryInterval", "2", "-alertWebhook",
                           "http://127.0.0.1:1/hook", "-debugDir", "dbg"]
    elif case == "quorum":
        peers = ",".join(f"127.0.0.1:{p}" for p in ports)
        for p in ports:
            (tmp_path / f"raft{p}").mkdir()
            flags[p] = ["-ip", "127.0.0.1", "-peers", peers, "-raftDir",
                        f"raft{p}"]
    try:
        for p in ports:
            log = tmp_path / f"master{p}.log"
            logs.append(log)
            with open(log, "wb") as f:
                procs.append(_spawn(["master", "-port", str(p),
                                     *flags[p]], str(tmp_path), f))
        if case != "quorum":
            doc = _wait(lambda: _get_json(
                f"http://127.0.0.1:{ports[0]}/cluster/alerts"),
                "/cluster/alerts", procs)
            if case == "slo_default":
                assert doc["intervalS"] == 15.0
                assert len(doc["specs"]) == 10
                assert not doc["canary"]["running"]
                return
            assert doc["intervalS"] == 1.0
            assert [sp["name"] for sp in doc["specs"]] == ["only"]
            assert doc["canary"]["interval_s"] == 2.0
            assert doc["canary"]["running"]
            dbg = _get_json(f"http://127.0.0.1:{ports[0]}/cluster/debug")
            assert dbg["debugDir"] == "dbg" and dbg["bundles"] == []
            assert (tmp_path / "dbg").is_dir()
            return

        def one_leader():
            docs = [_get_json(f"http://127.0.0.1:{p}/cluster/status")
                    for p in ports]
            leaders = {d["Leader"] for d in docs}
            roles = sorted(d["Raft"]["role"] for d in docs)
            if roles == ["follower", "leader"] and len(leaders) == 1:
                return docs
            return None

        docs = _wait(one_leader, "one leader both masters report", procs)
        leader = docs[0]["Leader"]
        follower = next(p for p in ports if f"127.0.0.1:{p}" != leader)
        req = urllib.request.Request(
            f"http://127.0.0.1:{follower}/dir/assign")

        class NoRedirect(urllib.request.HTTPRedirectHandler):
            def redirect_request(self, *a, **k):
                return None

        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.build_opener(NoRedirect).open(req, timeout=10)
        assert e.value.code == 307
        assert e.value.headers["Location"].startswith(f"http://{leader}/")
        for p in ports:
            assert (tmp_path / f"raft{p}" / f"raft-{p}.json").exists()
    finally:
        _stop_all(procs, logs)


@pytest.mark.parametrize("flag", ["-tierBackends", "-offset.5bytes"])
def test_volume_tier_and_offset_flags_are_live(tmp_path, flag):
    """`-tierBackends` registers the JSON file's S3 tier, so a volume
    whose .vif places its .dat in the S3 stub loads and serves GETs by
    ranged reads; `-offset.5bytes` makes the process read a volume with
    17-byte index entries (written by the reference at 5 bytes).  Each
    needle comes back equal; SIGTERM exits 0."""
    from helpers import make_volume, start_s3_stub

    from seaweedfs_tpu.storage import types as rt
    from seaweedfs_tpu.storage.backend_s3 import make_s3_backend

    stub, handler = start_s3_stub()
    try:
        argv = []
        if flag == "-offset.5bytes":
            rt.set_offset_size(5)
        try:
            vol = make_volume(str(tmp_path), volume_id=3, n_needles=20,
                              seed=2)
            want = {i: (vol.read_needle(i).cookie, vol.read_needle(i).data)
                    for i in (1, 11, 20)}
            if flag == "-tierBackends":
                conf = {"endpoint": f"http://127.0.0.1:"
                                    f"{stub.server_address[1]}",
                        "bucket": "cli"}
                make_s3_backend("cli", conf)
                # the local copy stays: a location discovers its volumes
                # by their .dat files, as the reference's does
                vol.tier_to_remote("s3.cli", keep_local=True)
                (tmp_path / "t.json").write_text(json.dumps(
                    {"s3.cli": conf}))
                argv = ["-tierBackends", "t.json"]
            else:
                assert os.path.getsize(tmp_path / "3.idx") == 20 * 17
                argv = ["-offset.5bytes"]
            vol.close()
        finally:
            rt.set_offset_size(4)
        port = free_port()
        reads = handler.range_reads
        with open(tmp_path / "v.log", "wb") as log:
            p = _spawn(["volume", "-dir", str(tmp_path), "-port", str(port),
                        "-mserver", "127.0.0.1:1", "-ec.codec=cpu", *argv],
                       str(tmp_path), log)
            try:
                _wait(lambda: (tmp_path / "v.log").read_text().count(
                    "codec=cpu"), "the server's start line", [p])
                for key, (cookie, data) in want.items():
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/3,{key:x}"
                            f"{cookie:08x}", timeout=10) as r:
                        assert r.read() == data
                assert (handler.range_reads > reads) \
                    == (flag == "-tierBackends")
            finally:
                p.send_signal(signal.SIGTERM)
                assert p.wait(timeout=DEADLINE_S) == 0
    finally:
        stub.shutdown()
        stub.server_close()
    assert "Traceback" not in (tmp_path / "v.log").read_text()


def test_lifecycle_flags_are_live(tmp_path):
    """-lifecycleInterval, -lifecycleDir, -lifecycleRateMBps,
    -lifecyclePolicy (a JSON file) and -repairDeadlineS reach the
    master's maintenance plane, as /cluster/lifecycle and /vol/repair
    show; SIGTERM still exits 0."""
    (tmp_path / "policy.json").write_text(
        json.dumps({"*": {"ec_cooldown_seconds": 5}}))
    (tmp_path / "lc").mkdir()
    port = free_port()
    with open(tmp_path / "master.log", "wb") as log:
        p = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "master", "-port",
             str(port), "-lifecycleInterval", "7", "-lifecycleDir",
             str(tmp_path / "lc"), "-lifecycleRateMBps", "8",
             "-lifecyclePolicy", "policy.json", "-repairDeadlineS", "90"],
            cwd=str(tmp_path), env=_env(), stdout=log,
            stderr=subprocess.STDOUT)
        try:
            # the master serves HTTP before it starts its lifecycle thread
            # (as the reference's does), so wait for a document that shows
            # the loop running, not for the first answer
            def lifecycle():
                doc = _get_json(
                    f"http://127.0.0.1:{port}/cluster/lifecycle")
                return doc if doc["enabled"] and doc["running"] else None
            doc = _wait(lifecycle, "/cluster/lifecycle running", [p])
            assert doc["enabled"] and doc["running"]
            assert (doc["intervalSeconds"], doc["rateMBps"]) == (7.0, 8.0)
            assert doc["journalPath"] == str(
                tmp_path / "lc" / "lifecycle.journal.jsonl")
            assert doc["policies"]["*"]["ec_cooldown_seconds"] == 5
            mr = _get_json(f"http://127.0.0.1:{port}/vol/repair")[
                "massRepair"]
            assert mr["enabled"] and mr["deadlineSeconds"] == 90
        finally:
            p.send_signal(signal.SIGTERM)
            rc = p.wait(timeout=DEADLINE_S)
    assert rc == 0
    assert "Traceback" not in (tmp_path / "master.log").read_text()


@pytest.mark.parametrize("flags", [
    ["-lifecyclePolicy", "lifecycle.policy.json"],
    ["-lifecycleDir", "."],  # the policy a reference master persisted
])
def test_lifecycle_policy_with_a_tier_backend_is_accepted(tmp_path, flags):
    """A policy naming a tier backend, from -lifecyclePolicy or the file
    a master persisted in -lifecycleDir, reaches the controller, as
    /cluster/lifecycle shows; SIGTERM exits 0."""
    (tmp_path / "lifecycle.policy.json").write_text(json.dumps(
        {"*": {"ec_cooldown_seconds": 0, "tier_backend": "s3.cold"}}))
    port = free_port()
    with open(tmp_path / "master.log", "wb") as log:
        p = _spawn(["master", "-port", str(port), *flags], str(tmp_path),
                   log)
        try:
            doc = _wait(lambda: _get_json(
                f"http://127.0.0.1:{port}/cluster/lifecycle"),
                "/cluster/lifecycle", [p])
            assert doc["policies"]["*"]["tier_backend"] == "s3.cold"
            assert doc["policies"]["*"]["ec_cooldown_seconds"] == 0
        finally:
            p.send_signal(signal.SIGTERM)
            assert p.wait(timeout=DEADLINE_S) == 0


def test_grpc_tls_in_security_toml_is_refused(tmp_path):
    (tmp_path / "security.toml").write_text(
        '[jwt.signing]\nkey = "k"\n[grpc]\nca = "ca.crt"\n'
        '[grpc.master]\ncert = "m.crt"\nkey = "m.key"\n')
    out = _cli(["master", "-port", str(free_port())], str(tmp_path))
    assert out.returncode == 2
    assert "grpc.ca" in out.stderr and "ROADMAP A-6" in out.stderr


def test_security_toml_jwt_key_and_white_list_are_read(tmp_path,
                                                        monkeypatch):
    """security.toml's [jwt.signing].key and [guard].white_list are read
    as the reference reads them, and a master started there signs its
    assigns (the token verifies against the key, byte for byte as the
    reference's)."""
    from seaweedfs_tpu.cli import (_security_jwt_key as ref_key,
                                   _security_white_list as ref_wl)
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.master.server import MasterServer

    (tmp_path / "security.toml").write_text(
        '[jwt.signing]\nkey = "k1"\n[guard]\nwhite_list = ["10.0.0.1"]\n')
    monkeypatch.chdir(tmp_path)
    assert cli._security_jwt_key() == ref_key() == "k1"
    assert cli._security_white_list() == ref_wl() == ["10.0.0.1"]
    m = MasterServer(port=free_port(), jwt_signing_key=cli._security_jwt_key())
    from seaweedfs_tpu.security.jwt import verify_write_jwt

    assert verify_write_jwt(b"k1", m.sign_fid("3,01637037d6"), "3,01637037d6")


def test_version():
    out = _cli(["version"], REPO)
    assert out.returncode == 0 and out.stdout.strip() \
        == "seaweedfs_tpu_torch 0.1.0"


def test_entry_point_imports_no_jax_and_no_reference_module():
    code = ("import sys, seaweedfs_tpu_torch.cli, "
            "seaweedfs_tpu_torch.master.server, "
            "seaweedfs_tpu_torch.shell.commands, "
            "seaweedfs_tpu_torch.volume.server\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'seaweedfs_tpu' "
            "or m.startswith('seaweedfs_tpu.'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)")
    env = _env()
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("[]")
