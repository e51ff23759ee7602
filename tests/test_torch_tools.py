"""The port's operator tools held against the reference's
(tests/test_tools.py, tests/test_client_tools.py): `export` writes the
same tar, member for member and byte for byte, and `fix` rebuilds the
same `.idx` bytes, from the same `.dat`; the CLI's `fix`, `export` and
`compact` run on a reference volume; the benchmark runs against a port
and a reference cluster; upload and download cross the packages; an
incremental backup of either package's volume server by either package's
`backup` appends the needles the reference appends against itself; and
`filer.copy` / `filer.cat` copy a tree into a port and a reference filer
and read it back."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tarfile
import time

import numpy as np
import pytest
from helpers import free_port

from seaweedfs_tpu.storage.needle import FLAG_HAS_NAME, Needle
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu.tools import backup as ref_backup
from seaweedfs_tpu.tools import offline as ref_offline
from seaweedfs_tpu_torch.tools import backup, offline
from seaweedfs_tpu_torch.tools.benchmark import run_benchmark

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0_NS = 1_700_000_000_000_000_000


def _ref_volume(directory, vid=7, n=24, named=True, seed=3, collection=""):
    """A reference-written volume: seeded needles with fixed write times,
    named or not, with a delete and an overwrite."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    v = RefVolume(str(directory), collection, vid)
    for i in range(n):
        nd = Needle(cookie=int(rng.integers(0, 2**32)), id=i + 1,
                    data=rng.integers(0, 256, int(rng.integers(1, 3000)),
                                      dtype=np.uint8).tobytes())
        if named and i % 4:
            nd.set(FLAG_HAS_NAME)
            nd.name = f"file{i}.txt".encode()
        nd.append_at_ns = T0_NS + i * 1_000_000_000
        v.append_needle(nd)
    v.delete_needle(3, at_ns=T0_NS + 99_000_000_000)
    v.append_needle(Needle(cookie=5, id=5, data=b"overwritten" * 7,
                           append_at_ns=T0_NS + 100_000_000_000))
    v.close()
    return vid


def _copy_dir(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def test_scan_dat_file_is_the_references(tmp_path):
    _ref_volume(tmp_path)
    dat = str(tmp_path / "7.dat")
    got = [(o, n.id, n.cookie, bytes(n.data), n.append_at_ns)
           for o, n in offline.scan_dat_file(dat)]
    want = [(o, n.id, n.cookie, bytes(n.data), n.append_at_ns)
            for o, n in ref_offline.scan_dat_file(dat)]
    assert got == want and len(got) == 26


@pytest.mark.parametrize("named,newer", [(True, 0), (False, 0),
                                         (True, T0_NS + 10_000_000_000)])
def test_export_writes_the_references_tar(tmp_path, named, newer):
    _ref_volume(tmp_path / "v", named=named)
    outs = {}
    for label, mod in (("port", offline), ("ref", ref_offline)):
        outs[label] = str(tmp_path / f"{label}.tar")
        count = mod.export_volume(str(tmp_path / "v"), 7,
                                  output=outs[label], newer_than_ns=newer)
        outs[label + "_count"] = count
    assert outs["port_count"] == outs["ref_count"] > 0
    members = {}
    for label in ("port", "ref"):
        with tarfile.open(outs[label]) as tar:
            members[label] = [(m.name, m.size, m.mtime,
                               tar.extractfile(m).read())
                              for m in tar.getmembers()]
    assert members["port"] == members["ref"]
    with open(outs["port"], "rb") as a, open(outs["ref"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("corruption", ["garbage", "truncated", "missing"])
def test_fix_rebuilds_the_references_idx(tmp_path, corruption):
    _ref_volume(tmp_path / "v")
    want_live = None
    idx_bytes = {}
    for label, mod in (("port", offline), ("ref", ref_offline)):
        d = _copy_dir(tmp_path / "v", tmp_path / label)
        idx = os.path.join(d, "7.idx")
        if corruption == "garbage":
            with open(idx, "wb") as f:
                f.write(b"garbage!" * 3)
        elif corruption == "truncated":
            with open(idx, "r+b") as f:
                f.truncate(os.path.getsize(idx) // 2)
        else:
            os.remove(idx)
        live = mod.fix_index(d, 7)
        assert want_live in (None, live)
        want_live = live
        with open(idx, "rb") as f:
            idx_bytes[label] = f.read()
    assert want_live == 23  # 24 written, 1 deleted (the overwrite is live)
    assert idx_bytes["port"] == idx_bytes["ref"]


def _cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


@pytest.mark.parametrize("cmd", ["fix", "export", "compact"])
def test_offline_subcommands_run_on_a_reference_volume(tmp_path, cmd):
    _ref_volume(tmp_path / "v", collection="c")
    d = _copy_dir(tmp_path / "v", tmp_path / "port")
    ref_d = _copy_dir(tmp_path / "v", tmp_path / "ref")
    out = _cli([cmd, "-dir", d, "-volumeId", "7", "-collection", "c"]
               + (["-o", str(tmp_path / "port.tar")] if cmd == "export"
                  else []), str(tmp_path))
    assert out.returncode == 0, out.stderr
    if cmd == "fix":
        ref_offline.fix_index(ref_d, 7, "c")
        for ext in (".idx", ".dat"):
            with open(os.path.join(d, "c_7" + ext), "rb") as a, \
                    open(os.path.join(ref_d, "c_7" + ext), "rb") as b:
                assert a.read() == b.read()
    elif cmd == "export":
        assert out.stdout.strip() == \
            f"exported 23 needles to {tmp_path / 'port.tar'}"
        ref_offline.export_volume(ref_d, 7, "c", str(tmp_path / "ref.tar"))
        with open(tmp_path / "port.tar", "rb") as a, \
                open(tmp_path / "ref.tar", "rb") as b:
            assert a.read() == b.read()
    else:
        assert out.stdout.strip() == "compacted volume 7"
        from seaweedfs_tpu.storage.vacuum import vacuum_volume

        rv = RefVolume(ref_d, "c", 7)
        vacuum_volume(rv)
        rv.close()
        got, want = RefVolume(d, "c", 7), RefVolume(ref_d, "c", 7)
        try:
            keys = [nv.key for nv in want.needle_map.items_ascending()]
            assert keys == [nv.key for nv in got.needle_map.items_ascending()]
            assert len(keys) == 23
            for k in keys:
                assert bytes(got.read_needle(k).data) == \
                    bytes(want.read_needle(k).data)
            assert os.path.getsize(os.path.join(d, "c_7.dat")) == \
                os.path.getsize(os.path.join(ref_d, "c_7.dat"))
        finally:
            got.close()
            want.close()


# -- clusters: a port and a reference master + volume server + filer -------


def _wait(cond, what, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(what)


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    from seaweedfs_tpu.filer.server import FilerServer as RefFiler
    from seaweedfs_tpu.master.server import MasterServer as RefMaster
    from seaweedfs_tpu.volume.server import VolumeServer as RefVolumeServer
    from seaweedfs_tpu_torch.filer.server import FilerServer
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.volume.server import VolumeServer

    out, started = {}, []
    try:
        for label, M, V, F, kw in (
                ("port", MasterServer, VolumeServer, FilerServer,
                 {"codec_name": "cpu"}),
                ("ref", RefMaster, RefVolumeServer, RefFiler, {})):
            m = M(ip="127.0.0.1", port=free_port(), volume_size_limit_mb=64)
            m.start()
            started.append(m)
            v = V(directories=[str(tmp_path_factory.mktemp(f"{label}vol"))],
                  master_addresses=[f"127.0.0.1:{m.grpc_port}"],
                  ip="127.0.0.1", port=free_port(), pulse_seconds=0.5,
                  max_volume_count=100, **kw)
            v.start()
            started.append(v)
            _wait(lambda: len(m.topo.nodes) == 1, f"{label} heartbeat")
            f = F(masters=[f"127.0.0.1:{m.grpc_port}"], ip="127.0.0.1",
                  port=free_port(), store="memory", max_mb=1)
            f.start()
            started.append(f)
            out[label] = {"master": m, "volume": v, "filer": f,
                          "maddr": f"127.0.0.1:{m.port}",
                          "faddr": f"127.0.0.1:{f.port}"}
        yield out
    finally:
        for s in reversed(started):
            s.stop()


@pytest.mark.parametrize("cluster", ["port", "ref"])
def test_benchmark_smoke(stacks, cluster):
    stats = run_benchmark(master=stacks[cluster]["maddr"], num_files=24,
                          file_size=512, concurrency=4, collection="bench")
    assert len(stats["write"].latencies_ms) == 24
    assert stats["write"].failed == 0
    assert len(stats["read"].latencies_ms) == 24
    assert stats["read"].failed == 0


@pytest.mark.parametrize("uploader,downloader", [("port", "ref"),
                                                 ("ref", "port"),
                                                 ("port", "port")])
def test_upload_download_roundtrip(stacks, tmp_path, uploader, downloader):
    up = {"port": backup, "ref": ref_backup}[uploader]
    down = {"port": backup, "ref": ref_backup}[downloader]
    src = tmp_path / "up.bin"
    src.write_bytes(b"upload-download-payload" * 100)
    maddr = stacks[uploader]["maddr"]
    results = up.upload_files(maddr, [str(src)], collection="ud")
    assert len(results) == 1 and results[0]["fid"]
    assert set(results[0]) == set(ref_backup.upload_files(
        maddr, [str(src)], collection="ud")[0])
    outdir = tmp_path / "dl"
    outdir.mkdir()
    paths = down.download_files(maddr, [results[0]["fid"]], str(outdir))
    assert len(paths) == 1
    with open(paths[0], "rb") as f:
        assert f.read() == src.read_bytes()


def _needles(directory, vid, collection):
    """(id, cookie, data, append_at_ns) of a backup volume, file order."""
    base = os.path.join(directory, f"{collection}_{vid}")
    return [(n.id, n.cookie, bytes(n.data), n.append_at_ns)
            for _o, n in ref_offline.scan_dat_file(base + ".dat")]


def test_backup_incremental_across_packages(stacks, tmp_path):
    """Each cluster's volume backed up by both packages' `backup`: the
    same needles appended at each of three runs (a full copy, the delta
    after a write to the same volume, nothing), the same needles in the
    mirrors, and the port's equal to the reference against itself."""
    coll = "bk"
    runs = {}
    for cluster in ("port", "ref"):
        maddr = stacks[cluster]["maddr"]
        f1 = tmp_path / f"{cluster}1.bin"
        f1.write_bytes(b"backup-one" * 50)
        vid = int(ref_backup.upload_files(maddr, [str(f1)], collection=coll)
                  [0]["fid"].partition(",")[0])
        dirs = {tool: str(tmp_path / f"{cluster}_by_{tool}")
                for tool in ("port", "ref")}
        tools = {"port": backup, "ref": ref_backup}
        res = {t: [tools[t].backup_volume(maddr, vid, dirs[t], coll)]
               for t in tools}
        f2 = tmp_path / f"{cluster}2.bin"
        f2.write_bytes(b"backup-two" * 50)
        for _ in range(40):
            r2 = ref_backup.upload_files(maddr, [str(f2)], collection=coll)
            if int(r2[0]["fid"].partition(",")[0]) == vid:
                break
        else:
            raise AssertionError("no second blob landed on the volume")
        for _ in range(2):
            for t in tools:
                res[t].append(tools[t].backup_volume(maddr, vid, dirs[t],
                                                     coll))
        assert res["port"] == res["ref"], (cluster, res)
        assert res["ref"][0]["appended"] >= 1
        assert res["ref"][1]["appended"] >= 1
        assert not res["ref"][1]["full_resync"]
        assert res["ref"][2]["appended"] == 0
        got = _needles(dirs["port"], vid, coll)
        assert got == _needles(dirs["ref"], vid, coll)
        assert any(b"backup-one" in d for _i, _c, d, _t in got)
        assert any(b"backup-two" in d for _i, _c, d, _t in got)
        runs[cluster] = [r["appended"] for r in res["ref"]]
    assert runs["port"] == runs["ref"]


@pytest.mark.parametrize("filer", ["port", "ref"])
def test_filer_copy_and_cat(stacks, tmp_path, filer):
    faddr = stacks[filer]["faddr"]
    d = tmp_path / "tree"
    (d / "sub").mkdir(parents=True)
    (d / "top.txt").write_bytes(b"top-level")
    (d / "sub" / "deep.txt").write_bytes(b"deep-file")
    big = np.random.default_rng(1).integers(
        0, 256, (5 << 20) // 2, dtype=np.uint8).tobytes()
    (d / "sub" / "big.bin").write_bytes(big)  # 3 chunks at -maxMB 1
    created = backup.filer_copy(faddr, [str(d)], f"/copied_{filer}")
    want = ref_backup.filer_copy(faddr, [str(d)], f"/again_{filer}")
    assert sorted(created) == sorted(
        p.replace("/again_", "/copied_") for p in want) == [
        f"/copied_{filer}/tree/sub/big.bin",
        f"/copied_{filer}/tree/sub/deep.txt",
        f"/copied_{filer}/tree/top.txt"]
    for path, body in ((f"/copied_{filer}/tree/top.txt", b"top-level"),
                       (f"/copied_{filer}/tree/sub/deep.txt", b"deep-file"),
                       (f"/copied_{filer}/tree/sub/big.bin", big)):
        assert backup.filer_cat(faddr, path) == body
        assert ref_backup.filer_cat(faddr, path) == body
    with pytest.raises(FileNotFoundError):
        backup.filer_cat(faddr, f"/copied_{filer}/absent")
