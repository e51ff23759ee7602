"""The port's chip scripts on a host without a CUDA card, and the parts of
chip_ab.py that need none: each script exits non-zero and prints no
result; the cuobjdump report and the medians are read correctly."""

import json
import os
import stat
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_ab  # noqa: E402


@pytest.mark.parametrize("argv", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--only-maintenance"],
                                  ["chip_smoke.py", "--only-mesh"],
                                  ["chip_smoke.py", "--only-tier"],
                                  ["chip_smoke.py", "--only-quorum"],
                                  ["chip_ab.py", "--tree", "a=."]])
def test_exits_nonzero_without_a_card(argv):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA card" in proc.stderr


def test_summary_takes_medians_per_checkout_and_skips_failed_runs():
    def run(label, ms, enc):
        return {"label": label,
                "kernel": {"parity": {"ms": ms, "back_to_back_ms": ms / 2}},
                "direct": {"encode_GBps": enc}}
    rows = [run("parent", 0.2, 1.0), run("change", 0.1, 1.1),
            run("change", 0.12, 1.3), run("parent", 0.18, 0.9),
            run("change", 0.14, 1.2), {"label": "parent", "error": 1}]
    out = chip_ab.summary(rows)
    assert out["parent"]["runs"] == 2 and out["change"]["runs"] == 3
    assert out["change"]["kernel.parity.ms"] == {
        "median": pytest.approx(0.12), "min": 0.1, "max": 0.14}
    assert out["parent"]["direct.encode_GBps"]["median"] == pytest.approx(0.95)
    assert "service.encode_GBps" not in out["change"]  # flow not run
    json.dumps(out)


_SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

\tcode for sm_90a
\t\tFunction : gf_bitslice
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                 /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;            /* 0x0000000000007919 */
                                                                 /* 0x000e240000002100 */
        /*0020*/                   EXIT ;                        /* 0x000000000000794d */
                                                                 /* 0x000fea0003800000 */
\t\t..........
"""

_RES = """Resource usage:
 Common:
  GLOBAL:0
 Function gf_bitslice:
  REG:64 STACK:0 SHARED:0 LOCAL:8 CONSTANT[0]:440 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def _fake_cuobjdump(tmp_path, body: str) -> None:
    tool = tmp_path / "bin" / "cuobjdump"
    tool.parent.mkdir()
    tool.write_text("#!/bin/sh\n" + body)
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)


def test_cuobjdump_report_counts_instructions_and_resources(tmp_path,
                                                            monkeypatch):
    (tmp_path / "sass.txt").write_text(_SASS)
    (tmp_path / "res.txt").write_text(_RES)
    _fake_cuobjdump(tmp_path, f"""
case "$1" in
  -sass) cat {tmp_path}/sass.txt ;;
  -res-usage) cat {tmp_path}/res.txt ;;
esac
""")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert chip_ab.cuobjdump("k.cubin") == {"gf_bitslice": {
        "instructions": 3, "sass_bytes": 48, "registers": 64, "stack": 0,
        "shared": 0, "local": 8}}


def test_cuobjdump_report_carries_the_tool_error(tmp_path, monkeypatch):
    _fake_cuobjdump(tmp_path, "echo 'no device code' >&2; exit 1\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert chip_ab.cuobjdump("x.so") == {"error": "no device code"}


@pytest.mark.parametrize("size", [1 << 20, (3 << 20) + 8 * 37, 40 << 20],
                         ids=["1MiB", "3MiB-ragged", "40MiB"])
def test_make_volume_writes_real_needles(tmp_path, size):
    """chip_smoke.py's volume (data drawn on the CPU here) is a volume the
    reference's own loader serves: every .idx entry a version-3 needle
    whose CRC checks, records packed from the superblock to exactly
    `size` bytes; encoded by the port, the port's EcVolume reads each
    needle as the reference parses it."""
    import chip_smoke
    from seaweedfs_tpu.storage.needle import Needle as RefNeedle
    from seaweedfs_tpu.storage.volume import Volume
    from seaweedfs_tpu_torch.storage.ec import encoder as penc
    from seaweedfs_tpu_torch.storage.ec.volume import EcVolume

    base = str(tmp_path / "1")
    n = chip_smoke.make_volume(base, size, seed=5, device="cpu")
    assert os.path.getsize(base + ".dat") == size
    raw = np.fromfile(base + ".idx", dtype=[("k", ">u8"), ("o", ">u4"),
                                            ("s", ">u4")])
    assert len(raw) == n and len(set(raw["k"].tolist())) == n
    assert not np.array_equal(raw["k"], np.sort(raw["k"]))  # shuffled keys
    ordered = np.sort(raw, order="o")
    ends = ordered["o"].astype(np.int64) * 8 + [
        chip_smoke._record_size(int(s) - 5) for s in ordered["s"]]
    assert ordered["o"][0] * 8 == 8 and ends[-1] == size
    assert np.array_equal(ordered["o"][1:].astype(np.int64) * 8, ends[:-1])
    assert 1 <= int(raw["s"].min()) - 5 \
        and int(raw["s"].max()) - 5 <= chip_smoke.NEEDLE_MAX_DATA
    vol = Volume(str(tmp_path), "", 1)
    try:
        want = {int(k): vol.read_needle(int(k)) for k in raw["k"]}
    finally:
        vol.close()
    assert os.path.getsize(base + ".dat") == size  # nothing healed away
    penc.write_ec_files(base, codec_name="cpu")
    penc.write_sorted_file_from_idx(base)
    ev = EcVolume(base, volume_id=1, codec_name="cpu")
    try:
        for sid in (0, 1, 2, 3):
            ev.delete_shard(sid)
        for k, w in want.items():
            got = ev.read_needle(k)
            assert (got.id, got.cookie, got.data, got.checksum,
                    got.append_at_ns) == (w.id, w.cookie, w.data,
                                          w.checksum, w.append_at_ns)
            assert isinstance(w, RefNeedle)
    finally:
        ev.close()


def test_store_lifecycle_phase_rehearsed_on_the_host(tmp_path, monkeypatch,
                                                     capsys):
    """chip_smoke.py's store_lifecycle phase at 16 MiB on this host, the
    `cuda` codec monkeypatched to the kernel's plain version (`torch_cpu`)
    behind a wrapper that counts each call as the kernel's wrapper counts
    a launch: every check of the phase passes, and the launches are
    counted per path.  Without a card the encode, rebuild and scrub take
    the direct route, so every path launches `gf_matmul`."""
    import chip_smoke
    from seaweedfs_tpu_torch.ops import codec as pcodec
    from seaweedfs_tpu_torch.ops import codec_service, gf256, rs_cuda, rs_torch
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.storage.ec import encoder as enc

    plain = rs_torch.gf_apply

    def counted(matrix, data):
        out = plain(matrix, data)
        rs_cuda.gf_apply.launches += 1
        return out

    monkeypatch.setitem(pcodec._TORCH_DEVICES, "cuda", "cpu")
    monkeypatch.setattr(rs_torch, "gf_apply", counted)
    monkeypatch.setattr(rs_cuda.gf_apply, "launches", 0)
    monkeypatch.setattr(rs_cuda.gf_apply_batched, "launches", 0)
    work = tmp_path / "work"
    work.mkdir()
    out = chip_smoke.phase_store_lifecycle(
        rs_cuda, gf256, enc, codec_service, metrics, str(work), 16 << 20,
        seed=0, reduced=[], device="cpu")
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        row = json.loads(line)
        rows[row["phase"]] = row
    assert set(rows) == {"store_write", "store_ec_encode", "store_reads",
                         "store_rebuild", "store_scrub", "store_ec_decode",
                         "store_lifecycle_summary"}
    paths = out["launches_by_path"]
    assert set(paths["gf_matmul"]) == {"store_encode", "store_reads",
                                       "store_rebuild", "store_scrub"}
    assert paths["gf_matmul_batched"] == {}
    assert rows["store_lifecycle_summary"]["route"] == "direct"
    scrub = rows["store_scrub"]
    assert paths["gf_matmul"]["store_scrub"] == scrub["cuda"]["intervals"] \
        == scrub["cpu"]["intervals"] > 0
    assert scrub["cpu"]["gf_matmul"] == 0
    assert scrub["corrupt"]["finding"].startswith(
        f"parity mismatch at {scrub['corrupt']['interval']}+")
    degraded = rows["store_reads"]["passes"][1]
    assert paths["gf_matmul"]["store_reads"] == degraded["launches"] \
        == degraded["degraded_intervals"] > 0
    assert rows["store_ec_decode"]["dat_sha256_equal"]


def test_volume_server_phase_rehearsed_on_the_host(tmp_path, monkeypatch,
                                                   capsys):
    """chip_smoke.py's volume_server phase, with its http_plane steps (12 MiB
    of replicated writes for h4), on a 16 MiB volume on this host:
    two port VolumeServers on the `cuda` codec, monkeypatched to the
    kernel's plain version (`torch_cpu`) behind a wrapper that counts each
    call as a launch, and the script's MiniMaster.  Every check of the
    phase passes; degraded reads, the rebuild, the partial rebuild and its
    fallback launch, healthy reads and the decode do not."""
    import chip_smoke
    from helpers import free_port
    from seaweedfs_tpu_torch.ops import codec as pcodec
    from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_torch
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.storage.ec import encoder as enc

    plain = rs_torch.gf_apply

    def counted(matrix, data):
        out = plain(matrix, data)
        rs_cuda.gf_apply.launches += 1
        return out

    monkeypatch.setitem(pcodec._TORCH_DEVICES, "cuda", "cpu")
    monkeypatch.setattr(rs_torch, "gf_apply", counted)
    monkeypatch.setattr(rs_cuda.gf_apply, "launches", 0)
    monkeypatch.setattr(rs_cuda.gf_apply_batched, "launches", 0)
    work = tmp_path / "work"
    work.mkdir()
    chip_smoke.make_volume(str(work / "1"), 16 << 20, seed=3, device="cpu")
    out = chip_smoke.phase_volume_server(
        rs_cuda, gf256, enc, metrics, str(work), seed=0, power="test card",
        reduced=[], device="cpu", free_port=free_port,
        http_write_bytes=12 << 20)
    rows, http = {}, {}
    for line in capsys.readouterr().out.splitlines():
        row = json.loads(line)
        if row["phase"] == "http_plane":
            http[row["step"]] = row
        else:
            rows[row["phase"]] = row
    assert set(rows) == {f"volume_server_{s}" for s in (
        "generate", "mount_heartbeat", "reads", "rebuild", "partial_rebuild",
        "partial_fallback", "scrub", "decode", "summary")}
    assert all(r["nvidia_smi"] == "test card"
               for r in [*rows.values(), *http.values()])
    paths = out["launches_by_path"]
    assert set(paths["gf_matmul"]) == {
        "volume_server_generate", "volume_server_reads",
        "volume_server_rebuild", "volume_server_partial_rebuild",
        "volume_server_partial_fallback", "volume_server_scrub",
        "http_plane_h1_canary", "http_plane_h2_degraded_gets"}
    assert paths["gf_matmul_batched"] == {}
    healthy, degraded = rows["volume_server_reads"]["passes"]
    assert not any(healthy["launches"].values())
    assert degraded["launches"]["gf_matmul"] >= degraded[
        "degraded_intervals"] > 0
    partial = rows["volume_server_partial_rebuild"]
    assert partial["bytes_in"] < partial["full_fetch_bytes"]
    fallback = rows["volume_server_partial_fallback"]
    assert fallback["fallbacks"] == 1 and fallback["host_apply_rows"] == 0
    assert rows["volume_server_decode"]["dat_sha256_equal"]
    # phase 4e, http_plane, on the same servers
    assert set(http) == {"h1_healthy_gets", "h1_canary", "h2_degraded_gets",
                         "h3_sendfile_gets", "h4_replicated_writes",
                         "h5_tcp", "h6_query", "h7_metrics_traces"}
    h2 = http["h2_degraded_gets"]
    assert h2["byte_equal"] and h2["degraded_intervals"] > 0
    assert h2["launches"]["gf_matmul"] == h2["degraded_intervals"] \
        + h2["heads"]["launches"]["gf_matmul"]
    assert paths["gf_matmul"]["http_plane_h2_degraded_gets"] \
        == h2["launches"]["gf_matmul"]
    canary = http["h1_canary"]
    assert canary["ok"] and canary["reconstructed"]
    # the dropped data row's decode, and the unread parity rows re-encoded
    assert canary["launches"]["gf_matmul"] == canary["expected_launches"] == 2
    assert not any(http["h1_healthy_gets"]["launches"].values())
    h3 = http["h3_sendfile_gets"]
    assert h3["sendfile_bytes"] == h3["bytes"] > 0
    assert h3["range_fallbacks"] == h3["range_gets"] == 64
    h4 = http["h4_replicated_writes"]
    assert h4["bytes"] >= 12 << 20 and h4["readback_equal"]
    assert h4["unsigned_post_status"] == 401 and h4["replication_errors"] == 0
    assert http["h6_query"]["equal_to_plain_filter"]
    assert http["h7_metrics_traces"]["trace_spans"]["volumeServer.get"] > 0
    assert not os.path.exists(work / "server_b")


def test_cluster_phase_rehearsed_on_the_host(tmp_path, capsys):
    """chip_smoke.py's cluster phase (4f) at 12 MiB on this host: a master
    and three volume processes of `python -m seaweedfs_tpu_torch` with
    `-ec.codec torch_cpu` (the kernel's plain version; the phase passes it
    because the caller asks, never as a fallback), the shell as a process
    per command.  Every check of the phase passes: the spread is the
    plan's over 3 nodes, parity equals the plain version, C's shards come
    back equal by sha256, the decoded .dat equals the original, and each
    process exits 0 on SIGTERM; the servers' own /metrics show the
    torch_cpu codec's ops moving and the host codec's apply_rows not."""
    import chip_smoke
    from helpers import free_port
    from seaweedfs_tpu_torch.ops import gf256, rs_cuda

    work = tmp_path / "work"
    work.mkdir()
    out = chip_smoke.phase_cluster(
        rs_cuda, gf256, str(work), 12 << 20, seed=0, power="test card",
        reduced=["test size"], codec="torch_cpu", device="cpu",
        free_port=free_port, write_bytes=8 << 20)
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        row = json.loads(line)
        rows[row["phase"]] = row
    assert set(rows) == {f"cluster_{s}" for s in (
        "start", "writes", "encode", "healthy_gets", "degraded_gets",
        "rebuild", "decode", "stop", "summary")}
    assert all(r["nvidia_smi"] == "test card" for r in rows.values())
    enc = rows["cluster_encode"]
    assert enc["plan_equal"] and sorted(enc["spread"]) == ["a", "b", "c"]
    assert sorted(s for v in enc["spread"].values() for s in v) \
        == list(range(14))
    assert enc["parity_slices_checked"] >= 1
    assert not enc["counts"]["a"]["host_apply_rows"]
    assert rows["cluster_writes"]["readback_equal"]
    assert rows["cluster_writes"]["bytes"] >= 8 << 20
    deg = rows["cluster_degraded_gets"]
    assert deg["byte_equal"] and deg["lost_shards"] == enc["spread"]["c"]
    assert any(s < 10 for s in deg["lost_shards"])
    for n in ("a", "b"):  # 5 local shards each: the partial-sum path
        assert deg["counts"][n]["partial_fetches"] > 0, n
    rebuild = rows["cluster_rebuild"]
    assert rebuild["sha256_equal"] and all(
        rebuild["counts"][n]["ops"].get("rebuild") for n in rebuild["on"])
    assert rows["cluster_decode"]["dat_sha256_equal"]
    assert {n: e["rc"] for n, e in rows["cluster_stop"]["exits"].items()} \
        == {"a": 0, "b": 0, "master": 0}
    # no card: the kernels' launch counters stayed at 0 on every server
    assert out["launches_by_path"] == {"gf_matmul": {},
                                       "gf_matmul_batched": {}}


def test_maintenance_phase_rehearsed_on_the_host(tmp_path, capsys):
    """chip_smoke.py's maintenance phase (4g) with 8 volumes of 4 MiB on
    this host: a master with its lifecycle loop and the controller's
    defaults, then four volume processes of `python -m seaweedfs_tpu_torch`
    with `-ec.codec torch_cpu` (the kernel's plain version, passed because
    the caller asks, never as a fallback), D first, and no shell command
    but the status reads.  Every check of the phase passes: the controller
    seals and encodes all 8 volumes in two waves of one volume per node
    (parity equal to the plain version, sources dropped; the first wave
    spread 4/4/3/3 with D and C, first in topology order, taking 4, the
    second 2/2/5/5, stacking 5 on A and B), D's
    death is repaired by the master alone (rebuilt shards equal by
    sha256), GETs from the moment D is dropped return every body equal,
    volume.lifecycle and volume.repair show every job done, and every
    process exits 0 on SIGTERM."""
    import chip_smoke
    from helpers import free_port
    from seaweedfs_tpu_torch.ops import gf256, rs_cuda

    work = tmp_path / "work"
    work.mkdir()
    out = chip_smoke.phase_maintenance(
        rs_cuda, gf256, str(work), 4 << 20, seed=0, power="test card",
        reduced=["test size"], codec="torch_cpu", device="cpu",
        free_port=free_port)
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        row = json.loads(line)
        rows[row["phase"]] = row
    assert set(rows) == {f"maintenance_{s}" for s in (
        "start", "encode", "dead_node", "gets_during_repair", "repair",
        "stop", "summary")}
    assert all(r["nvidia_smi"] == "test card" for r in rows.values())
    enc = rows["maintenance_encode"]
    assert len(enc["jobs"]) == 8 and all(
        [j["transition"] for j in jobs] == ["seal", "ec_encode"]
        for jobs in enc["jobs"].values())
    assert enc["d_max_shards_per_volume"] <= 4
    assert rows["maintenance_start"]["topology_order"][:2] == ["d", "c"]
    assert enc["waves"] == [[1, 3, 5, 7], [2, 4, 6, 8]]
    for w, want in enumerate(({"d": 4, "c": 4, "a": 3, "b": 3},
                              {"d": 2, "c": 2, "a": 5, "b": 5})):
        for v in enc["waves"][w]:
            assert {n: len(s) for n, s in enc["spread"][str(v)].items()
                    } == want, (v, enc["spread"])
    assert enc["loss_if_dead"] == {"a": [2, 4, 6, 8], "b": [2, 4, 6, 8]}
    assert all(sorted(s for v in sp.values() for s in v) == list(range(14))
               for sp in enc["spread"].values())
    assert enc["parity_slices_checked"] >= 8 and enc["sources_dropped"]
    assert not any(c["host_apply_rows"] for c in enc["counts"].values())
    dead = rows["maintenance_dead_node"]
    assert dead["detect_s"] < min(dead["planned_s"],
                                  dead["time_to_recover_s"])
    assert dead["affected_volumes"] == list(range(1, 9))
    gets = rows["maintenance_gets_during_repair"]
    assert gets["byte_equal"] and gets["reads"] > 0
    rep = rows["maintenance_repair"]
    assert rep["sha256_equal"] and rep["rebuilt"] == dead["lost_shards"]
    assert rep["remote_bytes_in"] > 0 and rep["full_fetch_bytes"] > 0
    assert rep["ec_encode_done"] == 8 and rep["mass_repair_done"] == 8
    assert rep["mass_repair_counts"]["repaired"] == 8
    assert rep["lifecycle_states"] == {"done": 24}
    assert rep["repair_batch"][
        'seaweedfs_repair_batch_jobs_total{result="ok"}'] == 8
    assert {n: e["rc"] for n, e in rows["maintenance_stop"]["exits"].items()
            } == {"a": 0, "b": 0, "c": 0, "master": 0}
    # no card: the kernels' launch counters stayed at 0 on every server
    assert out["launches_by_path"] == {"gf_matmul": {},
                                       "gf_matmul_batched": {}}


def test_mesh_phase_rehearsed_on_the_host(tmp_path, capsys, monkeypatch):
    """chip_smoke.py's mesh phase at small sizes on this host, every flow
    on CPU meshes (the caller asks: a CPU generator), the device codec
    names mapped to the host for the test: the xor and bit-plane kernels'
    plain versions against themselves at the listed shapes, config 4's
    batch encode and mesh rebuild byte-identical on the 1x1 and the
    virtual 2x4 mesh, the codec flows, dryrun_multidevice(8) and the
    service bursts with their exact launch counts.  On the CPU the
    wrappers count no launches, so counting wrappers stand in for them."""
    import chip_smoke
    import torch
    from seaweedfs_tpu_torch.ops import (codec, codec_service, gf256,
                                         gf_network, rs_bitplane, rs_cuda,
                                         rs_xor)
    from seaweedfs_tpu_torch.parallel import mesh as pmesh
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.storage.ec import encoder as enc

    for name in ("cuda", "cuda_xor", "cuda_bitplane"):
        monkeypatch.setitem(codec._TORCH_DEVICES, name, "cpu")

    def counted(module, attr, *more):
        real = getattr(module, attr)

        def wrapper(*a, **k):
            wrapper.launches += 1
            return real(*a, **k)
        wrapper.launches = 0
        for m in (module, *more):
            monkeypatch.setattr(m, attr, wrapper)
        return wrapper
    counted(rs_cuda, "gf_apply_batched", pmesh, codec_service)
    counted(rs_xor, "gf_apply_xor_batched")
    from seaweedfs_tpu_torch.ops import rs_torch
    counted(rs_bitplane, "gf_apply_bitplane", pmesh, rs_torch)
    gen = torch.Generator().manual_seed(0)
    out = chip_smoke.phase_mesh(
        rs_cuda, rs_xor, rs_bitplane, gf256, gf_network, enc, codec_service,
        metrics, str(tmp_path), 0, gen, "test card", ["test sizes"],
        widths=(1, 7, 4099), config4=(6, (1 << 20, 3 << 20)),
        virtual_volumes=(4, (200_000, 600_000)),
        burst_widths=(5000, 7011))
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        row = json.loads(line)
        rows[row["phase"]] = row
    assert rows["mesh_kernels_vs_plain"]["byte_equal"]
    shapes = chip_smoke.BITPLANE_SHAPES
    # the plans: gf_xor one entry and batched, gf_bitplane_mma; the
    # seeded (R, S) sweep: the same three checks and gf_xor on its other
    # side
    assert rows["mesh_kernels_vs_plain"]["cases"] == 3 * 21 * 3 + 4 * int(
        np.prod([len(x) for x in shapes]))
    for label, shape in (("config4", {"dp": 1, "sp": 1}),
                         ("virtual2x4", {"dp": 2, "sp": 4})):
        enc_row = rows[f"mesh_{label}_batch_encode"]
        assert enc_row["mesh"] == shape and enc_row["sha256_equal"] > 0
        assert enc_row["launches"]["gf_matmul_batched"] >= 1
        reb = rows[f"mesh_{label}_mesh_rebuild"]
        # one launch per slice and mesh entry (the 1 MiB-3 MiB volumes
        # have one slice)
        assert reb["sha256_equal"] == 4
        assert reb["launches"]["gf_bitplane_mma"] == \
            shape["dp"] * shape["sp"]
    assert rows["mesh_config4_cuda_xor_encode"]["launches"]["gf_xor"] >= 1
    assert rows["mesh_config4_cuda_bitplane_rebuild"]["launches"][
        "gf_bitplane_mma"] == 1
    assert rows["mesh_dryrun"]["mesh"] == {"dp": 2, "sp": 4}
    assert rows["mesh_card_service"]["parity"]["launches"] == \
        rows["mesh_card_service"]["parity"]["batches"] == 1
    assert rows["mesh_virtual2x4_service"]["apply"]["launches"] == 8
    assert out["timing"] == {"kernels": "not measured: no card"}
    assert set(out["launches_by_path"]) >= {
        "config4_batch_encode", "virtual2x4_mesh_rebuild", "dryrun",
        "service_card", "service_virtual2x4"}


def test_tier_phase_rehearsed_on_the_host(tmp_path, capsys):
    """chip_smoke.py's tier phase (4h) with 2 volumes of 12 MiB on this
    host: the script's own S3 endpoint (a child process checking SigV4 by
    its own code), a master with a tier policy and two volume processes
    of `python -m seaweedfs_tpu_torch` with `-offset.5bytes
    -tierBackends` and `-ec.codec torch_cpu` (the kernel's plain version,
    passed because the caller asks).  Every check of the phase passes:
    the controller seals, encodes (keeping the source) and tiers both
    volumes, the objects equal the .dats by sha256, the .ecx files hold
    17-byte entries, GETs from the remote tier and through the EC shards
    are equal, the shell's download and upload round trip is equal, a
    wrong secret gets 403, a move to an unregistered backend fails, and
    every process exits 0 on SIGTERM."""
    import chip_smoke
    from helpers import free_port
    from seaweedfs_tpu_torch.ops import gf256, rs_cuda

    work = tmp_path / "work"
    work.mkdir()
    out = chip_smoke.phase_tier(
        rs_cuda, gf256, str(work), 12 << 20, seed=0, power="test card",
        reduced=["test size"], codec="torch_cpu", device="cpu",
        free_port=free_port, gets=64, ec_gets=16, shell_gets=8)
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        row = json.loads(line)
        rows[row["phase"]] = row
    assert set(rows) == {f"tier_{s}" for s in (
        "start", "encode_and_tier", "placement", "remote_gets", "ec_gets",
        "shell", "refusals", "stop", "summary")}
    assert all(r["nvidia_smi"] == "test card" for r in rows.values())
    start = rows["tier_start"]
    assert {v: n * 17 for v, n in start["needles"].items()} \
        == start["idx_bytes"]
    enc = rows["tier_encode_and_tier"]
    assert set(enc["jobs"]) == {"1", "2"}
    assert all(set(j) == {"seal", "ec_encode", "tier"}
               for j in enc["jobs"].values())
    # 12 MiB is over the backend's 8 MiB part size: two multipart uploads
    assert enc["s3"]["bytes_in"] == 2 * (12 << 20)
    assert (enc["s3"]["completes"], enc["s3"]["parts"]) == (2, 4)
    assert enc["s3"]["denied"] == 0
    place = rows["tier_placement"]
    assert place["objects_sha256_equal"] and place["local_dat_gone"]
    assert place["parity_slices_checked"] >= 2
    assert len(place["ecx_entries"]) == 4  # both .ecx on both nodes
    remote = rows["tier_remote_gets"]
    assert remote["byte_equal"] and remote["reads"] == 64
    assert remote["endpoint_range_gets"] > 0
    # percentiles over both volumes' 64 requests together
    assert 0 < remote["p50_ms"] <= remote["p99_ms"]
    ec = rows["tier_ec_gets"]
    assert ec["byte_equal"] and ec["reads"] == 16
    shell = rows["tier_shell"]
    assert shell["sha256_equal"] and shell["download_GBps"] > 0
    assert shell["gets_after_download"]["reads"] == 8
    ref = rows["tier_refusals"]
    assert ref["wrong_secret_status"] == 403
    assert ref["unregistered_backend"].startswith("FAILED_PRECONDITION")
    assert {n: e["rc"] for n, e in rows["tier_stop"]["exits"].items()} \
        == {"a": 0, "b": 0, "master": 0, "s3": 0}
    # no card: the kernels' launch counters stayed at 0 on every server
    assert out["launches_by_path"] == {"gf_matmul": {},
                                       "gf_matmul_batched": {}}


def test_quorum_phase_rehearsed_on_the_host(tmp_path, capsys):
    """chip_smoke.py's quorum phase (4i) with 4 volumes of 16 MiB on this
    host: three `python -m seaweedfs_tpu_torch master` processes in one
    raft quorum with the SLO engine, the canary and the flight recorder
    on, and four volume processes with `-ec.codec torch_cpu` (the
    kernel's plain version, passed because the caller asks).  Every check
    of the phase passes: one leader elected, writes through a follower
    redirected to it, the leader killed mid-encode and every ec_encode
    job done exactly once under the new leader (a running one resumed),
    the follower's job set equal, parity equal to the plain version, no
    volume id reissued; the canary probes every node, a rotten parity
    byte fires the availability page, a bundle is captured on its own
    and listed by the shell, the restored byte resolves the alert; the
    killed master rejoins as a caught-up follower; a dead node's shards
    are rebuilt equal by sha256 while GETs return every body equal; the
    degraded GET is stitched across volume processes, the hot keys are
    listed, and every process exits 0 on SIGTERM."""
    import chip_smoke
    from helpers import free_port
    from seaweedfs_tpu_torch.ops import gf256, rs_cuda

    work = tmp_path / "work"
    work.mkdir()
    out = chip_smoke.phase_quorum(
        rs_cuda, gf256, str(work), 16 << 20, seed=0, power="test card",
        reduced=["test size"], codec="torch_cpu", device="cpu",
        free_port=free_port, gets=256, writes=64, cool_s=25.0)
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        row = json.loads(line)
        rows[row["phase"]] = row
    assert set(rows) == {f"quorum_{s}" for s in (
        "election", "writes", "failover", "canary_slo", "rejoin",
        "dead_node", "gets_during_repair", "tracing", "stop", "summary")}
    assert all(r["nvidia_smi"] == "test card" for r in rows.values())
    assert rows["quorum_writes"]["redirect"] == 307
    fo = rows["quorum_failover"]
    assert fo["killed"] == rows["quorum_election"]["leader"]
    assert fo["new_leader"] != fo["killed"] and fo["jobs_done"] == 4
    assert any(fo["resumed"][str(v)] for v in fo["running_at_kill"])
    assert fo["parity_slices_checked"] >= 4
    assert not set(fo["vids_after"]) & set(fo["vids_before"])
    assert not any(c["host_apply_rows"] for c in fo["counts"].values())
    slo = rows["quorum_canary_slo"]
    assert slo["probes_ok"] >= 4 and slo["bundle"].startswith("bundle-")
    assert 0 < slo["flip_to_firing_s"] and slo["resolve_s"] > 0
    rejoin = rows["quorum_rejoin"]
    assert rejoin["role"] == "follower" and rejoin["master"] == fo["killed"]
    dead = rows["quorum_dead_node"]
    assert dead["sha256_equal"] and dead["mass_repair_done"] == len(
        dead["affected_volumes"])
    assert dead["detect_s"] < dead["time_to_recover_s"]
    gets = rows["quorum_gets_during_repair"]
    assert gets["byte_equal"] and gets["reads"] > 0
    tr = rows["quorum_tracing"]
    assert tr["hot_keys_listed"] == 16
    assert {"volumeServer.get", "ec.reconstruct"} <= set(tr["span_names"])
    assert len(tr["nodes"]) == 1 + 3  # the leader and the live servers
    assert all(e["rc"] == 0 for e in rows["quorum_stop"]["exits"].values())
    # no card: the kernels' launch counters stayed at 0 on every server
    assert out["launches_by_path"] == {"gf_matmul": {},
                                       "gf_matmul_batched": {}}
