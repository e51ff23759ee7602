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
