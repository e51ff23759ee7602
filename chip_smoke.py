"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--volume-gib 12] [--seed 0]

The main path is what SeaweedFS operators run to seal and protect volumes,
`ec.encode` then `ec.rebuild`: a full volume `.dat` is striped into the
RS(10,4) shards `.ec00`..`.ec13` plus the sorted `.ecx` index, shards are
lost, and the lost ones are rebuilt.  Both go through one hand-written CUDA
kernel, `seaweedfs_tpu_torch/ops/csrc/gf_matmul.cu`.

Phases, each printing one JSON line:
  1. card and build: the card's name and power limit, the kernel's nvcc
     build time;
  2. the kernel against its plain PyTorch version on the card, byte-equal,
     for parity and decode-plan matrices at ragged and unaligned widths;
  3. kernel timing with CUDA events (median of 20) at 16 MiB and 64 MiB per
     shard, beside its memory bound and the plain version's time;
  4. end to end: a synthetic volume (12 GiB by default: SeaweedFS's default
     30 GB volume limit cut so that one 1 GB-block row and 2 GiB of
     1 MB-block rows still run) encoded with write_ec_files +
     write_sorted_file_from_idx, every slice's parity checked against the
     plain version on the card, then .ec00-.ec03 deleted, rebuilt with
     rebuild_ec_files and checked by sha256.  Kernel launch counts are
     zeroed just before and read just after this phase;
  5. the {"kernels": [...]} line, then {"ok": true, "device": ...} last.

Exits non-zero, printing no result, without a CUDA card or without the
package beside this script.  Data comes from --seed; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

GIB = 1 << 30
MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# No integer-ALU peak is published beside the tensor-core rates; the
# CUDA-core float32 rate (67 TFLOP/s) is not below the card's 32-bit integer
# rate, so operations over it still give a lower bound on time.
CUDA_CORE_OPS_PER_S = 67e12
LOSS_SETS = ((0,), (2, 3), (0, 1, 2, 3), (10, 11, 12, 13), (2, 3, 11, 12))
PHASE2_WIDTHS = (1, 3, 15, 100, 511, 513, 4097, 16 * MIB, 64 * MIB + 3)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def gf_ops(matrix: np.ndarray, width: int) -> int:
    """32-bit integer operations the SWAR kernel needs for this matrix:
    per 4-byte word and source, 5 per doubling step up to the column's
    highest set bit and 1 XOR per selected multiple."""
    ops = 0
    for col in np.asarray(matrix).T:
        top = max(int(c).bit_length() for c in col)
        ops += 5 * max(top - 1, 0) + sum(bin(int(c)).count("1") for c in col)
    return ops * -(-width // 4)


def bound(matrix: np.ndarray, width: int) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations") for one apply."""
    r, s = matrix.shape
    t_bytes = (r + s) * width / HBM_BYTES_PER_S * 1e3
    t_ops = gf_ops(matrix, width) / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `fn()` on the card, each run between events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def random_u8(shape, gen) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                         generator=gen)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.int() - want.int()).abs().max())


# -- phase 2 -------------------------------------------------------------


def phase_correctness(rs_cuda, gf256, gen) -> int:
    full = gf256.rs_matrix(10, 14)
    cases = [("parity", gf256.rs_parity_matrix(10, 4), b, 0)
             for b in PHASE2_WIDTHS]
    cases.append(("parity", gf256.rs_parity_matrix(10, 4), 4097, 1))
    cases.append(("parity", gf256.rs_parity_matrix(10, 4), 16 * MIB, 1))
    for lost in LOSS_SETS:
        present = [i for i in range(14) if i not in lost]
        plan = gf256.decode_plan_for(full, 10, present, lost)
        for b in (1, 513, 4096, 16 * MIB + 5):
            cases.append((f"plan{list(lost)}", plan, b, 0))
        cases.append((f"plan{list(lost)}", plan, 4096, 1))
    worst = 0
    for name, m, b, offset in cases:
        base = random_u8((10, b + offset), gen)
        data = base[:, offset:]  # offset 1: every row starts unaligned
        got = rs_cuda.gf_apply(m, data)
        want = rs_cuda.gf_apply_reference(m, data)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"kernel != plain for {name} B={b} "
                                 f"offset={offset}: max_abs_err {err}")
        worst = max(worst, err)
    emit({"phase": "kernel_vs_plain", "cases": len(cases),
          "byte_equal": True, "max_abs_err": worst})
    return worst


# -- phase 3 -------------------------------------------------------------


def phase_timing(rs_cuda, gf256, gen, power: str) -> list[dict]:
    full = gf256.rs_matrix(10, 14)
    lost = (0, 1, 2, 3)
    plan = gf256.decode_plan_for(
        full, 10, [i for i in range(14) if i not in lost], lost)
    rows = []
    for name, m in (("parity", gf256.rs_parity_matrix(10, 4)),
                    ("rebuild_plan_4", plan)):
        for b in (16 * MIB, 64 * MIB):
            data = random_u8((10, b), gen)
            ms = time_ms(lambda: rs_cuda.gf_apply(m, data))
            plain_ms = time_ms(lambda: rs_cuda.gf_apply_reference(m, data),
                               reps=10, warmup=1)
            b_ms, b_by = bound(m, b)
            row = {"phase": "kernel_timing", "matrix": name,
                   "bytes_per_shard": b, "ms": ms,
                   "input_GBps": 10 * b / ms / 1e6,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "share_of_bound": b_ms / ms, "plain_ms": plain_ms,
                   "card": power}
            emit(row)
            rows.append(row)
            del data
    return rows


# -- phase 4 -------------------------------------------------------------


def make_volume(base: str, size: int, seed: int) -> int:
    """A synthetic sealed volume: `size` bytes of seeded random needle
    payloads in `<base>.dat` and one 16-byte .idx entry per needle, keys in
    shuffled order so the .ecx sort does real work.  -> needle count."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with open(base + ".dat", "wb") as f:
        left = size
        while left:
            n = min(left, 256 * MIB)
            f.write(random_u8((n,), gen).cpu().numpy())
            left -= n
    # needles of 1 B..256 KiB, 8-byte aligned, after the 8-byte superblock
    sizes = rng.integers(1, 256 * 1024, size // (64 * 1024), dtype=np.int64)
    padded = (sizes + 7) // 8 * 8
    offsets = 8 + np.concatenate([[0], np.cumsum(padded)[:-1]])
    keep = offsets + padded <= size
    sizes, offsets = sizes[keep], offsets[keep]
    keys = rng.permutation(np.arange(1, len(sizes) + 1, dtype=np.uint64) * np.uint64(7919))
    entries = np.empty(len(keys), dtype=[("k", ">u8"), ("o", ">u4"),
                                          ("s", ">u4")])
    entries["k"], entries["o"], entries["s"] = keys, offsets // 8, sizes
    entries.tofile(base + ".idx")
    return len(keys)


def check_ecx(base: str) -> None:
    raw = np.fromfile(base + ".idx", dtype=[("k", ">u8"), ("o", ">u4"),
                                            ("s", ">u4")])
    ecx = np.fromfile(base + ".ecx", dtype=raw.dtype)
    if not np.array_equal(ecx, np.sort(raw, order="k")):
        raise AssertionError(".ecx is not the key-sorted .idx")


def check_layout(base: str, dat_size: int, rng, enc) -> None:
    """Sampled stripes: bytes of the .dat sit where the RS layout puts them
    in the data shards (large rows while > 10 GB remains, then small)."""
    spans = []  # (dat_offset, shard_offset, block)
    processed, shard_off, remaining = 0, 0, dat_size
    while remaining > enc.LARGE_BLOCK_SIZE * 10:
        spans.append((processed, shard_off, enc.LARGE_BLOCK_SIZE))
        processed += enc.LARGE_BLOCK_SIZE * 10
        shard_off += enc.LARGE_BLOCK_SIZE
        remaining -= enc.LARGE_BLOCK_SIZE * 10
    with open(base + ".dat", "rb") as dat:
        for pos in rng.integers(0, dat_size - 4096, 64):
            pos = int(pos)
            row_start, s_off, block = processed, shard_off, enc.SMALL_BLOCK_SIZE
            for start, soff, blk in spans:
                if start <= pos < start + blk * 10:
                    row_start, s_off, block = start, soff, blk
            if block == enc.SMALL_BLOCK_SIZE:
                k = (pos - processed) // (block * 10)
                row_start = processed + k * block * 10
                s_off = shard_off + k * block
            shard, col = divmod(pos - row_start, block)
            n = min(4096, block - col)
            dat.seek(pos)
            want = dat.read(n)
            got = np.fromfile(base + f".ec{shard:02d}", dtype=np.uint8,
                              count=n, offset=s_off + col).tobytes()
            if got != want:
                raise AssertionError(f"layout mismatch at .dat offset {pos}")


def check_parity(base: str, rs_cuda, gf256, slice_size: int) -> int:
    """Every encode slice's parity shards against the plain version on the
    card; -> slices checked."""
    m = gf256.rs_parity_matrix(10, 4)
    shard_size = os.path.getsize(base + ".ec00")
    n = 0
    for off in range(0, shard_size, slice_size):
        w = min(slice_size, shard_size - off)
        rows = [np.fromfile(base + f".ec{i:02d}", dtype=np.uint8, count=w,
                            offset=off) for i in range(14)]
        data = torch.from_numpy(np.stack(rows[:10])).cuda()
        want = rs_cuda.gf_apply_reference(m, data)
        got = torch.from_numpy(np.stack(rows[10:])).cuda()
        if max_abs_err(got, want):
            raise AssertionError(f"parity mismatch in slice at {off}")
        n += 1
    return n


def sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(64 * MIB):
            h.update(chunk)
    return h.hexdigest()


def read_rate(path: str) -> float:
    """GB/s of one sequential pass over `path` in encode-slice-sized reads:
    the host-side floor of the encode's prefetch stage."""
    buf = bytearray(160 * MIB)
    t0 = time.perf_counter()
    with open(path, "rb", buffering=0) as f:
        while f.readinto(buf):
            pass
    return os.path.getsize(path) / (time.perf_counter() - t0) / 1e9


def phase_end_to_end(rs_cuda, gf256, enc, work: str, size: int, seed: int,
                     reduced: list[str], kernel_ms: float) -> dict:
    """`kernel_ms`: the kernel's timed parity time at the encode's slice
    width, to estimate the card's busy share of the encode."""
    base = os.path.join(work, "1")
    t0 = time.perf_counter()
    needles = make_volume(base, size, seed)
    setup_s = time.perf_counter() - t0
    dat_read_GBps = read_rate(base + ".dat")

    rs_cuda.gf_apply.launches = 0
    t0 = time.perf_counter()
    encode_slices = enc.write_ec_files(base, codec_name="cuda")
    enc.write_sorted_file_from_idx(base)
    encode_s = time.perf_counter() - t0
    encode_launches = rs_cuda.gf_apply.launches

    lost = (0, 1, 2, 3)
    digests = {i: sha256_of(base + f".ec{i:02d}") for i in lost}
    for i in lost:
        os.remove(base + f".ec{i:02d}")
    shard_size = os.path.getsize(base + ".ec04")
    rs_cuda.gf_apply.launches = 0
    t0 = time.perf_counter()
    rebuilt = enc.rebuild_ec_files(base, codec_name="cuda")
    rebuild_s = time.perf_counter() - t0
    rebuild_launches = rs_cuda.gf_apply.launches
    rebuild_slices = -(-shard_size // enc.DEFAULT_SLICE)

    if encode_launches != encode_slices:
        raise AssertionError(f"encode launched {encode_launches} kernels for "
                             f"{encode_slices} slices")
    if rebuild_launches != rebuild_slices:
        raise AssertionError(f"rebuild launched {rebuild_launches} kernels "
                             f"for {rebuild_slices} slices")
    if rebuilt != list(lost):
        raise AssertionError(f"rebuilt {rebuilt}, expected {list(lost)}")
    for i in lost:
        if sha256_of(base + f".ec{i:02d}") != digests[i]:
            raise AssertionError(f"rebuilt .ec{i:02d} differs by sha256")
    check_ecx(base)
    check_layout(base, size, np.random.default_rng(seed + 1), enc)
    parity_slices = check_parity(base, rs_cuda, gf256, enc.DEFAULT_SLICE)
    row = {"phase": "end_to_end", "volume_bytes": size, "needles": needles,
           "shard_bytes": shard_size, "setup_s": setup_s,
           "encode_s": encode_s, "encode_GBps": size / encode_s / 1e9,
           "encode_slices": encode_slices, "encode_launches": encode_launches,
           "encode_kernel_share": encode_launches * kernel_ms / 1e3 / encode_s,
           "dat_read_GBps": dat_read_GBps,
           "rebuild_lost": list(lost), "rebuild_s": rebuild_s,
           "rebuild_GBps_read": 10 * shard_size / rebuild_s / 1e9,
           "rebuild_launches": rebuild_launches,
           "parity_slices_checked": parity_slices,
           "rebuild_sha256_equal": True, "ecx_sorted": True,
           "layout_sampled": 64, "reduced": reduced}
    emit(row)
    return row


def volume_size(work: str, want: int) -> tuple[int, list[str]]:
    """The volume to encode: `want` bytes, cut to what the disk can hold
    (.dat + 1.4x for shards + margin); -> (bytes, cuts made)."""
    free = shutil.disk_usage(work).free
    fits = int(free / 2.6) // MIB * MIB
    if fits >= want:
        return want, []
    if fits < GIB:
        raise RuntimeError(f"only {free} bytes free under {work}")
    return fits, [f"volume {want} -> {fits} bytes: {free} bytes free"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--volume-gib", type=float, default=12.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from seaweedfs_tpu_torch.ops import gf256, rs_cuda
    from seaweedfs_tpu_torch.storage.ec import encoder as enc

    start = time.perf_counter()
    power = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    rs_cuda.build_kernel()
    build_s = time.perf_counter() - t0
    print(power, flush=True)
    emit({"phase": "card_and_build", "nvidia_smi": power, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    err = phase_correctness(rs_cuda, gf256, gen)
    timing = phase_timing(rs_cuda, gf256, gen, power)

    parity16 = next(r for r in timing if r["matrix"] == "parity"
                    and r["bytes_per_shard"] == 16 * MIB)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        size, reduced = volume_size(work, int(args.volume_gib * GIB) // MIB * MIB)
        e2e = phase_end_to_end(rs_cuda, gf256, enc, work, size, args.seed,
                               reduced, parity16["ms"])
    finally:
        shutil.rmtree(work, ignore_errors=True)

    emit({"kernels": [{
        "name": "gf_matmul", "route": "cuda",
        "source": "seaweedfs_tpu_torch/ops/csrc/gf_matmul.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:44",
        "launches": e2e["encode_launches"] + e2e["rebuild_launches"],
        "max_abs_err": err, "ms": parity16["ms"],
        "plain_ms": parity16["plain_ms"], "bound_ms": parity16["bound_ms"],
        "bound_by": parity16["bound_by"], "library_ms": None}]})
    emit({"phase": "done", "wall_s": time.perf_counter() - start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
