"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--volume-gib 12] [--service-volume-gib 3]
                          [--store-volume-gib 12] [--seed 0]
                          [--only-ec-reads | --only-store]

The main path is what SeaweedFS operators run to seal, protect and serve
volumes: `ec.encode`, then `ec.rebuild` and reads of needles from the EC
volume, and the whole lifecycle of a volume through the store that owns
it (write, encode, serve, rebuild, scrub, `ec.decode`).  A full volume
`.dat` of needle records is striped into the RS(10,4) shards
`.ec00`..`.ec13` plus the sorted `.ecx` index, shards are lost, the lost
ones are rebuilt, and needles are read back, lost intervals decoded on
the fly.  All GF(2^8) work goes through one hand-written CUDA
kernel design, the bit-sliced XOR network of
`seaweedfs_tpu_torch/ops/csrc/gf_bitslice.cu`, compiled with NVRTC for each
matrix at its first use: one volume at a time and each degraded read
through `gf_apply` (named `gf_matmul` in the kernels line, as in earlier
runs), and many volumes at once through the codec service, which stacks
their slices into one batched launch (`gf_apply_batched`, named
`gf_matmul_batched`, also the port of bench.py:104's sweep kernel).

Phases, each printing one JSON line:
  1. card and build: the card's name and power limit, the host library's
     nvcc build and the RS(10,4) parity kernel's NVRTC compile, with
     ptxas's register and spill report, and the kernel cache's counters
     (printed again after phases 4 and 7);
  2. the kernel against its plain PyTorch version on the card, byte-equal,
     for parity and decode-plan matrices at ragged and unaligned widths,
     each matrix's compile time beside;
  3. kernel timing with CUDA events at 16 MiB and 64 MiB per shard: `ms`,
     one launch between two events, median of 20 (the host's launch time
     included, as earlier runs measured), and `back_to_back_ms`, 20
     launches back to back between two events, median of 5 such windows;
     beside its memory bound, its integer-ALU bound (`alu_ms`), the rate of
     a device-to-device copy of the same bytes (`achievable_GBps`) and the
     plain version's time;
  4. end to end: a volume of real needle records (version 3, seeded data of
     1 B to 256 KiB, the port's CRC32-C, a real superblock; 12 GiB by
     default: SeaweedFS's default 30 GB volume limit cut so that one 1
     GB-block row and 2 GiB of 1 MB-block rows still run; the time to make
     it on its own line) encoded with write_ec_files +
     write_sorted_file_from_idx, every slice's parity checked against the
     plain version on the card, then .ec00-.ec03 deleted, rebuilt with
     rebuild_ec_files and checked by sha256.  This phase takes the direct
     route (the service's own switch, SEAWEEDFS_TPU_EC_SERVICE=0, is set
     for it).  Kernel launch counts are zeroed just before and read just
     after the encode and the rebuild.  Then .ec05-.ec08 are rebuilt
     twice, a loss set whose decode plan no earlier phase compiled: the
     first rebuild pays its kernel's compile, the second does not (both
     timed, both checked by sha256);
  4b. ec_reads, on that volume with every shard restored: the .ec00-.ec03
     decode plan timed at 4, 64 and 256 KiB per shard; 4096 seeded live
     keys (16 others deleted, into the .ecj) read by the port's EcVolume
     with 16 threads in four passes: (a) healthy, (b) .ec00-.ec03
     unmounted on the `cuda` codec, (c) the same on the host SIMD `cpu`
     codec, (d) a second directory of hard links to .ec04-.ec09, .ecx,
     .ecj and .vif whose remote_fetch reads .ec10-.ec13 from the first.
     Each needle equals its .dat record parsed by the port's Needle; each
     pass prints reads/s, p50/p99 latency, degraded intervals, interval
     cache hits, launches and compiles, counts zeroed just before it and
     read just after; (b) and (d) make a launch per degraded interval,
     (c) none.  The first degraded read, and the first read of a decode
     plan new to the machine, are timed alone.  effective_codec("cuda")
     must be ("cuda", ""); get_codec("auto") prints its choice and both
     round trips.  Last, the second directory rebuilds .ec00-.ec03 from
     its 6 local and 4 remote shards on the default route, equal by sha256
     to phase 4's;
  4c. store_lifecycle, in a fresh directory after 4b's is removed: one
     Store([dir]) on the default `cuda` codec and service settings, a
     volume of --store-volume-gib (12 by default, the source of phase 4)
     written through Store.write_needle (seeded needles of 1 B..256 KiB,
     each needle's length and CRC kept) and sealed; generate_ec_shards on
     the default route (.ecx = key-sorted .idx, sampled slices' parity =
     the plain version's on the card), delete_volume and mount_ec_shards;
     4096 seeded keys read by 16 threads through Store.read_needle healthy
     and with .ec00-.ec03 unmounted and deleted (a gf_matmul launch per
     degraded interval); rebuild_ec_shards (equal by sha256, remounted);
     Scrubber(store, rate_mbps=0).scrub_volume on the `cuda` store (one
     launch per 256 KiB interval) and on a second `cpu` Store over the
     directory (none), both clean; a flipped byte in .ec02 found by a scan
     resumed at its interval's cursor (exactly one finding: shard 2, that
     interval, quarantined), repaired by rebuild_ec_shards, cleared by the
     remount and clean on a rescan; ec_shards_to_volume (the .dat equal by
     sha256, the volume mounts, the keys read back).  Launch counts are
     zeroed just before each step and read just after;
  5. batched_vs_plain: gf_apply_batched for V in {1, 3, 16} entries at
     ragged, unaligned and 16 MiB widths, more than 65535 entries, and
     gf_sweep over overlapping windows, byte-equal to the plain versions;
  6. kernel_sweep: bench.py:104's leg, K parity sweeps over windows
     shifted by 128 KiB in one gf_sweep launch per stage, timed beside
     gf_apply at the same width and the memory bound;
  7. service_concurrent: 4 volumes (3 GiB each) encoded from 4 threads
     through one device-mode CodecService with its default settings,
     .ec00-.ec03 of each deleted and rebuilt from 4 threads through it,
     checked by sha256, .ecx and sampled parity.  Launch counts are zeroed
     just before and read just after: each flow makes at least one batched
     launch and at most one per slice, and no direct launch.  Before the
     flows, 12 encode slices submitted to the idle service in one vectored
     call must share the launches the batch caps allow (2 by default):
     coalescing shown without depending on timing;
  8. default_route: one of those volumes alone, encoded and rebuilt in
     turns on the direct route (SEAWEEDFS_TPU_EC_SERVICE=0) and on the
     default route a user gets with no arguments (the shared service, its
     default batch cap), each checked by sha256 and its launches;
  9. the {"kernels": [...]} line, then {"ok": true, "device": ...} last.

`--only-ec-reads` runs phases 1, 4 and 4b alone, at `--volume-gib` (a
quick check: `--only-ec-reads --volume-gib 0.5`), and prints no kernels
line; `--only-store` runs phases 1-3 and 4c alone, at
`--store-volume-gib` (a quick check: `--only-store --store-volume-gib
0.5`), and prints no kernels line.  Exits non-zero, printing no result,
without a CUDA card or without the package beside this script.  Data comes from --seed; nothing is
downloaded.
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

GIB = 1 << 30
MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# 32-bit integer add, shift, compare and bitwise operations: 64 results per
# clock per SM on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput table); times the SMs and the card's
# clocks.max.sm from nvidia-smi, read in main()
INT32_OPS_PER_CLOCK_PER_SM = 64
LOSS_SETS = ((0,), (2, 3), (0, 1, 2, 3), (10, 11, 12, 13), (2, 3, 11, 12))
PHASE2_WIDTHS = (1, 3, 15, 31, 32, 33, 100, 511, 513, 4097, 16 * MIB,
                 64 * MIB + 3)
BATCH_ENTRIES = (1, 3, 16)
BATCH_WIDTHS = (1, 15, 31, 32, 33, 513, 4097, 16 * MIB)
# bench.py:77's stages: (MiB per shard, sweeps K); one block of 256 x 128
# uint32 lanes = 128 KiB per shard is the shift between sweeps
SWEEP_STAGES = ((4, 8), (16, 32), (64, 16), (256, 8))
SWEEP_SHIFT = 128 * 1024
SERVICE_VOLUMES = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


INT32_OPS_PER_S = 0.0  # set in main() from the card's SMs and clock


def int32_ops_per_s() -> float:
    """64 per clock per SM x the SMs x clocks.max.sm (MHz)."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6


def bound(gf_network, matrix: np.ndarray, width: int) -> dict:
    """The least time of one apply: the bytes it must move over the memory
    rate, and the 32-bit operations the kernel issues for this matrix
    (gf_network.network_ops per 32-column group) over the integer rate;
    `bound_ms` is the larger."""
    r, s = matrix.shape
    t_bytes = (r + s) * width / HBM_BYTES_PER_S * 1e3
    ops = gf_network.network_ops(matrix) * -(-width // gf_network.GROUP_BYTES)
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "alu_ms": t_ops, "ops": ops}


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `fn()` on the card, each run alone between
    two events, so the host's launch time is included."""
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


def time_back_to_back_ms(fn, reps: int = 20, windows: int = 5,
                         warmup: int = 3) -> float:
    """Milliseconds per `fn()` on the card: `reps` calls back to back
    between two events (so the host's launch time overlaps the card's
    work), median over `windows`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def compile_seconds(_build) -> dict:
    """Each NVRTC compile of this process: seconds by cache key."""
    return {key[:16]: s for key, s in _build.COMPILE_SECONDS.items()}


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


def phase_correctness(rs_cuda, gf256, _build, gen) -> int:
    full = gf256.rs_matrix(10, 14)
    cases = [("parity", gf256.rs_parity_matrix(10, 4), b, 0)
             for b in PHASE2_WIDTHS]
    cases.append(("parity", gf256.rs_parity_matrix(10, 4), 4097, 1))
    cases.append(("parity", gf256.rs_parity_matrix(10, 4), 16 * MIB, 1))
    for lost in LOSS_SETS:
        present = [i for i in range(14) if i not in lost]
        plan = gf256.decode_plan_for(full, 10, present, lost)
        for b in (1, 32, 33, 513, 4096, 16 * MIB + 5):
            cases.append((f"plan{list(lost)}", plan, b, 0))
        cases.append((f"plan{list(lost)}", plan, 4096, 1))
    cases.append(("plan[0, 1, 2, 3]", rebuild_plan(gf256), 16 * MIB, 1))
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
          "byte_equal": True, "max_abs_err": worst,
          "compile_s": compile_seconds(_build),
          "cache": rs_cuda.cache_stats()})
    return worst


# -- phase 3 -------------------------------------------------------------


def phase_timing(rs_cuda, gf256, gf_network, gen, power: str) -> list[dict]:
    rows = []
    for name, m in (("parity", gf256.rs_parity_matrix(10, 4)),
                    ("rebuild_plan_4", rebuild_plan(gf256))):
        for b in (16 * MIB, 64 * MIB):
            data = random_u8((10, b), gen)
            ms = time_ms(lambda: rs_cuda.gf_apply(m, data))
            b2b_ms = time_back_to_back_ms(lambda: rs_cuda.gf_apply(m, data))
            plain_ms = time_ms(lambda: rs_cuda.gf_apply_reference(m, data),
                               reps=10, warmup=1)
            # the card's yardstick: one copy of the same 14 x B bytes,
            # counted as bytes moved (read + written), timed back to back
            # and held against the kernel timed the same way
            src = torch.empty((14, b), dtype=torch.uint8, device="cuda")
            dst = torch.empty_like(src)
            copy_ms = time_back_to_back_ms(lambda: dst.copy_(src))
            achievable = 2 * 14 * b / copy_ms / 1e6
            moved = 14 * b / b2b_ms / 1e6
            bd = bound(gf_network, m, b)
            row = {"phase": "kernel_timing", "matrix": name,
                   "bytes_per_shard": b, "ms": ms,
                   "back_to_back_ms": b2b_ms,
                   "input_GBps": 10 * b / ms / 1e6, **bd,
                   "share_of_bound": bd["bound_ms"] / ms,
                   "share_of_bound_back_to_back": bd["bound_ms"] / b2b_ms,
                   "moved_GBps_back_to_back": moved,
                   "achievable_GBps": achievable,
                   "share_of_achievable": moved / achievable,
                   "plain_ms": plain_ms, "card": power}
            emit(row)
            rows.append(row)
            del data, src, dst
    return rows


# -- phase 4 -------------------------------------------------------------


# data of one needle: 1 B to 256 KiB, as phase 4 has always drawn them
NEEDLE_MAX_DATA = 256 * 1024
_APPEND_AT_NS = 1_700_000_000 * 10**9  # needles' write times start here


def _record_size(data_len):
    """Bytes of a version-3 needle record with `data_len` bytes of data and
    no name, mime or other optional field (needle.py's layout): header 16,
    body (data size 4, data, flags 1), checksum 4, append time 8, padding
    1..8 to the next 8-byte boundary."""
    used = 16 + (data_len + 5) + 4 + 8
    return used + 8 - used % 8


def _plan_needles(avail: int, rng) -> np.ndarray:
    """Data lengths of needles whose records fill exactly `avail` bytes
    (a multiple of 8): seeded lengths of 1 B..256 KiB, then the last
    records sized to close the volume."""
    max_rec = int(_record_size(NEEDLE_MAX_DATA))
    lens = rng.integers(1, NEEDLE_MAX_DATA + 1,
                        avail // (NEEDLE_MAX_DATA // 2) + 16, dtype=np.int64)
    used = np.cumsum(_record_size(lens))
    keep = int(np.searchsorted(used, avail - 2 * max_rec, side="right"))
    rest = avail - (int(used[keep - 1]) if keep else 0)
    # the rest as m records of a multiple of 8 bytes each, none above
    # max_rec; a record of p bytes carries p - 41 bytes of data (padding 8)
    m = -(-rest // (max_rec - 64)) + 1
    piece = rest // 8 // m * 8
    tail = [piece] * (m - 1) + [rest - piece * (m - 1)]
    return np.concatenate([lens[:keep], np.asarray(tail, np.int64) - 41])


def make_volume(base: str, size: int, seed: int, device: str = "cuda") -> int:
    """A sealed volume of real needle records, `size` bytes of `<base>.dat`:
    the port's superblock (version 3), then version-3 needles of seeded
    random data (1 B..256 KiB, drawn on `device`) with the port's native
    CRC32-C, filling the volume exactly; and one .idx entry per needle, keys
    in shuffled order so the .ecx sort does real work.  -> needle count."""
    import struct

    from seaweedfs_tpu_torch.ops import crc32c
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    sb = SuperBlock().to_bytes()
    lens = _plan_needles(size - len(sb), rng)
    recs = _record_size(lens)
    offsets = len(sb) + np.concatenate([[0], np.cumsum(recs)[:-1]])
    if offsets[-1] + recs[-1] != size or lens.min() < 1 \
            or lens.max() > NEEDLE_MAX_DATA:
        raise AssertionError("needle plan does not fill the volume")
    n = len(lens)
    keys = rng.permutation(np.arange(1, n + 1, dtype=np.uint64)
                           * np.uint64(7919))
    cookies = rng.integers(0, 2**32, n, dtype=np.uint64)
    head = struct.Struct(">IQII")  # cookie, id, size, data size
    tail = struct.Struct(">BIQ")  # flags, masked checksum, append time
    with open(base + ".dat", "wb") as f:
        f.write(sb)
        i = 0
        while i < n:  # ~256 MiB of records per chunk
            j = int(np.searchsorted(offsets, offsets[i] + 256 * MIB)) or n
            j = max(j, i + 1)
            chunk = np.zeros(int(offsets[j - 1] + recs[j - 1] - offsets[i]),
                             np.uint8)
            data = torch.randint(0, 256, (int(lens[i:j].sum()),),
                                 dtype=torch.uint8, device=device,
                                 generator=gen).cpu().numpy()
            at = 0
            for k in range(i, j):
                ln, o = int(lens[k]), int(offsets[k] - offsets[i])
                payload = data[at:at + ln]
                chunk[o:o + 20] = np.frombuffer(head.pack(
                    int(cookies[k]), int(keys[k]), ln + 5, ln), np.uint8)
                chunk[o + 20:o + 20 + ln] = payload
                chunk[o + 20 + ln:o + 33 + ln] = np.frombuffer(tail.pack(
                    0, crc32c.value(payload), _APPEND_AT_NS + k), np.uint8)
                at += ln
            f.write(chunk)
            i = j
    entries = np.empty(n, dtype=[("k", ">u8"), ("o", ">u4"), ("s", ">u4")])
    entries["k"], entries["o"], entries["s"] = keys, offsets // 8, lens + 5
    entries.tofile(base + ".idx")
    return n


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


def check_parity(base: str, rs_cuda, gf256, slice_size: int,
                 offsets=None, device: str = "cuda") -> int:
    """Every encode slice's parity shards (or those at `offsets`) against
    the plain version on `device`; -> slices checked."""
    m = gf256.rs_parity_matrix(10, 4)
    shard_size = os.path.getsize(base + ".ec00")
    n = 0
    if offsets is None:
        offsets = range(0, shard_size, slice_size)
    for off in offsets:
        w = min(slice_size, shard_size - off)
        rows = [np.fromfile(base + f".ec{i:02d}", dtype=np.uint8, count=w,
                            offset=off) for i in range(14)]
        data = torch.from_numpy(np.stack(rows[:10])).to(device)
        want = rs_cuda.gf_apply_reference(m, data)
        got = torch.from_numpy(np.stack(rows[10:])).to(device)
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


def sha256_all(paths: list[str]) -> list[str]:
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(sha256_of, paths))


# a loss set whose decode plan phase 2 does not compile
UNWARMED_LOSS = (5, 6, 7, 8)


def phase_unwarmed_rebuild(rs_cuda, _build, enc, base: str) -> dict:
    """`UNWARMED_LOSS` rebuilt twice: the first rebuild meets a decode plan
    no earlier phase compiled, so its wall time holds that kernel's build
    (an NVRTC compile, or a disk hit when an earlier process on this
    machine compiled it); the second finds it loaded.  -> timings."""
    paths = [base + f".ec{i:02d}" for i in UNWARMED_LOSS]
    digests = sha256_all(paths)
    times, builds = [], []
    for _ in range(2):
        for p in paths:
            os.remove(p)
        before = rs_cuda.cache_stats()
        compiled = set(_build.COMPILE_SECONDS)
        t0 = time.perf_counter()
        rebuilt = enc.rebuild_ec_files(base, codec_name="cuda")
        times.append(time.perf_counter() - t0)
        after = rs_cuda.cache_stats()
        builds.append({k: after[k] - before[k]
                       for k in ("compiles", "disk_hits", "loads")})
        builds[-1]["compile_s"] = sum(
            s for k, s in _build.COMPILE_SECONDS.items() if k not in compiled)
        if rebuilt != list(UNWARMED_LOSS):
            raise AssertionError(f"rebuilt {rebuilt}, expected "
                                 f"{list(UNWARMED_LOSS)}")
        if sha256_all(paths) != digests:
            raise AssertionError(f"rebuilt {UNWARMED_LOSS} differ by sha256")
    if builds[0]["loads"] != 1 or builds[1]["loads"]:
        raise AssertionError(f"kernel loads per rebuild: {builds}")
    return {"lost": list(UNWARMED_LOSS), "first_s": times[0],
            "second_s": times[1], "first_build": builds[0],
            "second_build": builds[1], "sha256_equal": True}


def read_rate(path: str) -> float:
    """GB/s of one sequential pass over `path` in encode-slice-sized reads:
    the host-side floor of the encode's prefetch stage."""
    buf = bytearray(160 * MIB)
    t0 = time.perf_counter()
    with open(path, "rb", buffering=0) as f:
        while f.readinto(buf):
            pass
    return os.path.getsize(path) / (time.perf_counter() - t0) / 1e9


def phase_end_to_end(rs_cuda, gf256, _build, enc, work: str, size: int,
                     seed: int, reduced: list[str], kernel_ms: float) -> dict:
    """`kernel_ms`: the kernel's timed parity time at the encode's slice
    width, to estimate the card's busy share of the encode."""
    base = os.path.join(work, "1")
    t0 = time.perf_counter()
    needles = make_volume(base, size, seed)
    setup_s = time.perf_counter() - t0
    emit({"phase": "make_volume", "volumes": 1, "volume_bytes": size,
          "needles": needles, "seconds": setup_s})
    dat_read_GBps = read_rate(base + ".dat")

    cache_before = rs_cuda.cache_stats()
    rs_cuda.gf_apply.launches = 0
    rs_cuda.gf_apply_batched.launches = 0
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
    cache_after = rs_cuda.cache_stats()
    rebuild_slices = -(-shard_size // enc.DEFAULT_SLICE)
    if rs_cuda.gf_apply_batched.launches:
        raise AssertionError("the direct route made batched launches")

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
    unwarmed = phase_unwarmed_rebuild(rs_cuda, _build, enc, base)
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
           "layout_sampled": 64, "reduced": reduced,
           "compiles_in_flows": cache_after["compiles"]
           - cache_before["compiles"], "cache": cache_after,
           "unwarmed_rebuild": unwarmed}
    emit(row)
    return row, digests


# -- phase 4b: ec_reads ----------------------------------------------------

EC_READ_SAMPLE = 4096
EC_READ_THREADS = 16
EC_READ_SERIAL = 256  # keys read one at a time, traced, after each pass
EC_READ_LOSS = (0, 1, 2, 3)  # the worst decode plan: all 4 rows
# a loss set whose decode plan (data rows 1, 4, 9) no earlier phase
# compiles: the first degraded read on it holds that plan's NVRTC compile
COLD_READ_LOSS = (1, 4, 9, 12)
DEGRADED_WIDTHS = (4 * 1024, 64 * 1024, 256 * 1024)


def time_degraded_kernel(rs_cuda, gf256, gf_network, gen, power
                         ) -> list[dict]:
    """The .ec00-.ec03 decode plan at degraded-read widths: what one
    degraded interval of a 4 KiB, 64 KiB or 256 KiB needle launches."""
    m = rebuild_plan(gf256)
    rows = []
    for b in DEGRADED_WIDTHS:
        data = random_u8((10, b), gen)
        ms = time_ms(lambda: rs_cuda.gf_apply(m, data))
        b2b_ms = time_back_to_back_ms(lambda: rs_cuda.gf_apply(m, data))
        plain_ms = time_ms(lambda: rs_cuda.gf_apply_reference(m, data),
                           reps=10, warmup=1)
        bd = bound(gf_network, m, b)
        row = {"phase": "degraded_kernel_timing", "matrix": "plan[0, 1, 2, 3]",
               "bytes_per_shard": b, "ms": ms, "back_to_back_ms": b2b_ms,
               **bd, "share_of_bound": bd["bound_ms"] / ms,
               "share_of_bound_back_to_back": bd["bound_ms"] / b2b_ms,
               "plain_ms": plain_ms, "card": power}
        emit(row)
        rows.append(row)
    return rows


def _degraded_keys(ev, keys, lost) -> list[int]:
    """The keys among `keys` with an interval on a shard in `lost`."""
    out = []
    for k in keys:
        for iv in ev.locate(k)[2]:
            sid, _ = iv.to_shard_id_and_offset(ev.large_block_size,
                                               ev.small_block_size)
            if sid in lost:
                out.append(k)
                break
    return out


def _check_needle(got, want, key: int) -> None:
    if (got.id != key or got.data != want.data or got.cookie != want.cookie
            or got.checksum != want.checksum):
        raise AssertionError(f"needle {key:x} read back differs from the "
                             ".dat record")


class _ReadCounters:
    """Deltas of the read path's counters over one pass: interval cache,
    single-flight, the cuda codec's reconstruct histogram, kernel builds."""

    def __init__(self, rs_cuda, metrics):
        self.rs_cuda = rs_cuda
        self.children = {
            "hit": metrics.EC_INTERVAL_CACHE.labels("hit"),
            "miss": metrics.EC_INTERVAL_CACHE.labels("miss"),
            "leader": metrics.EC_SINGLEFLIGHT.labels("leader"),
            "coalesced": metrics.EC_SINGLEFLIGHT.labels("coalesced")}
        self.rec = metrics.EC_OP_HISTOGRAM.labels("reconstruct", "cuda")

    def snapshot(self) -> dict:
        out = {k: c.value for k, c in self.children.items()}
        out["reconstruct_cuda"] = self.rec.count
        out["compiles"] = self.rs_cuda.cache_stats()["compiles"]
        return out

    def start(self) -> None:
        self.before = self.snapshot()
        self.rs_cuda.gf_apply.launches = 0
        self.rs_cuda.gf_apply_batched.launches = 0

    def read(self) -> dict:
        after = self.snapshot()
        d = {k: int(after[k] - self.before[k]) for k in after}
        return {"degraded_intervals": d["hit"] + d["miss"],
                "interval_cache_hits": d["hit"], "gathers": d["leader"],
                "coalesced": d["coalesced"],
                "launches": self.rs_cuda.gf_apply.launches,
                "batched_launches": self.rs_cuda.gf_apply_batched.launches,
                "compiles": d["compiles"],
                "reconstruct_cuda_calls": d["reconstruct_cuda"],
                "reconstruct_cuda_count": self.rec.count}


def read_pass(ev, name: str, keys: list[int], want: dict,
              counters: _ReadCounters, serial_keys: list[int]) -> dict:
    """Every key of `keys` read with EC_READ_THREADS threads through
    EcVolume.read_needle, each checked against its .dat record; then
    `serial_keys` read one at a time, each in a trace, for where a read's
    time goes without contention: the codec's span (`ec.reconstruct` or
    `ec.reconstruct_one`) and, on the card, its upload, kernel and readback
    spans, against the whole read."""
    from seaweedfs_tpu_torch.telemetry import trace

    def one(key: int) -> float:
        t0 = time.perf_counter()
        got = ev.read_needle(key)
        dt = time.perf_counter() - t0
        _check_needle(got, want[key], key)
        return dt

    counters.start()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(EC_READ_THREADS) as pool:
        lat = np.asarray(list(pool.map(one, keys)))
    wall = time.perf_counter() - t0
    threaded = counters.read()

    trace.TRACER.clear()
    counters.start()
    serial = []
    for key in serial_keys:
        with trace.start_span("chip_smoke.read_needle"):
            serial.append(one(key))
    ser = counters.read()
    spans: dict[str, list] = {}
    for sp in trace.TRACER.spans():
        spans.setdefault(sp.name, []).append(sp.duration)
    if len(spans.get("chip_smoke.read_needle", ())) != len(serial_keys):
        raise AssertionError("the trace ring lost read spans")
    serial_stats = {"reads": len(serial_keys),
                "degraded_intervals": ser["degraded_intervals"],
                "launches": ser["launches"],
                "read_ms_mean": float(np.mean(serial)) * 1e3,
                "read_ms_p50": float(np.median(serial)) * 1e3}
    for sp_name, durs in sorted(spans.items()):
        if sp_name != "chip_smoke.read_needle":
            serial_stats[sp_name] = {"count": len(durs),
                                 "ms_mean": float(np.mean(durs)) * 1e3}
    row = {"phase": "ec_reads", "pass": name, "codec": ev.codec._impl,
           "shards_mounted": ev.shard_ids(),
           "remote_fetch": ev.remote_fetch is not None, "reads": len(keys),
           "threads": EC_READ_THREADS, "wall_s": wall,
           "reads_per_s": len(keys) / wall,
           "data_GBps": sum(len(want[k].data) for k in keys) / wall / 1e9,
           "p50_ms": float(np.percentile(lat, 50)) * 1e3,
           "p99_ms": float(np.percentile(lat, 99)) * 1e3,
           "max_ms": float(lat.max()) * 1e3, **threaded,
           "serial_traced": serial_stats, "byte_equal": True}
    emit(row)
    return row


def one_read(ev, key: int, want, counters: _ReadCounters, what: str,
             lost) -> dict:
    """One degraded read alone: its latency holds whatever the path does
    the first time, the decode plan's kernel build included."""
    built = compile_seconds(counters.rs_cuda._build)
    counters.start()
    t0 = time.perf_counter()
    got = ev.read_needle(key)
    ms = (time.perf_counter() - t0) * 1e3
    _check_needle(got, want, key)
    row = {"phase": "ec_reads_first_degraded_read", "what": what,
           "lost": list(lost), "codec": ev.codec._impl, "key": key,
           "data_bytes": len(want.data), "ms": ms, **counters.read(),
           "compile_s": sum(sec for k, sec in compile_seconds(
               counters.rs_cuda._build).items() if k not in built)}
    emit(row)
    return row


def phase_ec_reads(rs_cuda, gf256, gf_network, enc, codec_service, metrics,
                   work: str, base: str, digests: dict, seed: int, gen,
                   power: str) -> dict:
    """Needles served from phase 4's EC volume (every shard rebuilt) by the
    port's EcVolume, in passes of EC_READ_SAMPLE seeded live keys:
    (a) healthy; (b) .ec00-.ec03 unmounted, decoded on the card; (c) the
    same on the host SIMD codec; (d) a second directory of hard links to
    .ec04-.ec09, .ecx, .ecj and .vif whose remote_fetch serves .ec10-.ec13
    from phase 4's directory.  Then that directory's remote-source rebuild
    of .ec00-.ec03 on the default route, checked by sha256, and the codec
    registry's choices."""
    from seaweedfs_tpu_torch.ops import codec as codec_mod
    from seaweedfs_tpu_torch.storage.ec.volume import EcVolume, NotFoundError
    from seaweedfs_tpu_torch.storage.idx import parse_index_arrays
    from seaweedfs_tpu_torch.storage.needle import Needle, actual_size
    from seaweedfs_tpu_torch.storage.vif import save_volume_info

    t_phase = time.perf_counter()
    kernel_rows = time_degraded_kernel(rs_cuda, gf256, gf_network, gen, power)
    save_volume_info(base + ".vif", 3, "000",
                     dat_file_size=os.path.getsize(base + ".dat"))
    keys, offsets, sizes = parse_index_arrays(base + ".idx")
    # a small quick-check volume holds fewer needles than the sample
    n_sample = min(EC_READ_SAMPLE, len(keys) - 16 - 64 - EC_READ_SERIAL)
    if n_sample < EC_READ_THREADS:
        raise ValueError(f"{len(keys)} needles are too few for ec_reads")
    reduced = ([] if n_sample == EC_READ_SAMPLE else
               [f"sample {EC_READ_SAMPLE} -> {n_sample}: {len(keys)} needles"])
    pick = np.random.default_rng(seed + 3).choice(
        len(keys), n_sample + 16 + 64 + EC_READ_SERIAL, replace=False)
    want = {}
    with open(base + ".dat", "rb") as f:  # the records as written
        for i in pick:
            k = int(keys[i])
            want[k] = Needle.from_bytes(os.pread(
                f.fileno(), actual_size(int(sizes[i]), 3), int(offsets[i])), 3)
            if want[k].id != k:
                raise AssertionError(f".idx entry of {k:x} points elsewhere")
    sample = [int(keys[i]) for i in pick[:n_sample]]
    doomed = [int(keys[i]) for i in pick[n_sample:n_sample + 16]]
    spare = [int(keys[i]) for i in pick[n_sample + 16:n_sample + 80]]
    serial = [int(keys[i]) for i in pick[n_sample + 80:]]
    counters = _ReadCounters(rs_cuda, metrics)
    passes, firsts = [], []

    ev = EcVolume(base, volume_id=1, codec_name="cuda")
    try:
        for k in doomed:  # tombstoned in the .ecx, journaled in the .ecj
            ev.delete_needle(k)
        for k in doomed[:2]:
            try:
                ev.read_needle(k)
            except NotFoundError:
                continue
            raise AssertionError(f"deleted needle {k:x} still reads")
        passes.append(read_pass(ev, "a_healthy", sample, want, counters, serial))
        for sid in EC_READ_LOSS:
            ev.delete_shard(sid)
        first = _degraded_keys(ev, spare, EC_READ_LOSS)[0]
        firsts.append(one_read(ev, first, want[first], counters,
                               "first degraded read of the process",
                               EC_READ_LOSS))
        passes.append(read_pass(ev, "b_degraded_cuda", sample, want,
                                counters, serial))
    finally:
        ev.close()
    ev = EcVolume(base, volume_id=1, codec_name="cpu")
    try:
        for sid in EC_READ_LOSS:
            ev.delete_shard(sid)
        passes.append(read_pass(ev, "c_degraded_cpu", sample, want, counters,
                                serial))
    finally:
        ev.close()

    remote_dir = os.path.join(work, "remote")
    os.makedirs(remote_dir)
    base2 = os.path.join(remote_dir, "1")
    for ext in [f".ec{i:02d}" for i in range(4, 10)] + [".ecx", ".ecj",
                                                         ".vif"]:
        os.link(base + ext, base2 + ext)  # hard links: no extra disk
    peer = {sid: os.open(base + f".ec{sid:02d}", os.O_RDONLY)
            for sid in range(10, 14)}

    def remote_fetch(sid: int, off: int, length: int):
        fd = peer.get(sid)
        return None if fd is None else os.pread(fd, length, off)

    try:
        ev = EcVolume(base2, volume_id=1, codec_name="cuda")
        ev.remote_fetch = remote_fetch
        try:
            passes.append(read_pass(ev, "d_remote_cuda", sample, want,
                                    counters, serial))
        finally:
            ev.close()
        ev = EcVolume(base, volume_id=1, codec_name="cuda")
        try:
            for sid in COLD_READ_LOSS:
                ev.delete_shard(sid)
            cold = _degraded_keys(ev, spare, (1, 4, 9))[0]
            firsts.append(one_read(ev, cold, want[cold], counters,
                                   "first read of a decode plan new to the "
                                   "machine", COLD_READ_LOSS))
        finally:
            ev.close()

        # the codec registry: the card must be the effective codec; `auto`
        # reports its choice and both round trips, whichever wins
        effective = codec_mod.effective_codec("cuda")
        t0 = time.perf_counter()
        auto = codec_mod.get_codec("auto")._impl
        choice = {"phase": "codec_choice", "effective_codec_cuda":
                  list(effective), "auto": auto,
                  "auto_times": dict(codec_mod.AUTO_TIMES),
                  "auto_resolve_s": time.perf_counter() - t0}
        emit(choice)

        saved = os.environ.pop("SEAWEEDFS_TPU_EC_SERVICE", None)
        try:  # the default route, as a user's call takes it
            route = ("service" if codec_service.service_for_codec("cuda")
                     else "direct")
            shard_size = os.path.getsize(base2 + ".ec04")
            counters.start()
            t0 = time.perf_counter()
            rebuilt = enc.rebuild_ec_files(base2, codec_name="cuda",
                                           remote_fetch=remote_fetch)
            rebuild_s = time.perf_counter() - t0
            rb = counters.read()
        finally:
            if saved is not None:
                os.environ["SEAWEEDFS_TPU_EC_SERVICE"] = saved
        if rebuilt != list(EC_READ_LOSS):
            raise AssertionError(f"remote rebuild made {rebuilt}")
        got = sha256_all([base2 + f".ec{i:02d}" for i in EC_READ_LOSS])
        if got != [digests[i] for i in EC_READ_LOSS]:
            raise AssertionError("remote rebuild differs from phase 4's "
                                 "shards by sha256")
        remote_rebuild = {
            "phase": "ec_remote_rebuild", "route": route,
            "local_shards": list(range(4, 10)),
            "remote_shards": list(range(10, 14)),
            "rebuilt": rebuilt, "seconds": rebuild_s,
            "GBps_read": 10 * shard_size / rebuild_s / 1e9,
            "launches": rb["launches"],
            "batched_launches": rb["batched_launches"],
            "compiles": rb["compiles"], "sha256_equal": True}
        emit(remote_rebuild)
    finally:
        for fd in peer.values():
            os.close(fd)
        shutil.rmtree(remote_dir, ignore_errors=True)

    by = {p["pass"]: p for p in passes}
    b, c, d = by["b_degraded_cuda"], by["c_degraded_cpu"], by["d_remote_cuda"]
    if by["a_healthy"]["degraded_intervals"] or by["a_healthy"]["launches"]:
        raise AssertionError("the healthy pass decoded")
    for p in (b, d, b["serial_traced"], d["serial_traced"]):
        if not p["degraded_intervals"] or p["launches"] < p["degraded_intervals"]:
            raise AssertionError(
                f"pass {p.get('pass', 'serial')}: {p['launches']} launches "
                f"for {p['degraded_intervals']} degraded intervals")
    if not c["degraded_intervals"] or c["launches"] or c["batched_launches"] \
            or c["serial_traced"]["launches"]:
        raise AssertionError(f"the cpu pass made {c['launches']} launches")
    if effective != ("cuda", ""):
        raise AssertionError(f"effective_codec('cuda') = {effective}")
    if remote_rebuild["launches"] + remote_rebuild["batched_launches"] == 0:
        raise AssertionError("the remote rebuild launched no kernel")
    read_launches = sum(p["launches"] + p["serial_traced"]["launches"]
                        for p in passes) + sum(f["launches"] for f in firsts)
    row = {"phase": "ec_reads_summary", "sample": n_sample,
           "reduced": reduced,
           "deleted": len(doomed), "passes": len(passes),
           "read_launches": read_launches,
           "rebuild_launches": remote_rebuild["launches"],
           "rebuild_batched_launches": remote_rebuild["batched_launches"],
           "kernel_rows": len(kernel_rows),
           "wall_s": time.perf_counter() - t_phase}
    emit(row)
    return {**row, "kernel_rows": kernel_rows}


# -- phase store_lifecycle ---------------------------------------------------

STORE_READ_LOSS = (0, 1, 2, 3)
STORE_CORRUPT_SHARD = 2
# the flipped byte lies in one of the last this-many scrub intervals, and
# the scan that must find it resumes at its interval (the scrubber's
# persisted cursor), so it costs no third full pass
STORE_CORRUPT_TAIL = 16


def _zero_launches(rs_cuda) -> None:
    rs_cuda.gf_apply.launches = 0
    rs_cuda.gf_apply_batched.launches = 0


def _launches(rs_cuda) -> dict:
    return {"gf_matmul": rs_cuda.gf_apply.launches,
            "gf_matmul_batched": rs_cuda.gf_apply_batched.launches}


def store_write(store, size: int, seed: int, device: str) -> tuple:
    """Volume 1 filled to `size` bytes through Store.write_needle: needles
    of seeded random data (1 B..256 KiB, drawn on `device` in chunks of
    ~256 MiB), keys shuffled, write times from the seed.  -> ({key: (data
    length, CRC32-C, cookie)}, the row to print)."""
    from seaweedfs_tpu_torch.storage.needle import Needle

    rng = np.random.default_rng(seed + 11)
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    v = store.find_volume(1)
    lens = _plan_needles(size - v.content_size, rng)
    n = len(lens)
    keys = rng.permutation(np.arange(1, n + 1, dtype=np.uint64)
                           * np.uint64(7919))
    cookies = rng.integers(0, 2**32, n, dtype=np.uint64)
    ends = np.cumsum(lens)
    written: dict[int, tuple] = {}
    gen_s = write_s = 0.0
    i = 0
    while i < n:
        j = max(int(np.searchsorted(ends, ends[i] + 256 * MIB)), i + 1)
        j = min(j, n)
        t0 = time.perf_counter()
        data = torch.randint(0, 256, (int(lens[i:j].sum()),),
                             dtype=torch.uint8, device=device,
                             generator=gen).cpu().numpy()
        cuts = np.concatenate([[0], np.cumsum(lens[i:j])])
        payloads = [data[cuts[k]:cuts[k + 1]].tobytes()
                    for k in range(j - i)]
        del data
        t1 = time.perf_counter()
        for k, payload in zip(range(i, j), payloads):
            nd = Needle(cookie=int(cookies[k]), id=int(keys[k]),
                        data=payload, append_at_ns=_APPEND_AT_NS + k)
            store.write_needle(1, nd)
            written[int(keys[k])] = (len(payload), nd.checksum,
                                     int(cookies[k]))
        write_s += time.perf_counter() - t1
        gen_s += t1 - t0
        i = j
    if v.content_size != size or len(v.needle_map) != n:
        raise AssertionError(f"volume holds {v.content_size} bytes and "
                             f"{len(v.needle_map)} needles, not {size} and {n}")
    row = {"needles": n, "volume_bytes": size, "write_s": write_s,
           "data_gen_s": gen_s, "GBps": size / write_s / 1e9,
           "needles_per_s": n / write_s}
    return written, row


def _check_written(got, key: int, want: tuple) -> None:
    length, crc, cookie = want
    if (got.id != key or got.cookie != cookie or len(got.data) != length
            or got.checksum != crc):
        raise AssertionError(f"needle {key:x} read back differs from what "
                             "was written")


def store_read_pass(store, name: str, keys: list[int], written: dict,
                    counters) -> dict:
    """Every key of `keys` read with EC_READ_THREADS threads through
    Store.read_needle (the store's needle cache emptied first, so every
    read goes to the volume), each checked against what was written: id,
    cookie, length and CRC32-C, which the needle parser verifies against
    the data."""

    def one(key: int) -> float:
        t0 = time.perf_counter()
        got = store.read_needle(1, key)
        dt = time.perf_counter() - t0
        _check_written(got, key, written[key])
        return dt

    if store.needle_cache is not None:
        store.needle_cache.clear()
    counters.start()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(EC_READ_THREADS) as pool:
        lat = np.asarray(list(pool.map(one, keys)))
    wall = time.perf_counter() - t0
    c = counters.read()
    return {"pass": name, "reads": len(keys), "threads": EC_READ_THREADS,
            "wall_s": wall, "reads_per_s": len(keys) / wall,
            "data_GBps": sum(written[k][0] for k in keys) / wall / 1e9,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "degraded_intervals": c["degraded_intervals"],
            "interval_cache_hits": c["interval_cache_hits"],
            "launches": c["launches"],
            "batched_launches": c["batched_launches"],
            "compiles": c["compiles"], "byte_equal": True}


def _scrub_row(r: dict, seconds: float, rs_cuda, codec: str) -> dict:
    return {"codec": codec, "intervals": r["scanned"], "bytes": r["bytes"],
            "corrupt_shards": r["corrupt_shards"], "seconds": seconds,
            "bytes_per_s": r["bytes"] / seconds,
            "ms_per_interval": seconds / max(r["scanned"], 1) * 1e3,
            **_launches(rs_cuda)}


def _stage_seconds(metrics) -> dict:
    """The codec service's seconds so far in each stage of its batches
    (build: the uploads; compute: the launch; readback: the wait for the
    kernel and the copy back)."""
    return {st: metrics.EC_SERVICE_STAGE.labels(st).total
            for st in ("build", "compute", "readback")}


def _scrub_from(store, scrub, directory: str, offset: int):
    """A scrubber over `store` whose EC cursor for volume 1 is `offset`,
    set as a restart finds it (the cursor file), and its scrub_once:
    the scan resumes there and runs to the shard's end."""
    with open(os.path.join(directory, scrub.CURSOR_FILE), "w") as f:
        json.dump({"volume": {}, "ec": {"1": offset}}, f)
    scrubber = scrub.Scrubber(store, rate_mbps=0)
    return scrubber, scrubber.scrub_once()


def _check_route(route: str, launches: dict, jobs: int, what: str,
                 exact: bool) -> None:
    """The kernel a step must have launched: on the service route batched
    launches only, one per job when `exact` (jobs that arrive one at a
    time), else 1..jobs (the service may coalesce); on the direct route
    one gf_matmul launch per job."""
    batched, direct = launches["gf_matmul_batched"], launches["gf_matmul"]
    if route == "service":
        ok = not direct and (batched == jobs if exact
                             else 1 <= batched <= jobs)
    else:
        ok = not batched and direct == jobs
    if not ok:
        raise AssertionError(f"{what} on the {route} route: {launches} "
                             f"for {jobs} jobs")


def phase_store_lifecycle(rs_cuda, gf256, enc, codec_service, metrics,
                          work: str, size: int, seed: int,
                          reduced: list[str], device: str = "cuda") -> dict:
    """An operator's volume lifecycle through the port's Store on the
    `cuda` codec with the default service settings, every step on one
    Store([work]): write needles, seal, `ec.encode`, delete the volume and
    mount its shards, serve reads healthy and degraded, `ec.rebuild`,
    scrub (on `cuda`, then on a second `cpu` Store over the directory,
    then after a flipped byte in .ec02, localized, quarantined and
    repaired), and `ec.decode` back to a volume read again.  Launch counts
    are zeroed just before each step and read just after.  -> the steps'
    launches by kernel, and the rows."""
    from seaweedfs_tpu_torch.storage import scrub
    from seaweedfs_tpu_torch.storage.store import Store

    t_phase = time.perf_counter()
    store = Store([work])
    base = os.path.join(work, "1")
    steps: dict[str, dict] = {}
    try:
        store.add_volume(1, "")
        written, row = store_write(store, size, seed, device)
        store.mark_readonly(1)
        store.find_volume(1).sync()
        dat_sha = sha256_of(base + ".dat")
        emit({"phase": "store_write", **row, "reduced": reduced})
        steps["store_write"] = row

        # ec.encode on the default route, as a user's call takes it
        route = ("service" if codec_service.service_for_codec(
            store.codec_name) else "direct")
        slices = len(list(enc._slice_tasks(
            size, enc.LARGE_BLOCK_SIZE, enc.SMALL_BLOCK_SIZE,
            enc.DEFAULT_SLICE)))
        _zero_launches(rs_cuda)
        t0 = time.perf_counter()
        store.generate_ec_shards(1, "")
        encode_s = time.perf_counter() - t0
        launches = _launches(rs_cuda)
        _check_route(route, launches, slices, "encode", exact=False)
        check_ecx(base)
        shard_size = os.path.getsize(base + ".ec00")
        offs = list(range(0, shard_size, enc.DEFAULT_SLICE))
        sampled = sorted(np.random.default_rng(seed + 12).choice(
            len(offs), min(8, len(offs)), replace=False).tolist())
        checked = check_parity(base, rs_cuda, gf256, enc.DEFAULT_SLICE,
                               [offs[i] for i in sampled], device)
        store.delete_volume(1)
        if os.path.exists(base + ".dat"):
            raise AssertionError("delete_volume left the .dat")
        store.mount_ec_shards(1, "", list(range(14)))
        row = {"route": route, "seconds": encode_s,
               "GBps": size / encode_s / 1e9, "slices": slices,
               "launches": launches, "shard_bytes": shard_size,
               "ecx_sorted": True, "parity_slices_checked": checked}
        emit({"phase": "store_ec_encode", **row})
        steps["store_encode"] = row

        # reads, healthy then with .ec00-.ec03 lost
        counters = _ReadCounters(rs_cuda, metrics)
        sample = [int(k) for k in np.random.default_rng(seed + 13).choice(
            np.fromiter(written, np.uint64), min(EC_READ_SAMPLE,
                                                  len(written)),
            replace=False)]
        healthy = store_read_pass(store, "healthy", sample, written,
                                  counters)
        lost = list(STORE_READ_LOSS)
        digests = dict(zip(lost, sha256_all(
            [base + f".ec{i:02d}" for i in lost])))
        store.delete_ec_shards(1, "", lost)
        degraded = store_read_pass(store, "degraded_ec00_ec03", sample,
                                   written, counters)
        if healthy["degraded_intervals"] or healthy["launches"] \
                or healthy["batched_launches"]:
            raise AssertionError(f"the healthy pass decoded: {healthy}")
        if not degraded["degraded_intervals"] \
                or degraded["launches"] < degraded["degraded_intervals"]:
            raise AssertionError(
                f"{degraded['launches']} launches for "
                f"{degraded['degraded_intervals']} degraded intervals")
        emit({"phase": "store_reads", "passes": [healthy, degraded]})
        steps["store_reads"] = {"launches": {
            "gf_matmul": healthy["launches"] + degraded["launches"],
            "gf_matmul_batched": healthy["batched_launches"]
            + degraded["batched_launches"]}}

        # ec.rebuild of the lost shards, on the default route
        rebuild_slices = -(-shard_size // enc.DEFAULT_SLICE)
        _zero_launches(rs_cuda)
        t0 = time.perf_counter()
        rebuilt = store.rebuild_ec_shards(1, "")
        rebuild_s = time.perf_counter() - t0
        launches = _launches(rs_cuda)
        if rebuilt != lost:
            raise AssertionError(f"rebuilt {rebuilt}, expected {lost}")
        if sha256_all([base + f".ec{i:02d}" for i in lost]) != \
                [digests[i] for i in lost]:
            raise AssertionError("rebuilt shards differ by sha256")
        _check_route(route, launches, rebuild_slices, "rebuild", exact=False)
        store.mount_ec_shards(1, "", lost)
        row = {"route": route, "rebuilt": rebuilt, "seconds": rebuild_s,
               "GBps_read": 10 * shard_size / rebuild_s / 1e9,
               "slices": rebuild_slices, "launches": launches,
               "sha256_equal": True}
        emit({"phase": "store_rebuild", **row})
        steps["store_rebuild"] = row

        # scrub: a full pass on the cuda store, then on a cpu store
        scrubber = scrub.Scrubber(store, rate_mbps=0)
        store.scrubber = scrubber
        stages = _stage_seconds(metrics)
        _zero_launches(rs_cuda)
        t0 = time.perf_counter()
        r = scrubber.scrub_volume(1)
        cuda_scrub = _scrub_row(r, time.perf_counter() - t0, rs_cuda,
                                store.codec_name)
        cuda_scrub["service_stage_ms_per_interval"] = {
            st: (sec - stages[st]) / max(r["scanned"], 1) * 1e3
            for st, sec in _stage_seconds(metrics).items()}
        if r["corrupt_shards"] or scrubber.outstanding_findings():
            raise AssertionError(f"the cuda scrub found {r}")
        intervals = -(-shard_size // scrubber.ec_interval)
        if r["scanned"] != intervals:
            raise AssertionError(f"scrubbed {r['scanned']} of {intervals} "
                                 "intervals")
        _check_route(route, _launches(rs_cuda), intervals, "scrub",
                     exact=True)
        cpu_store = Store([work], codec_name="cpu")
        try:
            cpu_scrubber = scrub.Scrubber(cpu_store, rate_mbps=0)
            _zero_launches(rs_cuda)
            t0 = time.perf_counter()
            r = cpu_scrubber.scrub_volume(1)
            cpu_scrub = _scrub_row(r, time.perf_counter() - t0, rs_cuda,
                                   cpu_store.codec_name)
        finally:
            cpu_store.close()
        if r["corrupt_shards"] or cpu_scrubber.outstanding_findings() \
                or r["scanned"] != intervals:
            raise AssertionError(f"the cpu scrub found {r}")
        if any(_launches(rs_cuda).values()):
            raise AssertionError(f"the cpu scrub launched {_launches(rs_cuda)}")

        # one flipped byte in .ec02: exactly one finding, localized
        rng = np.random.default_rng(seed + 14)
        tail = min(STORE_CORRUPT_TAIL * scrubber.ec_interval, shard_size)
        pos = shard_size - 1 - int(rng.integers(0, tail))
        at = pos // scrubber.ec_interval * scrubber.ec_interval
        width = min(scrubber.ec_interval, shard_size - at)
        path = base + f".ec{STORE_CORRUPT_SHARD:02d}"
        fd = os.open(path, os.O_RDWR)
        try:
            byte = os.pread(fd, 1, pos)
            os.pwrite(fd, bytes([byte[0] ^ 0xFF]), pos)
        finally:
            os.close(fd)
        _zero_launches(rs_cuda)
        found, summary = _scrub_from(store, scrub, work, at)
        corrupt_launches = _launches(rs_cuda)
        findings = found.outstanding_findings()
        want = {"volume_id": 1, "kind": "ec_shard",
                "shard_id": STORE_CORRUPT_SHARD, "needle_id": 0,
                "detail": f"parity mismatch at {at}+{width}"}
        if summary["corrupt_shards"] != 1 or len(findings) != 1 or {
                k: findings[0][k] for k in want} != want:
            raise AssertionError(f"flipped byte at {pos}: {summary}, "
                                 f"{findings}")
        quarantined = found.quarantine.status()["shards"]
        if quarantined != {"1": [STORE_CORRUPT_SHARD]}:
            raise AssertionError(f"quarantine holds {quarantined}")
        # repair: the rotten shard deleted and rebuilt, then remounted
        store.scrubber = found
        store.delete_ec_shards(1, "", [STORE_CORRUPT_SHARD])
        rebuilt = store.rebuild_ec_shards(1, "")
        if rebuilt != [STORE_CORRUPT_SHARD] or sha256_of(path) != \
                digests[STORE_CORRUPT_SHARD]:
            raise AssertionError(f"repair rebuilt {rebuilt}")
        store.mount_ec_shards(1, "", [STORE_CORRUPT_SHARD])
        if found.outstanding_findings() or \
                found.quarantine.status()["shards"]:
            raise AssertionError("the remount left the finding standing")
        rescan, summary = _scrub_from(store, scrub, work, at)
        if summary["corrupt_shards"] or rescan.outstanding_findings():
            raise AssertionError(f"the repaired interval scrubs {summary}")
        row = {"cuda": cuda_scrub, "cpu": cpu_scrub,
               "interval_bytes": scrubber.ec_interval,
               "corrupt": {"shard": STORE_CORRUPT_SHARD, "byte": pos,
                           "interval": at, "width": width,
                           "scanned_from_cursor": summary["scanned_bytes"],
                           "launches": corrupt_launches,
                           "finding": want["detail"],
                           "quarantined_then_cleared": True,
                           "repair_sha256_equal": True},
               "launches": {k: cuda_scrub[k] for k in
                            ("gf_matmul", "gf_matmul_batched")}}
        emit({"phase": "store_scrub", **row})
        steps["store_scrub"] = row

        # ec.decode back to a normal volume, read again
        t0 = time.perf_counter()
        store.ec_shards_to_volume(1, "")
        decode_s = time.perf_counter() - t0
        if store.find_volume(1) is None or store.find_ec_volume(1):
            raise AssertionError(f"after ec.decode: {store.status()}")
        if sha256_of(base + ".dat") != dat_sha:
            raise AssertionError("decoded .dat differs by sha256")
        again = store_read_pass(store, "decoded_volume", sample, written,
                                counters)
        if again["launches"] or again["batched_launches"]:
            raise AssertionError("reads of the decoded volume launched")
        row = {"seconds": decode_s, "GBps": size / decode_s / 1e9,
               "dat_sha256_equal": True, "reads": again}
        emit({"phase": "store_ec_decode", **row})
        steps["store_decode"] = row
    finally:
        store.close()
    by_kernel: dict[str, dict] = {"gf_matmul": {}, "gf_matmul_batched": {}}
    for path in ("store_encode", "store_reads", "store_rebuild",
                 "store_scrub"):
        for kernel, n in steps[path]["launches"].items():
            if n:
                by_kernel[kernel][path] = n
    emit({"phase": "store_lifecycle_summary", "route": route,
          "launches_by_path": by_kernel, "reduced": reduced,
          "wall_s": time.perf_counter() - t_phase})
    return {"launches_by_path": by_kernel, "steps": steps}


# -- phase 5 -------------------------------------------------------------


def rebuild_plan(gf256, lost=(0, 1, 2, 3)) -> np.ndarray:
    return gf256.decode_plan_for(gf256.rs_matrix(10, 14), 10,
                                 [i for i in range(14) if i not in lost], lost)


def phase_batched(rs_cuda, gf256, gen) -> int:
    """gf_apply_batched and gf_sweep against their plain versions; ->
    the largest error (0, or the run has already failed)."""
    t0 = time.perf_counter()
    mats = (("parity", gf256.rs_parity_matrix(10, 4)),
            ("plan[0, 1, 2, 3]", rebuild_plan(gf256)))
    cases = []  # (name, matrix, data)
    for v in BATCH_ENTRIES:
        for b in BATCH_WIDTHS:
            for name, m in mats:
                cases.append((f"{name} V={v} B={b}", m,
                              random_u8((v, 10, b), gen)))
    # 1-byte-offset views: every row and entry starts unaligned
    for v, b in ((3, 4097), (16, 513), (2, 16 * MIB)):
        for name, m in mats:
            cases.append((f"{name} V={v} B={b} offset 1", m,
                          random_u8((v, 10, b + 1), gen)[:, :, 1:]))
    # aligned rows, odd entry stride: the batch stride alone picks the path
    flat = random_u8((3 * (10 * 4096 + 1),), gen)
    cases.append(("parity V=3 B=4096 entry stride 40961", mats[0][1],
                  flat.as_strided((3, 10, 4096), (10 * 4096 + 1, 4096, 1))))
    # more entries than gridDim.y holds: blocks walk the rest
    cases.append(("parity V=70000 B=16", mats[0][1],
                  random_u8((70000, 10, 16), gen)))
    worst = 0
    for name, m, data in cases:
        got = rs_cuda.gf_apply_batched(m, data)
        if data.shape[0] > 1000:
            # the per-entry plain loop would make ~300 small launches per
            # entry; columns are independent, so apply the plain version
            # once to all entries side by side
            v, s, b = data.shape
            flat = data.permute(1, 0, 2).reshape(s, v * b)
            want = rs_cuda.gf_apply_reference(m, flat).reshape(
                -1, v, b).permute(1, 0, 2)
        else:
            want = rs_cuda.gf_apply_batched_reference(m, data)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"batched kernel != plain for {name}: "
                                 f"max_abs_err {err}")
        worst = max(worst, err)
    sweeps = ((4096, 5, 1), (4097, 4, 4096), (513, 3, 100),
              (16 * MIB, 3, SWEEP_SHIFT))
    for b, k, shift in sweeps:
        for name, m in mats:
            buf = random_u8((10, b + (k - 1) * shift), gen)
            got = rs_cuda.gf_sweep(m, buf, b, k, shift)
            want = rs_cuda.gf_sweep_reference(m, buf, b, k, shift)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err:
                raise AssertionError(
                    f"gf_sweep != plain for {name} B={b} K={k} "
                    f"shift={shift}: max_abs_err {err}")
    emit({"phase": "batched_vs_plain", "cases": len(cases) + 2 * len(sweeps),
          "byte_equal": True, "max_abs_err": worst,
          "wall_s": time.perf_counter() - t0})
    return worst


# -- phase 6 -------------------------------------------------------------


def phase_kernel_sweep(rs_cuda, gf256, gen, power: str) -> list[dict]:
    """bench.py:104's leg on the card: K sweeps in one launch per stage."""
    m = gf256.rs_parity_matrix(10, 4)
    rows = []
    for mb, k in SWEEP_STAGES:
        t0 = time.perf_counter()
        b = mb * MIB
        buf = random_u8((10, b + (k - 1) * SWEEP_SHIFT), gen)
        out = rs_cuda.gf_sweep(m, buf, b, k, SWEEP_SHIFT)
        for kk in (k - 1, k // 2):  # the window bench.py keeps, and another
            want = rs_cuda.gf_apply_reference(
                m, buf[:, kk * SWEEP_SHIFT: kk * SWEEP_SHIFT + b])
            err = max_abs_err(out[kk], want)
            if err:
                raise AssertionError(f"sweep {kk} of stage {mb} MiB x {k}: "
                                     f"max_abs_err {err}")
            del want
        del out
        ms = time_ms(lambda: rs_cuda.gf_sweep(m, buf, b, k, SWEEP_SHIFT),
                     reps=3, warmup=2)
        b2b_ms = time_back_to_back_ms(
            lambda: rs_cuda.gf_sweep(m, buf, b, k, SWEEP_SHIFT), reps=3,
            windows=3, warmup=0)
        window = buf[:, :b]
        apply_ms = time_ms(lambda: rs_cuda.gf_apply(m, window), reps=10,
                           warmup=2)
        # the least bytes the launch must move: the overlapping windows'
        # distinct input once, and K outputs
        bound_ms = (10 * buf.shape[1] + 4 * b * k) / HBM_BYTES_PER_S * 1e3
        # bench.py:126's accounting, which re-reads each window
        bench_ms = (10 + 4) * b * k / HBM_BYTES_PER_S * 1e3
        row = {"phase": "kernel_sweep", "mb_per_shard": mb, "sweeps": k,
               "shift": SWEEP_SHIFT, "launches": 1, "ms": ms,
               "back_to_back_ms": b2b_ms,
               "bench_GBps": 10 * b * k / ms / 1e6,
               "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
               "share_of_bound_back_to_back": bound_ms / b2b_ms,
               "bench_accounting_bound_ms": bench_ms,
               "bench_accounting_share": bench_ms / ms,
               "apply_ms": apply_ms,
               "sweep_over_apply": ms / k / apply_ms,
               "windows_checked": [k - 1, k // 2], "card": power,
               "wall_s": time.perf_counter() - t0}
        emit(row)
        rows.append(row)
        del buf, window
        torch.cuda.empty_cache()
    return rows


# -- phase 7 -------------------------------------------------------------


def hist_snapshot(child) -> tuple[float, int]:
    return child.total, child.count


def phase_service(rs_cuda, gf256, enc, codec_service, metrics, work: str,
                  size: int, seed: int, reduced: list[str]) -> dict:
    """SERVICE_VOLUMES volumes encoded, then rebuilt, concurrently through
    one device-mode service."""
    t_phase = time.perf_counter()
    pr = codec_service.device_probe.probe(timeout_s=120)
    if not pr.accelerator:
        raise AssertionError(f"the device probe found no card: {pr}")
    auto = codec_service.service_for_codec("cuda")
    if auto is None or auto.mode != "device":
        raise AssertionError("default routing did not pick the device "
                             f"service: {auto and auto.mode}")
    bare = codec_service.CodecService()
    bare.close()
    if bare.mode != "device":
        raise AssertionError(f"CodecService() resolved to {bare.mode}: "
                             f"{bare.fallback_reason}")
    codec_service.shutdown_all()

    bases = [os.path.join(work, str(i + 1)) for i in range(SERVICE_VOLUMES)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVICE_VOLUMES) as pool:
        needles = sum(pool.map(
            lambda i: make_volume(bases[i], size, seed + 10 + i),
            range(SERVICE_VOLUMES)))
    setup_s = time.perf_counter() - t0
    emit({"phase": "make_volume", "volumes": SERVICE_VOLUMES,
          "volume_bytes": size, "needles": needles, "seconds": setup_s})

    svc = codec_service.CodecService(mode="device")
    stages = {st: metrics.EC_SERVICE_STAGE.labels(st)
              for st in ("build", "compute", "readback")}
    jobs_child = metrics.EC_SERVICE_BATCH_JOBS.labels()

    def encode(base: str) -> int:
        n = enc.write_ec_files(base, codec_name="cuda", service=svc)
        enc.write_sorted_file_from_idx(base)
        return n

    lost = (0, 1, 2, 3)
    try:
        burst = service_burst(rs_cuda, gf256, svc, enc.DEFAULT_SLICE)
        before = {st: hist_snapshot(c) for st, c in stages.items()}
        jobs_before = hist_snapshot(jobs_child)
        cache_before = rs_cuda.cache_stats()
        rs_cuda.gf_apply.launches = 0
        rs_cuda.gf_apply_batched.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVICE_VOLUMES) as pool:
            encode_slices = sum(pool.map(encode, bases))
        encode_s = time.perf_counter() - t0
        encode_launches = rs_cuda.gf_apply_batched.launches
        encode_direct = rs_cuda.gf_apply.launches
        mid = {st: hist_snapshot(c) for st, c in stages.items()}
        jobs_mid = hist_snapshot(jobs_child)

        paths = [b + f".ec{i:02d}" for b in bases for i in lost]
        with ThreadPoolExecutor(8) as pool:
            digests = dict(zip(paths, pool.map(sha256_of, paths)))
        for p in paths:
            os.remove(p)
        shard_size = os.path.getsize(bases[0] + ".ec04")
        rs_cuda.gf_apply.launches = 0
        rs_cuda.gf_apply_batched.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVICE_VOLUMES) as pool:
            rebuilt = list(pool.map(
                lambda b: enc.rebuild_ec_files(b, codec_name="cuda",
                                               service=svc), bases))
        rebuild_s = time.perf_counter() - t0
        rebuild_launches = rs_cuda.gf_apply_batched.launches
        rebuild_direct = rs_cuda.gf_apply.launches
        cache_after = rs_cuda.cache_stats()
        after = {st: hist_snapshot(c) for st, c in stages.items()}
        jobs_after = hist_snapshot(jobs_child)
    finally:
        svc.close()
    rebuild_slices = SERVICE_VOLUMES * -(-shard_size // enc.DEFAULT_SLICE)

    if encode_direct or rebuild_direct:
        raise AssertionError("the service route made direct launches")
    if not 0 < encode_launches <= encode_slices:
        raise AssertionError(f"encode: {encode_launches} batched launches "
                             f"for {encode_slices} slices")
    if not 0 < rebuild_launches <= rebuild_slices:
        raise AssertionError(f"rebuild: {rebuild_launches} batched launches "
                             f"for {rebuild_slices} slices")
    if any(r != list(lost) for r in rebuilt):
        raise AssertionError(f"rebuilt {rebuilt}, expected {list(lost)}")
    batches = jobs_after[1] - jobs_before[1]
    if batches != encode_launches + rebuild_launches:
        raise AssertionError(f"{batches} service batches made "
                             f"{encode_launches + rebuild_launches} launches")
    with ThreadPoolExecutor(8) as pool:
        for p, h in zip(paths, pool.map(sha256_of, paths)):
            if h != digests[p]:
                raise AssertionError(f"rebuilt {p} differs by sha256")
    rng = np.random.default_rng(seed + 2)
    checked = 0
    for b in bases:
        check_ecx(b)
        offsets = sorted({int(o) // enc.DEFAULT_SLICE * enc.DEFAULT_SLICE
                          for o in rng.integers(0, shard_size, 4)})
        checked += check_parity(b, rs_cuda, gf256, enc.DEFAULT_SLICE,
                                offsets)

    def stage_s(a, b) -> dict:
        return {st: b[st][0] - a[st][0] for st in stages}
    row = {"phase": "service_concurrent", "volumes": SERVICE_VOLUMES,
           "volume_bytes": size, "setup_s": setup_s,
           "batch_cap_mb": svc.max_batch_bytes >> 20,
           "encode_s": encode_s,
           "encode_GBps": SERVICE_VOLUMES * size / encode_s / 1e9,
           "encode_slices": encode_slices, "encode_launches": encode_launches,
           "rebuild_s": rebuild_s,
           "rebuild_GBps_read": SERVICE_VOLUMES * 10 * shard_size
           / rebuild_s / 1e9,
           "rebuild_slices": rebuild_slices,
           "rebuild_launches": rebuild_launches,
           "batches": batches, "burst": burst,
           "encode_batches": jobs_mid[1] - jobs_before[1],
           "mean_jobs_per_batch": (jobs_after[0] - jobs_before[0])
           / max(batches, 1),
           "encode_stage_s": stage_s(before, mid),
           "rebuild_stage_s": stage_s(mid, after),
           "parity_slices_checked": checked,
           "rebuild_sha256_equal": True, "ecx_sorted": True,
           "probe_s": pr.seconds, "reduced": reduced,
           "compiles_in_flows": cache_after["compiles"]
           - cache_before["compiles"], "cache": cache_after,
           "wall_s": time.perf_counter() - t_phase}
    emit(row)
    return row


def service_burst(rs_cuda, gf256, svc, slice_size: int, jobs: int = 12
                  ) -> dict:
    """`jobs` encode slices of `slice_size` bytes per shard, submitted to
    the idle service in one vectored call: all are queued before its
    scheduler looks, so they share exactly the launches its job and byte
    caps allow, whatever the timing.  Each result is checked against the
    plain version.  -> launches, expected, jobs."""
    m = gf256.rs_parity_matrix(10, 4)
    gen = torch.Generator(device="cuda").manual_seed(7)
    datas = [random_u8((10, slice_size), gen).cpu().numpy()
             for _ in range(jobs)]
    per_batch = max(1, min(svc.max_batch,
                           svc.max_batch_bytes // (10 * slice_size)))
    expected = -(-jobs // per_batch)
    rs_cuda.gf_apply_batched.launches = 0
    futs = svc.submit_parity_many(datas)
    results = [f.result(120) for f in futs]
    launches = rs_cuda.gf_apply_batched.launches
    for data, got in zip(datas, results):
        want = rs_cuda.gf_apply_reference(m, torch.from_numpy(data).cuda())
        if max_abs_err(torch.from_numpy(np.asarray(got)).cuda(), want):
            raise AssertionError("a burst job's parity differs from plain")
    if launches != expected:
        raise AssertionError(f"{jobs} jobs queued at once made {launches} "
                             f"launches, expected {expected}")
    return {"jobs": jobs, "launches": launches, "expected": expected}


def phase_default_route(rs_cuda, enc, codec_service, base: str,
                        size: int) -> dict:
    """One volume alone, in turns (direct, default, default, direct): the
    direct route, and the route `write_ec_files(base)` takes with no
    service and no settings (the shared service from service_for_codec,
    its default batch cap).  Each rebuild is checked by sha256, and each
    leg by the kernel entry it launched."""
    t_phase = time.perf_counter()
    lost = (0, 1, 2, 3)
    shard_size = os.path.getsize(base + ".ec04")
    digests = {i: sha256_of(base + f".ec{i:02d}") for i in lost}
    rates: dict[str, list] = {"direct": [], "default": []}
    launches: dict[str, list] = {"direct": [], "default": []}
    cap_mb = None
    for route in ("direct", "default", "default", "direct"):
        if route == "direct":
            os.environ["SEAWEEDFS_TPU_EC_SERVICE"] = "0"
        try:
            rs_cuda.gf_apply.launches = 0
            rs_cuda.gf_apply_batched.launches = 0
            t0 = time.perf_counter()
            enc.write_ec_files(base, codec_name="cuda")
            encode_s = time.perf_counter() - t0
            for i in lost:
                os.remove(base + f".ec{i:02d}")
            t0 = time.perf_counter()
            enc.rebuild_ec_files(base, codec_name="cuda")
            rebuild_s = time.perf_counter() - t0
            if route == "default":
                cap_mb = codec_service.get_service().max_batch_bytes >> 20
        finally:
            os.environ.pop("SEAWEEDFS_TPU_EC_SERVICE", None)
        direct = rs_cuda.gf_apply.launches
        batched = rs_cuda.gf_apply_batched.launches
        ok = (direct > 0 and batched == 0 if route == "direct"
              else batched > 0 and direct == 0)
        if not ok:
            raise AssertionError(f"{route} route made {direct} direct and "
                                 f"{batched} batched launches")
        for i in lost:
            if sha256_of(base + f".ec{i:02d}") != digests[i]:
                raise AssertionError(f"{route} rebuild: .ec{i:02d} differs")
        rates[route].append([size / encode_s / 1e9,
                             10 * shard_size / rebuild_s / 1e9])
        launches[route].append(direct + batched)
    codec_service.shutdown_all()
    row = {"phase": "default_route", "volume_bytes": size,
           "GBps_encode_rebuild_read": rates, "launches": launches,
           "order": ["direct", "default", "default", "direct"],
           "default_batch_cap_mb": cap_mb,
           "wall_s": time.perf_counter() - t_phase}
    emit(row)
    return row


def time_scrub_kernel(rs_cuda, gf256, gf_network, gen, power: str) -> dict:
    """The scrubber's job on the card: RS(10,4) parity of one 256 KiB
    interval per shard, one entry of gf_apply_batched, as the service
    launches it for each interval."""
    m = gf256.rs_parity_matrix(10, 4)
    data = random_u8((1, 10, 256 * 1024), gen)
    ms = time_ms(lambda: rs_cuda.gf_apply_batched(m, data))
    b2b_ms = time_back_to_back_ms(lambda: rs_cuda.gf_apply_batched(m, data))
    plain_ms = time_ms(lambda: rs_cuda.gf_apply_batched_reference(m, data),
                       reps=10, warmup=1)
    err = max_abs_err(rs_cuda.gf_apply_batched(m, data),
                      rs_cuda.gf_apply_batched_reference(m, data))
    if err:
        raise AssertionError("scrub-shape parity differs from the plain "
                             "version")
    bd = bound(gf_network, m, 256 * 1024)
    row = {"phase": "scrub_kernel_timing", "matrix": "parity",
           "entries": 1, "bytes_per_shard": 256 * 1024, "ms": ms,
           "back_to_back_ms": b2b_ms, **bd,
           "share_of_bound": bd["bound_ms"] / ms,
           "share_of_bound_back_to_back": bd["bound_ms"] / b2b_ms,
           "plain_ms": plain_ms, "max_abs_err": err, "card": power}
    emit(row)
    return row


def time_batched(rs_cuda, gf256, gf_network, gen, power: str) -> dict:
    """gf_apply_batched at the service's batch shape: 4 parity jobs of
    16 MiB per shard in one launch."""
    m = gf256.rs_parity_matrix(10, 4)
    v, b = SERVICE_VOLUMES, 16 * MIB
    data = random_u8((v, 10, b), gen)
    ms = time_ms(lambda: rs_cuda.gf_apply_batched(m, data))
    b2b_ms = time_back_to_back_ms(lambda: rs_cuda.gf_apply_batched(m, data))
    plain_ms = time_ms(lambda: rs_cuda.gf_apply_batched_reference(m, data),
                       reps=5, warmup=1)
    bd = bound(gf_network, m, v * b)  # columns are independent
    row = {"phase": "batched_timing", "entries": v, "bytes_per_shard": b,
           "ms": ms, "back_to_back_ms": b2b_ms, "plain_ms": plain_ms,
           **bd, "share_of_bound": bd["bound_ms"] / ms,
           "share_of_bound_back_to_back": bd["bound_ms"] / b2b_ms,
           "card": power}
    emit(row)
    return row


def volume_size(work: str, want: int, count: int = 1,
                per_volume: float = 2.6) -> tuple[int, list[str]]:
    """The size of each of `count` volumes to encode: `want` bytes, cut to
    what the disk can hold (`per_volume` x the .dat: the .dat, 1.4x for
    shards, and a margin); -> (bytes, cuts made)."""
    free = shutil.disk_usage(work).free
    fits = int(free / per_volume / count) // MIB * MIB
    if fits >= want:
        return want, []
    if fits < min(want, GIB // 4):
        raise RuntimeError(f"only {free} bytes free under {work}")
    return fits, [f"volume {want} -> {fits} bytes: {free} bytes free"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--volume-gib", type=float, default=12.0)
    ap.add_argument("--service-volume-gib", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--store-volume-gib", type=float, default=12.0)
    ap.add_argument("--only-ec-reads", action="store_true",
                    help="phases 1-4b only, no kernels line (a quick check)")
    ap.add_argument("--only-store", action="store_true",
                    help="phases 1-3 and store_lifecycle only, no kernels "
                    "line (a quick check)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from seaweedfs_tpu_torch.ops import (_build, codec_service, gf256,
                                         gf_network, rs_cuda)
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.storage.ec import encoder as enc

    global INT32_OPS_PER_S
    start = time.perf_counter()
    power = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    INT32_OPS_PER_S = int32_ops_per_s()
    t0 = time.perf_counter()
    rs_cuda._lib()  # the host library, nvcc
    host_lib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rs_cuda.build_kernel()  # the RS(10,4) parity kernel, NVRTC
    parity_kernel_s = time.perf_counter() - t0
    print(power, flush=True)
    emit({"phase": "card_and_build", "nvidia_smi": power, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "int32_ops_per_s": INT32_OPS_PER_S,
          "host_lib_nvcc_s": host_lib_s, "parity_kernel_s": parity_kernel_s,
          "nvrtc": _build.nvrtc_path(), "compile_s": compile_seconds(_build),
          "ptxas": [line for log in _build.COMPILE_LOGS.values()
                    for line in log.splitlines() if "Used" in line
                    or "spill" in line],
          "cache": rs_cuda.cache_stats()})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    err = phase_correctness(rs_cuda, gf256, _build, gen)
    timing = phase_timing(rs_cuda, gf256, gf_network, gen, power)

    parity16 = next(r for r in timing if r["matrix"] == "parity"
                    and r["bytes_per_shard"] == 16 * MIB)
    if not args.only_store:
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        os.environ["SEAWEEDFS_TPU_EC_SERVICE"] = "0"  # phase 4: direct route
        try:
            # the .dat, its 14 shards and the 4 the ec_reads phase rebuilds
            size, reduced = volume_size(
                work, int(args.volume_gib * GIB) // MIB * MIB,
                per_volume=2.9)
            e2e, digests = phase_end_to_end(rs_cuda, gf256, _build, enc,
                                            work, size, args.seed, reduced,
                                            parity16["ms"])
            reads = phase_ec_reads(rs_cuda, gf256, gf_network, enc,
                                   codec_service, metrics, work,
                                   os.path.join(work, "1"), digests,
                                   args.seed, gen, power)
        finally:
            del os.environ["SEAWEEDFS_TPU_EC_SERVICE"]
            shutil.rmtree(work, ignore_errors=True)
    if args.only_ec_reads:
        emit({"phase": "done", "wall_s": time.perf_counter() - start,
              "only_ec_reads": True})
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # the .dat and its 14 shards, then the decoded .dat beside them
        size, reduced = volume_size(
            work, int(args.store_volume_gib * GIB) // MIB * MIB,
            per_volume=2.6)
        stored = phase_store_lifecycle(rs_cuda, gf256, enc, codec_service,
                                       metrics, work, size, args.seed,
                                       reduced)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    scrub_kernel = time_scrub_kernel(rs_cuda, gf256, gf_network, gen, power)
    if args.only_store:
        emit({"phase": "done", "wall_s": time.perf_counter() - start,
              "only_store": True})
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0
    store_paths = stored["launches_by_path"]

    batched_err = phase_batched(rs_cuda, gf256, gen)
    phase_kernel_sweep(rs_cuda, gf256, gen, power)
    batched = time_batched(rs_cuda, gf256, gf_network, gen, power)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        size, reduced = volume_size(
            work, int(args.service_volume_gib * GIB) // MIB * MIB,
            SERVICE_VOLUMES)
        svc = phase_service(rs_cuda, gf256, enc, codec_service, metrics, work,
                            size, args.seed, reduced)
        phase_default_route(rs_cuda, enc, codec_service,
                            os.path.join(work, "1"), size)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    source = "seaweedfs_tpu_torch/ops/csrc/gf_bitslice.cu"
    emit({"kernels": [{
        "name": "gf_matmul", "route": "cuda", "source": source,
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:44",
        "launches": e2e["encode_launches"] + e2e["rebuild_launches"]
        + reads["read_launches"] + reads["rebuild_launches"]
        + sum(store_paths["gf_matmul"].values()),
        "launches_by_path": {
            "encode": e2e["encode_launches"],
            "rebuild": e2e["rebuild_launches"],
            "ec_reads": reads["read_launches"],
            "remote_rebuild": reads["rebuild_launches"],
            **store_paths["gf_matmul"]},
        "max_abs_err": err, "ms": parity16["ms"],
        "back_to_back_ms": parity16["back_to_back_ms"],
        "plain_ms": parity16["plain_ms"], "bound_ms": parity16["bound_ms"],
        "bound_by": parity16["bound_by"], "alu_ms": parity16["alu_ms"],
        "degraded_read_shapes": [
            {k: r[k] for k in ("matrix", "bytes_per_shard", "ms",
                               "back_to_back_ms", "plain_ms", "bound_ms",
                               "bound_by", "alu_ms")}
            for r in reads["kernel_rows"]],
        "library_ms": None}, {
        "name": "gf_matmul_batched", "route": "cuda", "source": source,
        "replaces": "bench.py:104",
        "launches": svc["encode_launches"] + svc["rebuild_launches"]
        + reads["rebuild_batched_launches"]
        + sum(store_paths["gf_matmul_batched"].values()),
        "launches_by_path": {
            "service_encode": svc["encode_launches"],
            "service_rebuild": svc["rebuild_launches"],
            "remote_rebuild": reads["rebuild_batched_launches"],
            **store_paths["gf_matmul_batched"]},
        "max_abs_err": batched_err, "ms": batched["ms"],
        "back_to_back_ms": batched["back_to_back_ms"],
        "plain_ms": batched["plain_ms"], "bound_ms": batched["bound_ms"],
        "bound_by": batched["bound_by"], "alu_ms": batched["alu_ms"],
        "scrub_shape": {k: scrub_kernel[k] for k in (
            "entries", "bytes_per_shard", "ms", "back_to_back_ms",
            "plain_ms", "bound_ms", "bound_by", "alu_ms")},
        "library_ms": None}]})
    emit({"phase": "done", "wall_s": time.perf_counter() - start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
