"""Compare checkouts of the PyTorch/CUDA port on one NVIDIA card, run by run.

    python3 chip_ab.py --tree parent=DIR --tree change=DIR \\
        [--order parent,change,change,parent] [--flows direct,service] \\
        [--volume-gib 12] [--service-volume-gib 3] [--seed 0] [--out FILE]

Each run is a process of its own (this script with --run) that imports one
checkout's `seaweedfs_tpu_torch`, builds its GF(2^8) kernel, and measures,
on volumes made once before the first run and shared by every run:

  kernel   gf_apply on the RS(10,4) parity matrix and on the 4-row rebuild
           plan at 16 MiB per shard, and gf_apply_batched on 4 parity jobs
           of 16 MiB, by two measures: one launch between two CUDA events
           (median of 20; the host's launch time included) and 20 launches
           back to back between two events (median of 5 such windows);
  direct   chip_smoke.py phase 4's flows on one volume (12 GiB): the encode
           with its .ecx on the direct route, then the rebuild of
           .ec00-.ec03, twice, each checked by sha256;
  service  chip_smoke.py phase 7's flows on 4 volumes (3 GiB each): 4
           encodes, then 4 rebuilds of .ec00-.ec03, from 4 threads through
           one device-mode CodecService with its defaults, checked by
           sha256, with launches, jobs per batch and the service's stage
           seconds;
  sass     each device-code file the checkout built (cubins, shared
           libraries) through cuobjdump: machine instructions and bytes,
           registers, stack and local (spill) bytes of each function.

Each encode writes new shard files, as `ec.encode` does: an earlier run's
.ec00-.ec13 and .ecx are deleted first (rewriting them in place ran at
about half the rate).  Dirty pages are written back (os.sync) before each
timed flow, so no run pays for an earlier run's writes.  --flows picks the flows each run
makes (kernel and sass always run); only their volumes are made.  At full
size each flow holds ~29 GiB on disk (volumes and shards), so a machine
whose disk takes less than both at once runs one flow per invocation.
Both checkouts must offer the entry points these flows call, as the port
has since its second slice.
Each run prints one JSON line, also appended to --out; the last line holds
each checkout's medians.  Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MIB = 1 << 20
GIB = 1 << 30
SERVICE_VOLUMES = 4
HERE = os.path.dirname(os.path.abspath(__file__))
LOST = (0, 1, 2, 3)


def sha256_all(paths: list[str]) -> list[str]:
    import chip_smoke
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(chip_smoke.sha256_of, paths))


def time_both(fn) -> dict:
    """{"ms": one launch between events, "back_to_back_ms": ...}, with the
    helpers of chip_smoke.py, which define the two measures."""
    import chip_smoke
    return {"ms": chip_smoke.time_ms(fn),
            "back_to_back_ms": chip_smoke.time_back_to_back_ms(fn)}


def run_kernel(torch, rs_cuda, gf256) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    full = gf256.rs_matrix(10, 14)
    plan = gf256.decode_plan_for(full, 10, [i for i in range(14)
                                            if i not in LOST], LOST)
    parity = gf256.rs_parity_matrix(10, 4)
    b = 16 * MIB
    data = torch.randint(0, 256, (SERVICE_VOLUMES, 10, b), dtype=torch.uint8,
                         device="cuda", generator=gen)
    out = {}
    for name, m in (("parity", parity), ("rebuild_plan_4", plan)):
        got = rs_cuda.gf_apply(m, data[0])
        if not torch.equal(got, rs_cuda.gf_apply_reference(m, data[0])):
            raise AssertionError(f"{name}: kernel != plain version")
        out[name] = time_both(lambda m=m: rs_cuda.gf_apply(m, data[0]))
    out["batched_4x16MiB"] = time_both(
        lambda: rs_cuda.gf_apply_batched(parity, data))
    return out


def remove_shards(base: str) -> None:
    for ext in [f".ec{i:02d}" for i in range(14)] + [".ecx"]:
        if os.path.exists(base + ext):
            os.remove(base + ext)


def run_direct(enc, rs_cuda, base: str) -> dict:
    os.environ["SEAWEEDFS_TPU_EC_SERVICE"] = "0"
    try:
        remove_shards(base)
        os.sync()
        rs_cuda.gf_apply.launches = 0
        t0 = time.perf_counter()
        slices = enc.write_ec_files(base, codec_name="cuda")
        enc.write_sorted_file_from_idx(base)
        encode_s = time.perf_counter() - t0
        encode_launches = rs_cuda.gf_apply.launches
        paths = [base + f".ec{i:02d}" for i in LOST]
        digests = sha256_all(paths)
        rebuild_s = []
        for _ in range(2):
            for p in paths:
                os.remove(p)
            os.sync()
            rs_cuda.gf_apply.launches = 0
            t0 = time.perf_counter()
            enc.rebuild_ec_files(base, codec_name="cuda")
            rebuild_s.append(time.perf_counter() - t0)
            rebuild_launches = rs_cuda.gf_apply.launches
            if sha256_all(paths) != digests:
                raise AssertionError("direct rebuild differs by sha256")
    finally:
        del os.environ["SEAWEEDFS_TPU_EC_SERVICE"]
    size = os.path.getsize(base + ".dat")
    read = 10 * os.path.getsize(base + ".ec04")
    return {"encode_s": encode_s, "encode_GBps": size / encode_s / 1e9,
            "rebuild_s": rebuild_s[0],
            "rebuild_GBps_read": read / rebuild_s[0] / 1e9,
            "rebuild_again_s": rebuild_s[1],
            "rebuild_again_GBps_read": read / rebuild_s[1] / 1e9,
            "slices": slices, "encode_launches": encode_launches,
            "rebuild_launches": rebuild_launches}


def run_service(enc, rs_cuda, codec_service, metrics, bases) -> dict:
    svc = codec_service.CodecService(mode="device")
    stages = {st: metrics.EC_SERVICE_STAGE.labels(st)
              for st in ("build", "compute", "readback")}
    jobs = metrics.EC_SERVICE_BATCH_JOBS.labels()

    def snap():
        return ({st: c.total for st, c in stages.items()},
                (jobs.total, jobs.count))

    def encode(base: str) -> int:
        n = enc.write_ec_files(base, codec_name="cuda", service=svc)
        enc.write_sorted_file_from_idx(base)
        return n

    try:
        for base in bases:
            remove_shards(base)
        os.sync()
        s0 = snap()
        rs_cuda.gf_apply_batched.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVICE_VOLUMES) as pool:
            slices = sum(pool.map(encode, bases))
        encode_s = time.perf_counter() - t0
        encode_launches = rs_cuda.gf_apply_batched.launches
        s1 = snap()
        paths = [b + f".ec{i:02d}" for b in bases for i in LOST]
        digests = sha256_all(paths)
        for p in paths:
            os.remove(p)
        os.sync()
        s2 = snap()
        rs_cuda.gf_apply_batched.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVICE_VOLUMES) as pool:
            list(pool.map(lambda b: enc.rebuild_ec_files(
                b, codec_name="cuda", service=svc), bases))
        rebuild_s = time.perf_counter() - t0
        rebuild_launches = rs_cuda.gf_apply_batched.launches
        s3 = snap()
    finally:
        svc.close()
    if sha256_all(paths) != digests:
        raise AssertionError("service rebuild differs by sha256")
    size = sum(os.path.getsize(b + ".dat") for b in bases)
    shard = os.path.getsize(bases[0] + ".ec04")

    def delta(a, b) -> dict:
        n = b[1][1] - a[1][1]
        return {"stage_s": {st: b[0][st] - a[0][st] for st in stages},
                "batches": n,
                "jobs_per_batch": (b[1][0] - a[1][0]) / max(n, 1)}
    return {"encode_s": encode_s, "encode_GBps": size / encode_s / 1e9,
            "rebuild_s": rebuild_s,
            "rebuild_GBps_read": len(bases) * 10 * shard / rebuild_s / 1e9,
            "encode_slices": slices, "encode_launches": encode_launches,
            "rebuild_launches": rebuild_launches,
            "encode": delta(s0, s1), "rebuild": delta(s2, s3)}


def cuobjdump(path: str) -> dict:
    """Per function: SASS instructions and bytes (16 per instruction on
    sm_90), and REG, STACK and LOCAL from -res-usage."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump") or tool
    funcs: dict[str, dict] = {}
    try:
        sass = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, timeout=120)
        res = subprocess.run([tool, "-res-usage", path], capture_output=True,
                             text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"error": str(e)}
    if sass.returncode != 0:
        return {"error": (sass.stdout + sass.stderr).strip()[-300:]}
    name = None
    for line in sass.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = {"instructions": 0}
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            funcs[name]["instructions"] += 1
    for f in funcs.values():
        f["sass_bytes"] = 16 * f["instructions"]
    name = None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", line)
        if m and name:
            funcs.setdefault(name, {}).update(zip(
                ("registers", "stack", "shared", "local"),
                map(int, m.groups())))
    return funcs


def run_one(label: str, tree: str, work: str, flows: list[str]) -> dict:
    """One run, in its own process: the checkout at `tree`."""
    import chip_smoke  # this script's neighbour, before the checkout's
    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != HERE:
        raise RuntimeError(f"imported {chip_smoke.__file__}")
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import seaweedfs_tpu_torch
    pkg = os.path.dirname(os.path.abspath(seaweedfs_tpu_torch.__file__))
    if not pkg.startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {pkg}, not the checkout at {tree}")
    from seaweedfs_tpu_torch.ops import codec_service, gf256, rs_cuda
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.storage.ec import encoder as enc

    row: dict = {"label": label, "tree": tree}
    t0 = time.perf_counter()
    rs_cuda.gf_apply(gf256.rs_parity_matrix(10, 4),
                     torch.zeros((10, 64), dtype=torch.uint8, device="cuda"))
    torch.cuda.synchronize()
    row["build_s"] = time.perf_counter() - t0
    row["kernel"] = run_kernel(torch, rs_cuda, gf256)
    if "direct" in flows:
        row["direct"] = run_direct(enc, rs_cuda,
                                   os.path.join(work, "d", "1"))
    if "service" in flows:
        row["service"] = run_service(
            enc, rs_cuda, codec_service, metrics,
            [os.path.join(work, "s", str(i + 1))
             for i in range(SERVICE_VOLUMES)])
    build = os.path.join(pkg, "_build")
    row["sass"] = {f: cuobjdump(os.path.join(build, f))
                   for f in sorted(os.listdir(build))
                   if f.endswith((".cubin", ".so"))}
    return row


def make_volumes(work: str, args, flows: list[str]) -> list[str]:
    import chip_smoke
    reduced: list[str] = []
    if "direct" in flows:
        os.makedirs(os.path.join(work, "d"))
        size, cuts = chip_smoke.volume_size(
            work, int(args.volume_gib * GIB) // MIB * MIB)
        chip_smoke.make_volume(os.path.join(work, "d", "1"), size, args.seed)
        reduced += cuts
    if "service" in flows:
        os.makedirs(os.path.join(work, "s"))
        size, cuts = chip_smoke.volume_size(
            work, int(args.service_volume_gib * GIB) // MIB * MIB,
            SERVICE_VOLUMES)
        for i in range(SERVICE_VOLUMES):
            chip_smoke.make_volume(os.path.join(work, "s", str(i + 1)), size,
                                   args.seed + 10 + i)
        reduced += cuts
    os.sync()
    return reduced


PATHS = (("kernel", "parity", "ms"), ("kernel", "parity", "back_to_back_ms"),
         ("kernel", "rebuild_plan_4", "ms"),
         ("kernel", "rebuild_plan_4", "back_to_back_ms"),
         ("kernel", "batched_4x16MiB", "ms"),
         ("kernel", "batched_4x16MiB", "back_to_back_ms"),
         ("direct", "encode_GBps"), ("direct", "rebuild_GBps_read"),
         ("direct", "rebuild_again_GBps_read"),
         ("service", "encode_GBps"), ("service", "rebuild_GBps_read"),
         ("service", "encode_launches"), ("service", "rebuild_launches"))


def summary(rows: list[dict]) -> dict:
    out: dict = {}
    for row in rows:
        if "error" in row:
            continue
        per = out.setdefault(row["label"], {"runs": 0})
        per["runs"] += 1
        for path in PATHS:
            v = row
            for k in path:
                v = v.get(k) if isinstance(v, dict) else None
            if v is not None:
                per.setdefault(".".join(path), []).append(v)
    for per in out.values():
        for k, vals in list(per.items()):
            if isinstance(vals, list):
                per[k] = {"median": float(np.median(vals)),
                          "min": min(vals), "max": max(vals)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=DIR, a checkout holding seaweedfs_tpu_torch")
    ap.add_argument("--order", default=None,
                    help="comma-separated labels, one run each")
    ap.add_argument("--flows", default="direct,service",
                    help="comma-separated: direct, service")
    ap.add_argument("--volume-gib", type=float, default=12.0)
    ap.add_argument("--service-volume-gib", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run", nargs=3, metavar=("LABEL", "DIR", "WORK"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    flows = [f for f in args.flows.split(",") if f]
    if set(flows) - {"direct", "service"}:
        ap.error(f"unknown flows in {args.flows!r}")
    if args.run:
        print(json.dumps(run_one(*args.run, flows)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA card", file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    if not trees or any(label not in trees for label in order):
        ap.error("every label of --order needs a --tree LABEL=DIR")
    work = tempfile.mkdtemp(prefix="chip_ab_")
    rows: list[dict] = []
    try:
        t0 = time.perf_counter()
        reduced = make_volumes(work, args, flows)
        print(json.dumps({"setup_s": time.perf_counter() - t0,
                          "reduced": reduced}), flush=True)
        torch.cuda.empty_cache()
        for label in order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--run", label,
                 os.path.abspath(trees[label]), work, "--flows", args.flows],
                capture_output=True, text=True, timeout=900,
                cwd=os.path.abspath(trees[label]))
            lines = proc.stdout.strip().splitlines()
            if proc.returncode == 0 and lines:
                row = json.loads(lines[-1])
            else:
                row = {"label": label, "error": proc.returncode,
                       "stderr": proc.stderr[-2000:]}
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0 if all("error" not in r for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
