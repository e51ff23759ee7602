"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--volume-gib 10.5] [--service-volume-gib 1]
                          [--store-volume-gib 3] [--seed 0]
                          [--cluster-volume-gib 3] [--cluster-codec cuda]
                          [--maintenance-volume-gib 0.5]
                          [--tier-volume-gib 1] [--quorum-volume-gib 1]
                          [--only-ec-reads | --only-store |
                           --only-volume-server | --only-cluster |
                           --only-maintenance | --only-mesh | --only-tier |
                           --only-quorum]

The main path is what SeaweedFS operators run to seal, protect and serve
volumes: `ec.encode`, then `ec.rebuild` and reads of needles from the EC
volume, the whole lifecycle of a volume through the store that owns it
(write, encode, serve, rebuild, scrub, `ec.decode`), and the same
lifecycle driven over gRPC through the volume server's rpcs, the
system as operators start it: a master, volume servers and the admin
shell, each a `python -m seaweedfs_tpu_torch` process, and the master's
maintenance plane doing the same with no operator: sealing and encoding
volumes by policy, rebuilding a dead server's shards on the survivors,
and moving sealed `.dat` files to an S3 remote tier, and a raft quorum
of masters failing over mid-encode while its SLO engine, canary and
flight recorder judge the cluster.  A full volume
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
`gf_matmul_batched`, also the port of bench.py:104's sweep kernel).  The
mesh phase adds the JAX package's other two device programs, the XOR
network of doubling chains (`gf_xor`, csrc/gf_xor.cu) and the
bit-plane route as one kernel on the int8 tensor cores
(`gf_bitplane_mma`, csrc/gf_bitplane.cu), and parallel/ over a mesh of
the card.

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
     1 B to 256 KiB, the port's CRC32-C, a real superblock; 10.5 GiB by
     default: SeaweedFS's default 30 GB volume limit cut so that one 1
     GB-block row and 0.5 GiB of 1 MB-block rows still run, and the whole
     script within its time limit; the time to make it on its own line) encoded with write_ec_files +
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
     volume of --store-volume-gib (3 by default: 1 MB-block rows only,
     phase 4 keeps the 1 GB-block row)
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
  4d. volume_server, on 4c's directory and its decoded volume: two port
     VolumeServers on their default `cuda` codec, A over that directory
     and B over a fresh one, heartbeating to MiniMaster (a master servicer
     from the port's own rpc declarations that records heartbeats and
     answers LookupEcVolume from them), every step an rpc: (1)
     VolumeMarkReadonly and VolumeEcShardsGenerate (.ecx = key-sorted
     .idx, sampled slices' parity = the plain version's on the card);
     (2) VolumeEcShardsMount of all 14, seen by the master with
     ec_index_bits 0x3fff, then VolumeDelete of the .dat; (3) the
     intervals of 4096 seeded needles read by VolumeEcShardRead from 16
     client threads, equal by sha256 to the .dat records; (4) .ec00-.ec03
     unmounted and deleted, the needles read by VolumeNeedleStatus (A
     decodes each lost interval on the card; size, cookie and CRC equal
     the .dat record's); (5) VolumeEcShardsRebuild of the 4, equal by
     sha256; (6) .ec00-.ec04 copied to B (VolumeEcShardsCopy) and
     mounted there, .ec00-.ec04 and .ec10-.ec13 dropped on A, and
     .ec10-.ec13 rebuilt on A from its 5 shards and B's partial sums
     (VolumeEcShardPartialApply; equal by sha256, 4 shards' bytes in
     against 5 for a full fetch, no fallback); (6b) the same 4 rebuilt
     again with B's VolumeEcShardPartialApply failing (fault point
     ec.partial.apply): one fallback to full fetches from B, whose share
     of the decode runs on A's codec (the card), not once on the host
     codec, equal by sha256; then .ec00-.ec04 copied back; (7) VolumeScrub clean, then one flipped byte of .ec11 found
     exactly once, in its 256 KiB interval; (8) VolumeEcShardsToVolume,
     the .dat equal by sha256.  Each step prints its rate (GB/s, or
     reads/s with p50/p99) beside the card's name and power limit, and
     its launches, counts zeroed just before it and read just after; on
     the card the phase must launch both kernels;
  4e. http_plane, on 4d's two servers (A also with a metrics port and a
     TCP port, both requiring write JWTs), each step at the point of 4d
     where the volume is in the state it needs, each on its own line with
     its launches: (h1) after step 3, the 4096 needles by HTTP GET from 16
     threads on keep-alive connections, each body and Etag equal to its
     .dat record (no launch), then /debug/canary/ec with the probed
     needle's shard dropped (its decode's launches, exactly); (h2) after
     step 4, the same GETs with .ec00-.ec03 lost and the caches cleared (a
     gf_matmul launch per degraded interval) and 64 HEADs; (h3) after step
     8, the GETs on the decoded volume, the sendfile counter moving by the
     bytes served, then 64 Range GETs on the fallback path; (h4) volume 2
     (replication 001) on A and B, 512 MiB of seeded needles (256 JSON-lines
     ones, then 1 B..256 KiB) POSTed to A by 16 threads with write JWTs and
     fanned out to B, a POST without a token refused 401, every needle read
     back equal from B, 16 DELETEs at A then 404 on both; (h5) 64 needles
     put, got and deleted over A's TCP port; (h6) Query over the 256
     JSON-lines needles, equal to a plain filter; (h7) /metrics on A's
     metrics port lists the HTTP families, /debug/traces holds GET spans;
  4f. cluster, in a fresh directory after 4c-4e's is removed: a master
     (`-volumeSizeLimitMB 30000 -maintenanceInterval 0`, its dead-node
     mass repair switched off by SEAWEEDFS_TPU_MASS_REPAIR=0: this phase's
     subject is the shell's rebuild) and three volume processes (`-max
     40`, no -ec.codec: their default `cuda`; A alone in rack1 holding a
     sealed volume of --cluster-volume-gib, 3 by default, made before it
     starts; B and C in rack0), started in that order; (1)
     256 MiB of seeded needles by /dir/assign?replication=001, POSTed by
     16 threads and read back through /dir/lookup; (2) `shell -c
     "ec.encode -volumeId=1"` as a process: 14 shards over the 3 nodes
     equal to balanced_ec_distribution's plan, every slice's parity equal
     to the plain version, the servers' kernel launches and codec ops read
     from their /metrics (the host codec's apply_rows unmoved); (3) 4096
     GETs through the master's lookup from this process, bodies equal to
     the .dat records; (4) C SIGKILLed (its shards hashed first), the
     master drops it, the same GETs degraded; (5) `ec.rebuild -force`: C's
     shards back on A or B, equal by sha256; (6) `ec.decode -volumeId=1`:
     the .dat equal by sha256 and served; (7) SIGTERM: each process exits
     0 within 30 s with no traceback after the signal.  Counts are read
     just before and just after each step;
  4g. maintenance, in a fresh directory after 4f's is removed: a master
     (`-volumeSizeLimitMB` the volumes' size, `-lifecycleInterval 6`,
     `-lifecyclePolicy` {"*": {"ec_cooldown_seconds": 5}}, the
     controller's defaults otherwise) and four volume processes (`-max
     40`, their default `cuda`; A and B in rack0, C and D in rack1, D
     registered first), each holding two volumes of
     --maintenance-volume-gib (0.5 by default) made before it starts, the
     second last written MAINT_WAVE_GAP_S after the first; no operator
     command: (1) the controller seals and EC-encodes all 8 volumes in two
     waves, one volume of each node at a time (14 shards each over the 4
     nodes, every slice's parity equal to the plain version, sources
     dropped, batched launches on every generating node, the host codec's
     apply_rows on none; the second wave stacks 5 shards of a volume on A
     and B, printed); (2) D
     SIGKILLed: the seconds until the master drops it, until `shell -c
     volume.repair` lists every affected volume planned, and until every
     volume has 14 shards again (the time to recover); (3) 4096 GETs
     across the 8 volumes from the moment D is dropped, while the repair
     runs, each body equal to its record; (4) D's shards rebuilt equal by
     sha256 on the survivors' cards (batched launches on every rebuild
     target), the repair's rate, partial-sum bytes in against a full
     fetch, the master's seaweedfs_repair_batch_* counters,
     `volume.lifecycle` and `volume.repair` showing every job done; (5)
     SIGTERM: clean exits;
  4h. tier, in a fresh directory after 4g's is removed: a local
     S3-compatible endpoint (a child process running serve_s3_endpoint,
     disk-backed, SigV4 checked by its own hashlib/hmac code, 403 on a
     mismatch), a master (`-volumeSizeLimitMB` the volumes' size,
     `-lifecycleInterval 3`, `-lifecyclePolicy` {"tier":
     {"ec_cooldown_seconds": 5, "tier_backend": "s3.tier",
     "tier_idle_seconds": 5}}) and two volume processes (`-offset.5bytes
     -tierBackends <json> -ec.codec=cuda`), A and B, each holding one
     volume of collection `tier` of --tier-volume-gib (1 by default) with
     a 17-byte-entry .idx, made before it starts; (a) the controller seals
     both, encodes each on its node's card keeping the source (batched
     launches on each node) and tiers its .dat (multipart uploads of 8
     MiB parts); (b) each object equals its .dat by sha256, the local .dat
     is gone, the .vif names the object, .ec00-.ec13 pass the parity
     check, every .ecx is 17 bytes a needle; (c) 2048 GETs from 16
     threads a volume from the remote tier (ranged GETs at the endpoint),
     rate and p50/p99; (d) 256 needles GET from the node holding only EC
     shards of the volume (the 17-byte .ecx searched); (e) `shell -c
     volume.tier.download` and `volume.tier.upload` of volume 1, equal by
     sha256, each move's GB/s; (f) a wrong secret answers 403, a move to
     an unregistered backend fails FAILED_PRECONDITION and leaves the .dat
     as it was; (g) SIGTERM: clean exits, the endpoint's too.  The 5-byte
     offsets live in the volume processes only: this script's own process
     stays at 4 bytes;
  4i. quorum, in a fresh directory after 4h's is removed: SeaweedFS's
     documented HA layout, three `master` processes naming each other in
     `-peers` (each its own `-raftDir` and `-lifecycleDir`, 4g's policy,
     `-lifecycleInterval 3 -sloInterval 1 -canaryInterval 1 -debugDir`,
     burn windows at tests/test_slo_cluster.py's scale 0.005, every page
     captured) and four `volume` processes (`-mserver` naming all three,
     their default `cuda`, SEAWEEDFS_TPU_EC_PARTIAL=0: a degraded interval
     decodes on the card), A and B in rack0, C and D in rack1, each
     holding one sealed volume of --quorum-volume-gib (1 by default; its
     first needle spans every data shard's first 1 MiB block) and one
     empty writable volume: (0) the election and the registrations; (1)
     256 seeded writes through a follower's /dir/assign (307 to the
     leader), fids unique, read back; (2) the leader SIGKILLed as soon as
     an ec_encode job runs: the seconds to a new leader, to a warmed one
     and to every volume encoded with its source dropped, each job done
     once in the new leader's journal (a resumed one marked), the
     follower's job set equal, parity equal to the plain version,
     batched launches on every generating node and the host codec on
     none, volume ids grown afterwards new; (3) ec_degraded probes ok on
     every node with the card's launches moving (read through the
     leader's federated /cluster/metrics), the probe's p50, then a byte
     of parity shard 10 flipped: the availability page in /cluster/alerts
     and `shell -c cluster.alerts`, a bundle captured on its own and
     listed by `shell -c cluster.debug`, the byte restored and the page
     resolved; (4) the killed master restarted on its -raftDir, a
     caught-up follower listing the same done jobs; (5) D SIGKILLed
     (another node holding at most 4 shards of every volume if the
     encodes stacked 5 on D): the repair on the survivors' cards, equal
     by sha256, the time to recover as in 4g, 2048 GETs during it; (6)
     one degraded GET of the lead needle traced by /cluster/traces, and
     /cluster/hot listing 16 keys read 8 times each; (7) SIGTERM;
  5. batched_vs_plain: gf_apply_batched for V in {1, 3, 16} entries at
     ragged, unaligned and 16 MiB widths, more than 65535 entries, and
     gf_sweep over overlapping windows, byte-equal to the plain versions;
  6. kernel_sweep: bench.py:104's leg, K parity sweeps over windows
     shifted by 128 KiB in one gf_sweep launch per stage, timed beside
     gf_apply at the same width and the memory bound;
  7. service_concurrent: 4 volumes (1 GiB each) encoded from 4 threads
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
  9. mesh: parallel/ on the card and the JAX package's other two device
     programs.  (a) gf_xor (csrc/gf_xor.cu, one entry and batched) and
     gf_bitplane_mma (csrc/gf_bitplane.cu) against their plain versions
     for the parity matrix and 20 seeded decode plans of 1-4 lost shards
     at 1, 7, 4099 and 16 MiB per shard, and both for seeded (R, S)
     matrices of R in {1, 2, 3, 4, 10, 14}, S in {1, 2, 5, 10, 14, 16}
     at widths 1-4099 on rows 16-byte aligned, 4 and 1 bytes past (gf_xor
     on both of its kernels), with no compile per matrix;
     (b) each timed at 16 MiB per shard, one launch and back to back,
     beside its bound and its plain version (gf_xor and gf_bitplane_mma
     also on the mesh rebuild's (4, 10) plan, gf_bitplane_mma on the
     (4, 5) partial of a dp = 2
     mesh; gf_xor's two kernels on 20 seeded (R, S) shapes, the times
     behind its choice of side), with torch._int_mm of the same bit-plane product alone as a
     yardstick and gf_bitslice on the same data; (c) BASELINE config 4 on the
     1x1 mesh of the card: 64 seeded volumes of 32-96 MiB (~4 GiB), each
     encoded alone on `cuda`, then batch_generate_ec_files over all 64
     (every shard file equal by sha256), one volume's .ec00-.ec03 rebuilt
     by mesh_rebuild_ec_files (equal), and that volume encoded on
     `cuda_xor` and rebuilt on `cuda_bitplane` (equal); (d) the same
     flows on a virtual 2x4 mesh of the one card, 16 volumes (~256 MiB);
     (e) dryrun_multidevice(8); (f) a burst of encode and decode jobs
     through a device-mode CodecService on make_mesh() (one launch per
     batch) and on the virtual mesh (one per entry and batch), equal to
     the `cpu` codec.  Launch counts are zeroed just before each flow and
     read just after;
  10. the {"kernels": [...]} line, then {"ok": true, "device": ...} last.

`--only-ec-reads` runs phases 1, 4 and 4b alone, at `--volume-gib` (a
quick check: `--only-ec-reads --volume-gib 0.5`), and prints no kernels
line; `--only-store` runs phases 1-3 and 4c alone, at
`--store-volume-gib` (a quick check: `--only-store --store-volume-gib
0.5`), and prints no kernels line; `--only-volume-server` runs phases 1-2
and 4d with 4e alone, on a volume of `--store-volume-gib` written for it (a
quick check: `--only-volume-server --store-volume-gib 0.5`), and prints
no kernels line; `--only-cluster` runs phases 1-2 and 4f alone (a quick
check: `--only-cluster --cluster-volume-gib 0.5`), and prints no kernels
line; `--only-maintenance` runs phases 1-2 and 4g alone (a quick check:
`--only-maintenance --maintenance-volume-gib 0.25`), and prints no
kernels line; `--only-mesh` runs phases 1-2 and the mesh phase alone, and prints
no kernels line; `--only-tier` runs phases 1-2 and 4h alone (a quick
check: `--only-tier --tier-volume-gib 0.25`), and prints no kernels line;
`--only-quorum` runs phases 1-2 and 4i alone (a quick check:
`--only-quorum --quorum-volume-gib 0.25`), and prints no kernels line;
`--cluster-codec` passes -ec.codec to 4f's, 4g's, 4h's and 4i's volume
processes (a CPU rehearsal asks for `torch_cpu`).  Exits non-zero, printing no result, without a CUDA card
or without the package beside this script.  Data comes from --seed;
nothing is downloaded.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import mmap
import os
import shutil
import signal
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


def _timed_build(_build, name: str) -> float:
    """Seconds of one nvcc build of csrc/<name>.cu (0 when built)."""
    t0 = time.perf_counter()
    _build.build(name)
    return time.perf_counter() - t0


def ptxas_report(_build, name: str) -> list[str]:
    """ptxas's registers, shared memory and spills for csrc/<name>.cu: the
    library's nvcc build again with -Xptxas -v, into a scratch file."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"),
             os.path.join(_build.CSRC_DIR, name + ".cu")],
            capture_output=True, text=True, check=True)
    out, entry = [], ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line \
                or "Function properties for" in line:
            entry = (line.split("'")[1] if "'" in line
                     else line.rsplit(" ", 1)[-1])
        elif "Used" in line or "spill" in line:
            out.append(f"{entry}: {line.strip()}" if entry else line.strip())
    return out


def compile_seconds(_build) -> dict:
    """Each NVRTC compile of this process: seconds by cache key."""
    return {key[:16]: s for key, s in _build.COMPILE_SECONDS.items()}


def random_u8(shape, gen) -> torch.Tensor:
    """Seeded random bytes on the generator's device (the card)."""
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=gen.device,
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


def idx_dtype(offset_bytes: int = 4) -> np.dtype:
    """An .idx / .ecx entry: key, offset / 8 and size, big-endian; with
    5-byte offsets the offset's high byte follows its 4 lower bytes
    (offset_5bytes.go), 17 bytes an entry."""
    if offset_bytes == 4:
        return np.dtype([("k", ">u8"), ("o", ">u4"), ("s", ">u4")])
    return np.dtype([("k", ">u8"), ("o", ">u4"), ("h", "u1"), ("s", ">u4")])


def idx_offsets(entries: np.ndarray) -> np.ndarray:
    """The entries' actual byte offsets."""
    stored = entries["o"].astype(np.int64)
    if "h" in entries.dtype.names:
        stored |= entries["h"].astype(np.int64) << 32
    return stored * 8


def make_volume(base: str, size: int, seed: int, device: str = "cuda",
                offset_bytes: int = 4, lead_data: int = 0) -> int:
    """A sealed volume of real needle records, `size` bytes of `<base>.dat`:
    the port's superblock (version 3), then version-3 needles of seeded
    random data (1 B..256 KiB, drawn on `device`) with the port's native
    CRC32-C, filling the volume exactly; and one .idx entry per needle
    (`offset_bytes` 4 or 5: 16 or 17 bytes each), keys in shuffled order
    so the .ecx sort does real work.  `lead_data` > 0: the first needle
    (right after the superblock) carries that many bytes of data and the
    smallest key, so it is the volume's first live needle.  -> needle
    count."""
    import struct

    from seaweedfs_tpu_torch.ops import crc32c
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    sb = SuperBlock().to_bytes()
    lead = [lead_data] if lead_data else []
    lens = np.concatenate([np.asarray(lead, np.int64), _plan_needles(
        size - len(sb) - int(_record_size(lead_data) if lead else 0), rng)])
    recs = _record_size(lens)
    offsets = len(sb) + np.concatenate([[0], np.cumsum(recs)[:-1]])
    if offsets[-1] + recs[-1] != size or lens.min() < 1 \
            or lens[len(lead):].max() > NEEDLE_MAX_DATA:
        raise AssertionError("needle plan does not fill the volume")
    n = len(lens)
    keys = rng.permutation(np.arange(1, n + 1, dtype=np.uint64)
                           * np.uint64(7919))
    if lead:
        first = int(np.argmin(keys))
        keys[[0, first]] = keys[[first, 0]]
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
    entries = np.empty(n, dtype=idx_dtype(offset_bytes))
    stored = offsets.astype(np.int64) // 8
    entries["k"], entries["s"] = keys, lens + 5
    entries["o"] = stored & 0xFFFFFFFF
    if offset_bytes == 5:
        entries["h"] = stored >> 32
    entries.tofile(base + ".idx")
    return n


def check_ecx(base: str, offset_bytes: int = 4,
              idx_base: "str | None" = None) -> int:
    """The .ecx is the key-sorted .idx (of `idx_base`, default `base`),
    entry for entry; -> entries."""
    raw = np.fromfile((idx_base or base) + ".idx",
                      dtype=idx_dtype(offset_bytes))
    ecx = np.fromfile(base + ".ecx", dtype=raw.dtype)
    if not np.array_equal(ecx, np.sort(raw, order="k")):
        raise AssertionError(f"{base}.ecx is not the key-sorted .idx")
    return len(ecx)


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
    """The file's sha256, hashed through a read-only mmap: on the H100
    machine, threads hashing through read() ran an order of magnitude
    slower (the mesh phase's `sha256_s`, PERF.md)."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            return hashlib.sha256().hexdigest()
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
            return hashlib.sha256(m).hexdigest()


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


# -- phase 4d: volume_server -----------------------------------------------

VS_PARTIAL_COPY = (0, 1, 2, 3, 4)  # shards moved to server B
VS_PARTIAL_LOST = (10, 11, 12, 13)  # lost everywhere, rebuilt from partials
VS_CORRUPT_SHARD = 11  # a parity shard: the decode reads data shards only
VS_RPC_TIMEOUT = 1800.0


def free_port_pair() -> int:
    """A port p that was free a moment ago with its gRPC sibling p + 10000
    (the servers' convention): both are bound to check, since p itself
    may lie in the range the kernel hands to outgoing connections."""
    import socket

    for _ in range(64):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            grpc_port = s.getsockname()[1]
        if grpc_port <= 10000 + 1024:
            continue
        try:
            with socket.socket() as s, socket.socket() as sibling:
                s.bind(("127.0.0.1", grpc_port - 10000))
                sibling.bind(("127.0.0.1", grpc_port))
        except OSError:
            continue
        return grpc_port - 10000
    raise RuntimeError("no free port pair above 11024")


class MiniMaster:
    """A master servicer built from the port's own rpc declarations, just
    enough for volume servers: `SendHeartbeat` records every beat and keeps
    each node's volume ids and EC shard bits (full beats replace them,
    deltas add and remove); `LookupVolume` (read redirects, replica
    fan-out) and `LookupEcVolume` answer from them, as the reference
    master's topology does.  Every other master rpc answers
    UNIMPLEMENTED."""

    def __init__(self, rpclib, master_pb2, grpc_port: int):
        import threading

        self.address = f"127.0.0.1:{grpc_port}"  # what volume servers dial
        self._pb = master_pb2
        self._cond = threading.Condition()
        self.beats: list = []
        # url -> {"rack", "dc", "volumes": {vid}, "ec": {vid: bits}}
        self.nodes: dict[str, dict] = {}
        self._server = rpclib.serve([(rpclib.MASTER, self)], grpc_port,
                                    host="127.0.0.1")

    def stop(self) -> None:
        self._server.stop(grace=0.5).wait()

    def SendHeartbeat(self, request_iterator, context):
        for hb in request_iterator:
            url = f"{hb.ip}:{hb.port}"
            with self._cond:
                self.beats.append(hb)
                node = self.nodes.setdefault(
                    url, {"rack": "", "dc": "", "volumes": set(), "ec": {}})
                if hb.volumes or hb.has_no_volumes:  # a full beat
                    node["volumes"] = {v.id for v in hb.volumes}
                node["volumes"] |= {v.id for v in hb.new_volumes}
                node["volumes"] -= {v.id for v in hb.deleted_volumes}
                if hb.ec_shards or hb.has_no_ec_shards:  # a full beat
                    node["rack"], node["dc"] = hb.rack, hb.data_center
                    node["ec"] = {e.id: e.ec_index_bits
                                  for e in hb.ec_shards}
                for e in hb.new_ec_shards:
                    node["ec"][e.id] = node["ec"].get(e.id, 0) \
                        | e.ec_index_bits
                for e in hb.deleted_ec_shards:
                    node["ec"][e.id] = node["ec"].get(e.id, 0) \
                        & ~e.ec_index_bits
                self._cond.notify_all()
            yield self._pb.HeartbeatResponse()

    def LookupVolume(self, request, context):
        resp = self._pb.LookupVolumeResponse()
        with self._cond:
            nodes = sorted(self.nodes.items())
        for vof in request.volume_or_file_ids:
            entry = resp.volume_id_locations.add(volume_or_file_id=vof)
            vid = int(vof.split(",", 1)[0])
            for url, n in nodes:
                if vid in n["volumes"]:
                    entry.locations.add(url=url, public_url=url,
                                        data_center=n["dc"], rack=n["rack"])
            if not entry.locations:
                entry.error = f"volume {vid} not found"
        return resp

    def LookupEcVolume(self, request, context):
        import grpc

        vid = request.volume_id
        resp = self._pb.LookupEcVolumeResponse(volume_id=vid)
        with self._cond:
            nodes = sorted(self.nodes.items())
        for sid in range(14):
            held = [(url, n) for url, n in nodes
                    if n["ec"].get(vid, 0) >> sid & 1]
            if held:
                e = resp.shard_id_locations.add(shard_id=sid)
                for url, n in held:
                    e.locations.add(url=url, public_url=url,
                                    data_center=n["dc"], rack=n["rack"])
        if not resp.shard_id_locations:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"ec volume {vid} not found")
        return resp

    def wait_for(self, pred, what: str, timeout: float = 60.0) -> None:
        """Block until pred(self) holds (re-checked on every beat)."""
        with self._cond:
            if not self._cond.wait_for(lambda: pred(self), timeout):
                raise AssertionError(f"master never saw {what}")

    def bits(self, url: str, vid: int) -> int:
        return self.nodes.get(url, {"ec": {}})["ec"].get(vid, 0)

    def holds(self, url: str, vid: int) -> bool:
        return vid in self.nodes.get(url, {"volumes": ()})["volumes"]


def _bits_of(shards) -> int:
    return sum(1 << s for s in shards)


def _needle_records(base: str, seed: int, sample: int = EC_READ_SAMPLE,
                    offset_bytes: int = 4) -> tuple[int, dict]:
    """`sample` seeded keys of the volume's .idx (`offset_bytes` 4 or 5),
    each with its .dat record's offset, length, sha256, its data's sha256,
    cookie, data length and CRC (the port's needle parser verifies that
    CRC) — what the reads over the wire are held against once the .dat is
    gone.  -> (.dat size, {key: record})."""
    from seaweedfs_tpu_torch.storage.needle import Needle, actual_size

    raw = np.fromfile(base + ".idx", dtype=idx_dtype(offset_bytes))
    live = raw[(idx_offsets(raw) > 0) & (raw["s"] > 0)
               & (raw["s"] != np.uint32(0xFFFFFFFF))]
    pick = np.random.default_rng(seed + 15).choice(
        len(live), min(sample, len(live)), replace=False)
    out = {}
    chosen = live[np.sort(pick)]
    with open(base + ".dat", "rb") as f:
        for e, off in zip(chosen, idx_offsets(chosen).tolist()):
            n = actual_size(int(e["s"]), 3)
            f.seek(off)
            rec = f.read(n)
            nd = Needle.from_bytes(rec, 3)
            out[int(e["k"])] = {
                "offset": off, "length": n,
                "sha256": hashlib.sha256(rec).hexdigest(),
                "data_sha256": hashlib.sha256(nd.data).hexdigest(),
                "cookie": nd.cookie, "size": len(nd.data),
                "crc": nd.checksum & 0xFFFFFFFF}
    return os.path.getsize(base + ".dat"), out


def _parallel_sha256(paths: list[str]) -> list[str]:
    with ThreadPoolExecutor(len(paths)) as pool:
        return list(pool.map(sha256_of, paths))


def _latency_row(name: str, lat: list, wall: float, **extra) -> dict:
    lat = np.asarray(lat)
    return {"pass": name, "reads": len(lat), "threads": EC_READ_THREADS,
            "wall_s": wall, "reads_per_s": len(lat) / wall,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3, **extra}


# -- phase 4e: http_plane ----------------------------------------------------

# h4: seeded needles POSTed to A, replicated to B; one process hosts the
# clients and both servers (~0.017-0.021 GB/s on the H100 machine)
HTTP_WRITE_BYTES = 512 * MIB
HTTP_JSON_NEEDLES = 256  # h4's first needles are JSON lines, for h6's Query
HTTP_SAMPLE = 64  # h2's HEADs, h3's Range GETs, h5's TCP needles
HTTP_DELETES = 16
HTTP_JWT_KEY = b"chip-smoke-write-key"


class _KeepAlive:
    """One keep-alive HTTP/1.1 connection per client thread to a port of
    this host, with TCP_NODELAY as the servers' own pooled clients set it.
    A kept connection the server closed while it sat idle (the event loop
    sweeps sockets idle for SEAWEEDFS_TPU_LOOP_IDLE_TIMEOUT_S) is redialled
    once, as util/connpool.py replays a stale socket."""

    def __init__(self, port: int):
        import threading

        self.port = port
        self._local = threading.local()

    def _dial(self):
        import http.client
        import socket

        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=VS_RPC_TIMEOUT)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def request(self, method: str, path: str, body: bytes | None = None,
                headers: dict | None = None) -> tuple[int, dict, bytes]:
        import http.client

        conn = getattr(self._local, "conn", None)
        reused = conn is not None
        for _ in range(2):
            if conn is None:
                conn = self._local.conn = self._dial()
            try:
                conn.request(method, path, body=body, headers=headers or {})
                r = conn.getresponse()
                return r.status, dict(r.getheaders()), r.read()
            except (http.client.RemoteDisconnected, ConnectionResetError,
                    BrokenPipeError):
                conn.close()
                conn = self._local.conn = None
                if not reused:
                    raise
                reused = False
        raise AssertionError("unreachable")


def _fid(vid: int, key: int, cookie: int) -> str:
    return f"{vid},{key:x}{cookie:08x}"


def _http_get_pass(client: _KeepAlive, name: str, keys: list[int],
                   records: dict, method: str = "GET", vid: int = 1,
                   latencies: list | None = None) -> dict:
    """Every key of `keys` of volume `vid` fetched from one server by
    EC_READ_THREADS threads on keep-alive connections, each body and Etag
    held against the needle's .dat record.  Each request's seconds are
    also appended to `latencies` when given.  -> the latency row."""
    def get(key: int) -> float:
        r = records[key]
        t0 = time.perf_counter()
        status, headers, body = client.request(
            method, "/" + _fid(vid, key, r["cookie"]))
        dt = time.perf_counter() - t0
        if status != 200 or headers.get("Etag") != f'"{r["crc"]:x}"' or (
                int(headers["Content-Length"]) != r["size"]) or (
                method == "GET" and hashlib.sha256(body).hexdigest()
                != r["data_sha256"]):
            raise AssertionError(f"{method} of needle {key:x}: {status} "
                                 f"{headers} differs from its .dat record")
        return dt

    t0 = time.perf_counter()
    with ThreadPoolExecutor(EC_READ_THREADS) as pool:
        lat = list(pool.map(get, keys))
    if latencies is not None:
        latencies.extend(lat)
    return _latency_row(name, lat, time.perf_counter() - t0,
                        bytes=sum(records[k]["size"] for k in keys),
                        byte_equal=True)


def _canary_query(ev) -> tuple[str, int]:
    """/debug/canary/ec's query for volume 1, dropping the shard of the
    probed needle's first interval, and the launches its decode makes: the
    gather reads the first 10 other mounted shards, and the codec decodes
    the missing data rows in one launch and re-encodes the parity rows it
    did not read in a second (`reconstruct`, all missing rows)."""
    _off, _size, intervals = ev.locate(ev.first_live_needle())
    sid, _ = intervals[0].to_shard_id_and_offset(ev.large_block_size,
                                                 ev.small_block_size)
    read = [s for s in sorted(ev.shards) if s != sid][:10]
    missing = set(range(14)) - set(read)
    return (f"?volume=1&shard={sid}",
            int(any(m < 10 for m in missing))
            + int(any(m >= 10 for m in missing)))


def _json_payload(rng, i: int) -> bytes:
    """JSON lines of seeded documents (1 to 600 lines)."""
    docs = [{"user": f"u{i}-{j}", "score": int(rng.integers(0, 100)),
             "zone": ["a", "b", "c"][int(rng.integers(0, 3))]}
            for j in range(int(rng.integers(1, 600)))]
    return "\n".join(json.dumps(d) for d in docs).encode()


def _plan_writes(total: int, seed: int) -> list[tuple[int, int, bytes]]:
    """h4's needles: HTTP_JSON_NEEDLES JSON-lines payloads, then seeded
    random data of 1 B to 256 KiB (phase 4's sizes) up to `total` bytes.
    -> [(key, cookie, payload)]."""
    rng = np.random.default_rng(seed + 40)
    out: list[tuple[int, int, bytes]] = []
    size = 0
    while size < total:
        i = len(out)
        payload = (_json_payload(rng, i) if i < HTTP_JSON_NEEDLES else
                   rng.integers(0, 256, int(rng.integers(
                       1, NEEDLE_MAX_DATA + 1)), dtype=np.uint8).tobytes())
        out.append((i + 1, int(rng.integers(0, 2**32)), payload))
        size += len(payload)
    return out


def http_plane_writes(rs_cuda, a, b, master, stub_a, stub_b, vs, metrics,
                      write_bytes: int, seed: int, power: str) -> dict:
    """h4-h7 of phase 4e on servers A and B (A with a TCP port and a
    metrics port; both require write JWTs).  Launch counts are zeroed
    just before each step and read just after.  -> {step: row}."""
    from seaweedfs_tpu_torch.query.engine import query_json_lines
    from seaweedfs_tpu_torch.security import gen_write_jwt

    rows: dict[str, dict] = {}

    def step(name: str, row: dict) -> None:
        row = {"phase": "http_plane", "step": name, **row,
               "launches": _launches(rs_cuda), "nvidia_smi": power}
        emit(row)
        rows[name] = row

    # h4. replicated writes: volume 2 (replication 001) on A and B
    for stub in (stub_a, stub_b):
        stub.AllocateVolume(vs.AllocateVolumeRequest(
            volume_id=2, replication="001"))
    url_a, url_b = f"127.0.0.1:{a.port}", f"127.0.0.1:{b.port}"
    master.wait_for(lambda m: m.holds(url_a, 2) and m.holds(url_b, 2),
                    "volume 2 on A and B")
    plan = _plan_writes(write_bytes, seed)
    http_a, http_b = _KeepAlive(a.port), _KeepAlive(b.port)
    errors = metrics.REPLICATION_ERROR.labels("write")
    before = errors.value

    def post(item) -> float:
        key, cookie, payload = item
        fid = _fid(2, key, cookie)
        auth = {"Authorization": "Bearer " + gen_write_jwt(HTTP_JWT_KEY, fid),
                "Content-Type": "application/octet-stream"}
        t0 = time.perf_counter()
        status, _h, body = http_a.request("POST", "/" + fid, payload, auth)
        dt = time.perf_counter() - t0
        if status != 201 or json.loads(body)["size"] < len(payload):
            raise AssertionError(f"POST {fid}: {status} {body[:200]}")
        return dt

    _zero_launches(rs_cuda)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(EC_READ_THREADS) as pool:
        lat = list(pool.map(post, plan))
    wall = time.perf_counter() - t0
    key, cookie, payload = plan[0]
    status, _h, _b = http_a.request("POST", "/" + _fid(2, key + 10**6,
                                                        cookie), payload)
    if status != 401:
        raise AssertionError(f"a POST without a write JWT got {status}")
    total = sum(len(p) for _k, _c, p in plan)
    write_row = {
        "needles": len(plan), "bytes": total, "threads": EC_READ_THREADS,
        "wall_s": wall, "GBps": total / wall / 1e9,
        "needles_per_s": len(plan) / wall,
        "p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "replication_errors": errors.value - before,
        "unsigned_post_status": status,
        "reduced": [f"{total} bytes of writes: the script's time limit"]}

    def read_b(item) -> None:
        key, cookie, payload = item
        status, _h, body = http_b.request("GET", "/" + _fid(2, key, cookie))
        if status != 200 or body != payload:
            raise AssertionError(f"needle {key:x} on B: {status}, "
                                 f"{len(body)} bytes of {len(payload)}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(EC_READ_THREADS) as pool:
        list(pool.map(read_b, plan))
    read_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 41)
    gone = [plan[int(i)] for i in rng.choice(
        np.arange(HTTP_JSON_NEEDLES, len(plan)), HTTP_DELETES,
        replace=False)]
    for key, cookie, _p in gone:
        fid = _fid(2, key, cookie)
        auth = {"Authorization": "Bearer " + gen_write_jwt(HTTP_JWT_KEY,
                                                            fid)}
        status, _h, body = http_a.request("DELETE", "/" + fid, None, auth)
        got = [status] + [c.request("GET", "/" + fid)[0]
                          for c in (http_a, http_b)]
        if got != [202, 404, 404]:
            raise AssertionError(f"DELETE {fid} at A, then GET at A and "
                                 f"B: {got}")
    step("h4_replicated_writes", {
        **write_row, "readback_from_b_s": read_s,
        "readback_from_b_GBps": total / read_s / 1e9,
        "readback_equal": True, "deleted_at_a": len(gone),
        "deleted_404_on_a_and_b": True})

    # h5. the raw-TCP path on A's tcp_port, volume 3 (no replication; the
    # protocol carries no credential, so A takes TCP writes with its
    # write-JWT key cleared, as a cluster without write JWTs)
    import socket
    import struct

    stub_a.AllocateVolume(vs.AllocateVolumeRequest(volume_id=3))
    key_a, a.jwt_signing_key = a.jwt_signing_key, b""
    _zero_launches(rs_cuda)
    sock = socket.create_connection(("127.0.0.1", a.tcp_port), timeout=60)
    rf = sock.makefile("rb")
    try:
        tcp = [(k, c, p) for k, c, p in plan[HTTP_JSON_NEEDLES:][:HTTP_SAMPLE]]
        t0 = time.perf_counter()
        for key, cookie, payload in tcp:
            sock.sendall(b"+" + _fid(3, key, cookie).encode() + b"\n"
                         + struct.pack(">I", len(payload)) + payload)
            if rf.readline() != b"+OK\n":
                raise AssertionError(f"TCP put of needle {key:x}")
        for key, cookie, payload in tcp:
            sock.sendall(b"?" + _fid(3, key, cookie).encode() + b"\n")
            head = rf.readline()
            if head != b"+OK %d\n" % len(payload) or rf.read(
                    len(payload)) != payload:
                raise AssertionError(f"TCP get of needle {key:x}: {head}")
        for key, cookie, _p in tcp:
            sock.sendall(b"-" + _fid(3, key, cookie).encode() + b"\n")
            if rf.readline() != b"+OK\n":
                raise AssertionError(f"TCP delete of needle {key:x}")
            sock.sendall(b"?" + _fid(3, key, cookie).encode() + b"\n")
            if not rf.readline().startswith(b"-ERR"):
                raise AssertionError(f"needle {key:x} read after delete")
        tcp_s = time.perf_counter() - t0
    finally:
        rf.close()
        sock.close()
        a.jwt_signing_key = key_a
    step("h5_tcp", {"needles": len(tcp), "seconds": tcp_s,
                    "ops_per_s": 4 * len(tcp) / tcp_s, "equal": True})

    # h6. Query over the JSON-lines needles, against a plain filter
    def plain(payload: bytes) -> bytes:
        docs = [json.loads(line) for line in payload.decode().splitlines()]
        return b"".join(json.dumps({"user": d["user"]},
                                   separators=(",", ":")).encode() + b"\n"
                        for d in docs if d["score"] >= 50)

    qv = vs.QueryRequest
    _zero_launches(rs_cuda)
    t0 = time.perf_counter()
    records = 0
    for key, cookie, payload in plan[:HTTP_JSON_NEEDLES]:
        got = b"".join(s.records for s in stub_a.Query(qv(
            selections=["user"], from_file_ids=[_fid(2, key, cookie)],
            filter=qv.Filter(field="score", operand=">=", value="50"),
            input_serialization=qv.InputSerialization(
                json_input=qv.InputSerialization.JSONInput(
                    type="LINES")))))
        want = plain(payload)
        if got != want or got != query_json_lines(
                payload, ["user"], field="score", op=">=", value="50"):
            raise AssertionError(f"Query of needle {key:x} differs")
        records += want.count(b"\n")
    query_s = time.perf_counter() - t0
    step("h6_query", {"needles": HTTP_JSON_NEEDLES, "records": records,
                      "seconds": query_s,
                      "needles_per_s": HTTP_JSON_NEEDLES / query_s,
                      "equal_to_plain_filter": True})

    # h7. /metrics on A's metrics port and /debug/traces on A's HTTP port
    _zero_launches(rs_cuda)
    status, _h, body = _KeepAlive(a.metrics_port).request("GET", "/metrics")
    text = body.decode()
    families = {line.split("{")[0].split(" ")[0]
                for line in text.splitlines()
                if line and not line.startswith("#")}
    want_fams = {"seaweedfs_request_total", "seaweedfs_sendfile_bytes_total",
                 "seaweedfs_sendfile_fallback_total",
                 "seaweedfs_httpd_open_sockets",
                 "seaweedfs_httpd_inflight_requests",
                 "seaweedfs_connpool_dial_total",
                 "seaweedfs_hotkey_events_total"}
    if status != 200 or not want_fams <= families or \
            'type="volumeServer",op="get"' not in text:
        raise AssertionError(f"/metrics: {status}, missing "
                             f"{sorted(want_fams - families)}")
    status, _h, body = http_a.request("GET", "/debug/traces?limit=1000")
    spans: dict[str, int] = {}
    for tr in json.loads(body)["traces"]:
        for sp in tr["spans"]:
            spans[sp["name"]] = spans.get(sp["name"], 0) + 1
    if status != 200 or not spans.get("volumeServer.get"):
        raise AssertionError(f"/debug/traces: {status} {spans}")
    step("h7_metrics_traces", {"families": len(families),
                               "http_families": sorted(want_fams),
                               "trace_spans": spans})
    return rows


def phase_volume_server(rs_cuda, gf256, enc, metrics, work: str, seed: int,
                        power: str, reduced: list[str],
                        device: str = "cuda",
                        free_port=free_port_pair,
                        http_write_bytes: int = HTTP_WRITE_BYTES) -> dict:
    """The volume server's gRPC side on the card: two port VolumeServers,
    A over `work` (a directory holding sealed volume 1's .dat/.idx, as
    phase 4c leaves it) and B over a fresh directory, both on the servers'
    default codec (`cuda`), and a MiniMaster; every step an rpc a shell or master
    sends, in the order an operator runs them: generate, mount and
    heartbeat, healthy interval reads, degraded needle reads, rebuild,
    partial-sum repair through B, the same repair falling back to full
    fetches from B, scrub, decode.  Launch counts are zeroed
    just before each step and read just after.  -> launches by kernel and
    step, and the rows.  `free_port()` names each server's port p (its
    gRPC port is p + 10000); a test suite passes its own, so that no two
    servers of one process ever get the same port.

    Phase 4e, http_plane, runs on the same servers at the points where the
    volume is in the state each step needs, each step on its own line:
    (h1) after step 3, the needles by HTTP GET; (h2) after step 4, the
    same GETs degraded, 64 HEADs and /debug/canary/ec; (h3) after step 8,
    the GETs on the sendfile path and 64 Range GETs; then (h4-h7)
    `http_write_bytes` of replicated writes, the TCP path, Query, /metrics
    and /debug/traces (http_plane_writes)."""
    from seaweedfs_tpu_torch.ops import codec_service
    from seaweedfs_tpu_torch.pb import master_pb2
    from seaweedfs_tpu_torch.pb import rpc as rpclib
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs
    from seaweedfs_tpu_torch.storage.ec.locate import locate_data
    from seaweedfs_tpu_torch.util import faultpoint
    from seaweedfs_tpu_torch.volume.server import VolumeServer

    t_phase = time.perf_counter()
    base = os.path.join(work, "1")
    for name in os.listdir(work):  # an earlier run's EC files
        if name.startswith("1.ec") or name == "scrub.cursor.json":
            os.remove(os.path.join(work, name))
    dat_size, records = _needle_records(base, seed)
    work_b = os.path.join(work, "server_b")
    os.makedirs(work_b, exist_ok=True)
    master = MiniMaster(rpclib, master_pb2, free_port() + 10000)
    servers = []
    steps: dict[str, dict] = {}
    http_steps: dict[str, dict] = {}
    # the scrub daemons off and on-demand scans unthrottled, as phase 4c's
    # Scrubber(rate_mbps=0): only the VolumeScrub rpcs below read shards
    scrub_rate = os.environ.get("SEAWEEDFS_TPU_SCRUB_RATE_MBPS")
    os.environ["SEAWEEDFS_TPU_SCRUB_RATE_MBPS"] = "0"
    try:
        for i, d in enumerate((work, work_b)):
            # A also serves /metrics and the raw-TCP path; both require
            # write JWTs on their HTTP plane
            extra = ({"metrics_port": free_port(), "tcp_port": free_port()}
                     if i == 0 else {})
            srv = VolumeServer([d], [master.address], ip="127.0.0.1",
                               port=free_port(), pulse_seconds=1.0,
                               jwt_signing_key=HTTP_JWT_KEY, **extra)
            srv.start()
            servers.append(srv)
        a, b = servers
        http_a = _KeepAlive(a.port)
        route = ("service" if codec_service.service_for_codec(
            a.store.codec_name) else "direct")
        url_a, url_b = f"127.0.0.1:{a.port}", f"127.0.0.1:{b.port}"
        stub_a = rpclib.volume_server_stub(f"127.0.0.1:{a.grpc_port}",
                                           timeout=VS_RPC_TIMEOUT)
        stub_b = rpclib.volume_server_stub(f"127.0.0.1:{b.grpc_port}",
                                           timeout=VS_RPC_TIMEOUT)

        def step(name: str, row: dict) -> None:
            row = {"phase": f"volume_server_{name}", **row,
                   "nvidia_smi": power}
            emit(row)
            steps[name] = row

        def http_step(name: str, row: dict) -> None:
            row = {"phase": "http_plane", "step": name, **row,
                   "nvidia_smi": power}
            emit(row)
            http_steps[name] = row

        # 1. generate, as `ec.encode` drives it: readonly, then generate
        # on the server's default codec
        dat_sha = sha256_of(base + ".dat")
        stub_a.VolumeMarkReadonly(vs.VolumeMarkReadonlyRequest(volume_id=1))
        slices = len(list(enc._slice_tasks(
            dat_size, enc.LARGE_BLOCK_SIZE, enc.SMALL_BLOCK_SIZE,
            enc.DEFAULT_SLICE)))
        _zero_launches(rs_cuda)
        t0 = time.perf_counter()
        stub_a.VolumeEcShardsGenerate(
            vs.VolumeEcShardsGenerateRequest(volume_id=1))
        gen_s = time.perf_counter() - t0
        launches = _launches(rs_cuda)
        if not 1 <= sum(launches.values()) <= slices:
            raise AssertionError(f"generate launched {launches} for "
                                 f"{slices} slices")
        check_ecx(base)
        shard_size = os.path.getsize(base + ".ec00")
        offs = list(range(0, shard_size, enc.DEFAULT_SLICE))
        sampled = sorted(np.random.default_rng(seed + 16).choice(
            len(offs), min(8, len(offs)), replace=False).tolist())
        checked = check_parity(base, rs_cuda, gf256, enc.DEFAULT_SLICE,
                               [offs[i] for i in sampled], device)
        watched = sorted(set(EC_READ_LOSS) | set(VS_PARTIAL_LOST))
        digests = dict(zip(watched, _parallel_sha256(
            [base + f".ec{i:02d}" for i in watched])))
        step("generate", {"codec": a.store.codec_name, "seconds": gen_s,
                          "GBps": dat_size / gen_s / 1e9, "slices": slices,
                          "launches": launches, "shard_bytes": shard_size,
                          "ecx_sorted": True,
                          "parity_slices_checked": checked,
                          "reduced": reduced})

        # 2. mount; the master hears of all 14 shards; the .dat goes
        _zero_launches(rs_cuda)
        stub_a.VolumeEcShardsMount(vs.VolumeEcShardsMountRequest(
            volume_id=1, shard_ids=list(range(14))))
        master.wait_for(lambda m: m.bits(url_a, 1) == 0x3FFF,
                        "volume 1 with ec_index_bits 0x3fff from A")
        beat = next(hb for hb in reversed(master.beats)
                    if f"{hb.ip}:{hb.port}" == url_a and any(
                        e.id == 1 and e.ec_index_bits == 0x3FFF
                        for e in list(hb.ec_shards) + list(hb.new_ec_shards)))
        stub_a.VolumeDelete(vs.VolumeDeleteRequest(volume_id=1))
        if os.path.exists(base + ".dat"):
            raise AssertionError("VolumeDelete left the .dat")
        step("mount_heartbeat", {
            "beats": len(master.beats),
            "carried_by": "new_ec_shards" if len(beat.new_ec_shards)
            else "ec_shards", "ec_index_bits": "0x3fff",
            "launches": _launches(rs_cuda)})

        # 3. healthy reads: every interval of each needle by
        # VolumeEcShardRead, 16 client threads
        def read_intervals(key: int) -> float:
            r = records[key]
            t0 = time.perf_counter()
            got = []
            for iv in locate_data(enc.LARGE_BLOCK_SIZE, enc.SMALL_BLOCK_SIZE,
                                  dat_size, r["offset"], r["length"]):
                sid, off = iv.to_shard_id_and_offset(enc.LARGE_BLOCK_SIZE,
                                                     enc.SMALL_BLOCK_SIZE)
                got.extend(x.data for x in stub_a.VolumeEcShardRead(
                    vs.VolumeEcShardReadRequest(
                        volume_id=1, shard_id=sid, offset=off,
                        size=iv.size)))
            dt = time.perf_counter() - t0
            if hashlib.sha256(b"".join(got)).hexdigest() != r["sha256"]:
                raise AssertionError(f"needle {key:x}: intervals differ "
                                     "from the .dat record")
            return dt

        keys = list(records)
        _zero_launches(rs_cuda)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(EC_READ_THREADS) as pool:
            lat = list(pool.map(read_intervals, keys))
        healthy = _latency_row("healthy_VolumeEcShardRead", lat,
                               time.perf_counter() - t0,
                               launches=_launches(rs_cuda),
                               byte_equal=True)
        if any(healthy["launches"].values()):
            raise AssertionError(f"healthy reads launched {healthy}")

        # h1. the same needles by HTTP GET on A, all 14 shards mounted
        _zero_launches(rs_cuda)
        row = _http_get_pass(http_a, "healthy_http_get", keys, records)
        row["launches"] = _launches(rs_cuda)
        if any(row["launches"].values()):
            raise AssertionError(f"healthy GETs launched {row}")
        http_step("h1_healthy_gets", row)
        # the degraded-read canary, one held shard dropped: a decode needs
        # 10 of 14 shards, so it runs here, before h2 loses 4 of them
        ev = a.store.find_ec_volume(1)
        query, want = _canary_query(ev)
        _zero_launches(rs_cuda)
        status, _h, body = http_a.request("GET", "/debug/canary/ec" + query)
        canary = {**json.loads(body), "status": status, "query": query,
                  "launches": _launches(rs_cuda), "expected_launches": want}
        if status != 200 or not canary.get("ok") or not canary.get(
                "reconstructed") or canary["launches"]["gf_matmul"] != want:
            raise AssertionError(f"canary {canary}")
        http_step("h1_canary", canary)

        # 4. degraded reads: 4 shards dropped, each needle read whole
        # through VolumeNeedleStatus, A decoding lost intervals on its codec
        lost = list(EC_READ_LOSS)
        stub_a.VolumeEcShardsUnmount(vs.VolumeEcShardsUnmountRequest(
            volume_id=1, shard_ids=lost))
        stub_a.VolumeEcShardsDelete(vs.VolumeEcShardsDeleteRequest(
            volume_id=1, shard_ids=lost))
        if a.store.needle_cache is not None:
            a.store.needle_cache.clear()

        def read_needle(key: int) -> float:
            r = records[key]
            t0 = time.perf_counter()
            got = stub_a.VolumeNeedleStatus(vs.VolumeNeedleStatusRequest(
                volume_id=1, needle_id=key))
            dt = time.perf_counter() - t0
            if (got.needle_id, got.cookie, got.size, got.crc) != (
                    key, r["cookie"], r["size"], r["crc"]):
                raise AssertionError(f"needle {key:x}: status {got} differs "
                                     "from the .dat record")
            return dt

        counters = _ReadCounters(rs_cuda, metrics)
        counters.start()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(EC_READ_THREADS) as pool:
            lat = list(pool.map(read_needle, keys))
        wall = time.perf_counter() - t0
        c = counters.read()
        degraded = _latency_row(
            "degraded_VolumeNeedleStatus", lat, wall,
            degraded_intervals=c["degraded_intervals"],
            launches={"gf_matmul": c["launches"],
                      "gf_matmul_batched": c["batched_launches"]},
            compiles=c["compiles"], crc_equal=True)
        if not c["degraded_intervals"] or c["launches"] < c["gathers"]:
            raise AssertionError(f"degraded reads: {c}")

        # h2. the same needles by HTTP GET with .ec00-.ec03 lost, caches
        # cleared: A decodes every lost interval once, on its codec
        ev = a.store.find_ec_volume(1)
        if a.store.needle_cache is not None:
            a.store.needle_cache.clear()
        if ev._interval_cache is not None:
            ev._interval_cache.clear()
        counters = _ReadCounters(rs_cuda, metrics)
        counters.start()
        row = _http_get_pass(http_a, "degraded_http_get", keys, records)
        hc = counters.read()
        row.update(degraded_intervals=hc["degraded_intervals"],
                   interval_cache_hits=hc["interval_cache_hits"],
                   launches={"gf_matmul": hc["launches"],
                             "gf_matmul_batched": hc["batched_launches"]},
                   compiles=hc["compiles"])
        if not hc["launches"] == hc["degraded_intervals"] > 0:
            raise AssertionError(f"degraded GETs: {hc}")
        _zero_launches(rs_cuda)
        heads = _http_get_pass(http_a, "degraded_http_head",
                               keys[:HTTP_SAMPLE], records, method="HEAD")
        heads["launches"] = _launches(rs_cuda)
        http_step("h2_degraded_gets", {
            **row, "heads": heads,
            "launches": {k: row["launches"][k] + heads["launches"][k]
                         for k in row["launches"]}})
        step("reads", {"passes": [healthy, degraded],
                       "launches": {k: healthy["launches"][k]
                                    + degraded["launches"][k]
                                    for k in healthy["launches"]}})

        # 5. rebuild of the 4, then remount
        _zero_launches(rs_cuda)
        t0 = time.perf_counter()
        got = stub_a.VolumeEcShardsRebuild(
            vs.VolumeEcShardsRebuildRequest(volume_id=1))
        rebuild_s = time.perf_counter() - t0
        launches = _launches(rs_cuda)
        if list(got.rebuilt_shard_ids) != lost or _parallel_sha256(
                [base + f".ec{i:02d}" for i in lost]) != [
                digests[i] for i in lost]:
            raise AssertionError(f"rebuilt {list(got.rebuilt_shard_ids)}, "
                                 "or they differ by sha256")
        if not sum(launches.values()):
            raise AssertionError("the rebuild launched no kernel")
        stub_a.VolumeEcShardsMount(vs.VolumeEcShardsMountRequest(
            volume_id=1, shard_ids=lost))
        step("rebuild", {"rebuilt": lost, "seconds": rebuild_s,
                         "GBps_read": 10 * shard_size / rebuild_s / 1e9,
                         "launches": launches, "sha256_equal": True})

        # 6. partial-sum repair: 5 shards moved to B, 4 lost everywhere,
        # rebuilt on A from its 5 and B's partial sums
        moved, gone = list(VS_PARTIAL_COPY), list(VS_PARTIAL_LOST)
        t0 = time.perf_counter()
        stub_b.VolumeEcShardsCopy(vs.VolumeEcShardsCopyRequest(
            volume_id=1, shard_ids=moved, copy_ecx_file=True,
            copy_vif_file=True, copy_from_data_node=(
                f"127.0.0.1:{a.grpc_port}")))
        copy_s = time.perf_counter() - t0
        stub_b.VolumeEcShardsMount(vs.VolumeEcShardsMountRequest(
            volume_id=1, shard_ids=moved))
        stub_a.VolumeEcShardsUnmount(vs.VolumeEcShardsUnmountRequest(
            volume_id=1, shard_ids=moved + gone))
        stub_a.VolumeEcShardsDelete(vs.VolumeEcShardsDeleteRequest(
            volume_id=1, shard_ids=moved + gone))
        master.wait_for(
            lambda m: m.bits(url_b, 1) == _bits_of(moved)
            and m.bits(url_a, 1) == 0x3FFF & ~_bits_of(moved + gone),
            "shards 0-4 on B and 5-9 on A")
        recv = metrics.EC_PARTIAL_BYTES.labels("recv")
        served = metrics.GRPC_BYTES.labels(
            "volumeServerGrpc", "VolumeEcShardPartialApply", "tx")
        fallback = metrics.EC_PARTIAL_FALLBACK.labels("rebuild")
        before = (recv.value, served.value, fallback.value)
        _zero_launches(rs_cuda)
        t0 = time.perf_counter()
        got = stub_a.VolumeEcShardsRebuild(
            vs.VolumeEcShardsRebuildRequest(volume_id=1))
        partial_s = time.perf_counter() - t0
        launches = _launches(rs_cuda)
        recv_b, served_b, fell = (recv.value - before[0],
                                  served.value - before[1],
                                  fallback.value - before[2])
        full_fetch = len(moved) * shard_size
        if list(got.rebuilt_shard_ids) != gone or _parallel_sha256(
                [base + f".ec{i:02d}" for i in gone]) != [
                digests[i] for i in gone]:
            raise AssertionError(f"partial rebuild made "
                                 f"{list(got.rebuilt_shard_ids)}, or they "
                                 "differ by sha256")
        if fell or recv_b != len(gone) * shard_size \
                or not recv_b < full_fetch or served_b < recv_b:
            raise AssertionError(
                f"partial wire: {recv_b} bytes in, {served_b} served, "
                f"{fell} fallbacks; a full fetch is {full_fetch}")
        if not sum(launches.values()):
            raise AssertionError("the partial rebuild launched no kernel")
        partial_row = {
            "moved_to_b": moved, "rebuilt": gone, "seconds": partial_s,
            "GBps_read": 10 * shard_size / partial_s / 1e9,
            "bytes_in": recv_b, "bytes_served_by_b": served_b,
            "full_fetch_bytes": full_fetch, "fallbacks": fell,
            "launches": launches, "sha256_equal": True}

        # 6b. the same repair with B's partial source failing on its first
        # slice: the rebuild falls back to full fetches from B, and their
        # share of the decode runs on A's own codec, never the host's
        for sid in gone:
            os.remove(base + f".ec{sid:02d}")
        host = metrics.EC_OP_HISTOGRAM.labels("apply_rows", "cpu")
        before = (host.count, fallback.value)
        faultpoint.set_fault("ec.partial.apply", "error")
        _zero_launches(rs_cuda)
        t0 = time.perf_counter()
        try:
            got = stub_a.VolumeEcShardsRebuild(
                vs.VolumeEcShardsRebuildRequest(volume_id=1))
        finally:
            faultpoint.clear_fault("ec.partial.apply")
        fallback_s = time.perf_counter() - t0
        launches = _launches(rs_cuda)
        on_host, fell = host.count - before[0], fallback.value - before[1]
        if list(got.rebuilt_shard_ids) != gone or _parallel_sha256(
                [base + f".ec{i:02d}" for i in gone]) != [
                digests[i] for i in gone]:
            raise AssertionError(f"the fallback rebuild made "
                                 f"{list(got.rebuilt_shard_ids)}, or they "
                                 "differ by sha256")
        if fell != 1 or on_host or not sum(launches.values()):
            raise AssertionError(
                f"fallback rebuild: {fell} fallbacks, {on_host} host "
                f"apply_rows, launches {launches}")
        step("partial_fallback", {
            "rebuilt": gone, "seconds": fallback_s,
            "GBps_read": 10 * shard_size / fallback_s / 1e9,
            "fallbacks": fell, "host_apply_rows": on_host,
            "launches": launches, "sha256_equal": True})
        stub_a.VolumeEcShardsMount(vs.VolumeEcShardsMountRequest(
            volume_id=1, shard_ids=gone))
        # the moved shards come back to A (as ec.balance moves them)
        t0 = time.perf_counter()
        stub_a.VolumeEcShardsCopy(vs.VolumeEcShardsCopyRequest(
            volume_id=1, shard_ids=moved,
            copy_from_data_node=f"127.0.0.1:{b.grpc_port}"))
        back_s = time.perf_counter() - t0
        stub_b.VolumeEcShardsUnmount(vs.VolumeEcShardsUnmountRequest(
            volume_id=1, shard_ids=moved))
        stub_b.VolumeEcShardsDelete(vs.VolumeEcShardsDeleteRequest(
            volume_id=1, shard_ids=moved))
        stub_a.VolumeEcShardsMount(vs.VolumeEcShardsMountRequest(
            volume_id=1, shard_ids=moved))
        step("partial_rebuild", {
            **partial_row,
            "copy_to_b_GBps": len(moved) * shard_size / copy_s / 1e9,
            "copy_back_GBps": len(moved) * shard_size / back_s / 1e9})

        # 7. scrub: clean, then one flipped byte found once, in its interval
        _zero_launches(rs_cuda)
        t0 = time.perf_counter()
        scrub = vs.VolumeScrubRequest(volume_id=1)  # unthrottled: rate 0
        clean = stub_a.VolumeScrub(scrub)
        scrub_s = time.perf_counter() - t0
        launches = _launches(rs_cuda)
        if clean.corrupt_shards or clean.corrupt_needles or clean.findings:
            raise AssertionError(f"the scrub of a sound volume found {clean}")
        interval = a.scrubber.ec_interval
        rng = np.random.default_rng(seed + 17)
        pos = int(rng.integers(0, shard_size))
        at = pos // interval * interval
        width = min(interval, shard_size - at)
        path = base + f".ec{VS_CORRUPT_SHARD:02d}"
        fd = os.open(path, os.O_RDWR)
        try:
            byte = os.pread(fd, 1, pos)
            os.pwrite(fd, bytes([byte[0] ^ 0xFF]), pos)
            found = stub_a.VolumeScrub(scrub)
        finally:
            os.pwrite(fd, byte, pos)  # the decode below reads it sound
            os.close(fd)
        want = (f"vol=1 kind=ec_shard shard={VS_CORRUPT_SHARD} needle=0 "
                f"parity mismatch at {at}+{width}")
        if found.corrupt_shards != 1 or list(found.findings) != [want]:
            raise AssertionError(f"flipped byte at {pos}: {found}")
        step("scrub", {"seconds": scrub_s,
                       "GBps": clean.scanned_bytes / scrub_s / 1e9,
                       "scanned": clean.scanned,
                       "scanned_bytes": clean.scanned_bytes,
                       "launches": launches,
                       "corrupt": {"shard": VS_CORRUPT_SHARD, "byte": pos,
                                   "finding": want}})

        # 8. decode back to a volume
        _zero_launches(rs_cuda)
        t0 = time.perf_counter()
        stub_a.VolumeEcShardsToVolume(vs.VolumeEcShardsToVolumeRequest(
            volume_id=1))
        decode_s = time.perf_counter() - t0
        if sha256_of(base + ".dat") != dat_sha:
            raise AssertionError("decoded .dat differs by sha256")
        status = stub_a.VolumeStatus(vs.VolumeStatusRequest(volume_id=1))
        step("decode", {"seconds": decode_s,
                        "GBps": dat_size / decode_s / 1e9,
                        "dat_sha256_equal": True,
                        "mounted_read_only": status.is_read_only,
                        "launches": _launches(rs_cuda)})

        # h3. the GETs again from the decoded volume, each body sent from
        # the .dat by sendfile; then Range GETs, which take the fallback
        if a.store.needle_cache is not None:
            a.store.needle_cache.clear()
        sent = metrics.SENDFILE_BYTES.labels()
        ranged = metrics.SENDFILE_FALLBACK.labels("range")
        _zero_launches(rs_cuda)
        before = sent.value
        row = _http_get_pass(http_a, "sendfile_http_get", keys, records)
        # the counter ticks on A's worker after the response's last byte
        deadline = time.monotonic() + 30
        while sent.value - before < row["bytes"] and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        row["sendfile_bytes"] = sent.value - before
        if row["sendfile_bytes"] != row["bytes"]:
            raise AssertionError(f"sendfile moved {row['sendfile_bytes']} "
                                 f"bytes for {row['bytes']}")
        before = ranged.value
        for key in keys[:HTTP_SAMPLE]:
            r = records[key]
            lo = r["size"] // 3
            path = "/" + _fid(1, key, r["cookie"])
            st, headers, part = http_a.request(
                "GET", path, headers={"Range": f"bytes={lo}-"})
            whole = http_a.request("GET", path)[2]
            if st != 206 or part != whole[lo:] or headers[
                    "Content-Range"] != (f"bytes {lo}-{r['size'] - 1}/"
                                         f"{r['size']}"):
                raise AssertionError(f"Range GET of needle {key:x}: {st}")
        row["range_gets"] = HTTP_SAMPLE
        row["range_fallbacks"] = ranged.value - before
        if row["range_fallbacks"] != HTTP_SAMPLE:
            raise AssertionError(f"range GETs: {row}")
        row["launches"] = _launches(rs_cuda)
        http_step("h3_sendfile_gets", row)

        http_steps.update(http_plane_writes(
            rs_cuda, a, b, master, stub_a, stub_b, vs, metrics,
            http_write_bytes, seed, power))
    finally:
        for srv in servers:
            srv.stop()
        master.stop()
        if scrub_rate is None:
            del os.environ["SEAWEEDFS_TPU_SCRUB_RATE_MBPS"]
        else:
            os.environ["SEAWEEDFS_TPU_SCRUB_RATE_MBPS"] = scrub_rate
        shutil.rmtree(work_b, ignore_errors=True)
    by_kernel: dict[str, dict] = {"gf_matmul": {}, "gf_matmul_batched": {}}
    for prefix, rows in (("volume_server", steps), ("http_plane", http_steps)):
        for name, row in rows.items():
            for kernel, n in row.get("launches", {}).items():
                if n:
                    by_kernel[kernel][f"{prefix}_{name}"] = n
    # on a card the bulk rpcs take the codec service's batched launch and
    # degraded reads the direct one; without a card every path is direct
    want = (("gf_matmul", "gf_matmul_batched") if route == "service"
            else ("gf_matmul",))
    if not all(by_kernel[k] for k in want):
        raise AssertionError(f"the rpcs launched {by_kernel} on the {route} "
                             "route")
    emit({"phase": "volume_server_summary", "route": route,
          "launches_by_path": by_kernel,
          "reduced": reduced, "wall_s": time.perf_counter() - t_phase,
          "nvidia_smi": power})
    if "http_plane_h2_degraded_gets" not in by_kernel["gf_matmul"]:
        raise AssertionError("the degraded HTTP GETs launched no kernel")
    return {"launches_by_path": by_kernel, "steps": steps,
            "http_steps": http_steps}


# -- phase 5 -------------------------------------------------------------


# -- phase 4f: cluster -------------------------------------------------------

CLUSTER_VOLUME_BYTES = 3 * GIB  # the sealed volume A holds before it starts
CLUSTER_WRITE_BYTES = 256 * MIB  # step 1: replicated writes through assigns
CLUSTER_DECODE_SAMPLE = 64  # step 6: GETs served from the decoded .dat
CLUSTER_START_S = 60.0  # every process registered and the volume listed
CLUSTER_STOP_S = 30.0  # each process's exit after SIGTERM
CLUSTER_LIVENESS_S = 60.0  # the master drops a killed node (3 pulses)
# the volume servers' ops that say which codec did the GF work, and the
# kernels' own launch counts (each wrapper's count, mirrored in /metrics)
_CODEC_FAMILIES = ("seaweedfs_ec_op_seconds_count",
                   "seaweedfs_ec_rebuild_seconds_count")
_LAUNCH_FAMILY = "seaweedfs_cuda_kernel_launches_total"
_SERVICE_FAMILY = "seaweedfs_ec_service_jobs_total"
# a degraded read on a node holding < 10 shards takes the partial-sum path
# by default: its peers send pre-summed rows, its local columns are applied
# on the host codec (storage/ec/volume.py::_partial_decode)
_PARTIAL_FAMILY = "seaweedfs_ec_partial_jobs_total"
_PARTIAL_FALLBACK_FAMILY = "seaweedfs_ec_partial_fallback_total"
_PARTIAL_BYTES_FAMILY = "seaweedfs_ec_partial_bytes_total"
# source bytes into rebuilds and partial-sum reads, by locality
_REBUILD_BYTES_FAMILY = "seaweedfs_ec_rebuild_bytes_total"
# the master's maintenance plane (phase 4g)
_MASTER_FAMILIES = ("seaweedfs_repair_batch_", "seaweedfs_lifecycle_")


class _Cluster:
    """A master and three volume servers, each a `python -m
    seaweedfs_tpu_torch` process with its log in `work`; the shell runs
    as a process of its own per command."""

    def __init__(self, work: str, codec: str, free_port):
        self.work = work
        self.codec = codec
        self.free_port = free_port
        self.procs: dict[str, subprocess.Popen] = {}
        self.logs: dict[str, str] = {}
        self.log_mark: dict[str, int] = {}
        root = os.path.dirname(os.path.abspath(__file__))
        self.env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p])}
        self.root = root
        self.master_port = free_port()
        self.master_metrics = free_port()
        self.nodes: dict[str, dict] = {}
        self.killed: set[str] = set()  # SIGKILLed on purpose

    def start(self, name: str, *argv: str, env: dict | None = None) -> None:
        log = os.path.join(self.work, f"{name}.log")
        self.logs[name] = log
        with open(log, "wb") as f:
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_tpu_torch", *argv],
                cwd=self.work, env={**self.env, **(env or {})}, stdout=f,
                stderr=subprocess.STDOUT)

    def start_master(self, *flags: str, limit_mb: int = 30000,
                     env: dict | None = None) -> None:
        self.start("master", "master", "-port", str(self.master_port),
                   "-volumeSizeLimitMB", str(limit_mb),
                   "-maintenanceInterval", "0", "-metricsPort",
                   str(self.master_metrics), *flags, env=env)

    def start_volume(self, name: str, rack: str, directory: str,
                     *flags: str, mserver: str = "",
                     env: dict | None = None) -> None:
        port, metrics_port = self.free_port(), self.free_port()
        self.nodes[name] = {"port": port, "metrics": metrics_port,
                            "dir": directory, "url": f"127.0.0.1:{port}"}
        argv = ["volume", "-dir", directory, "-mserver",
                mserver or f"127.0.0.1:{self.master_port}", "-port", str(port),
                "-rack", rack, "-max", "40", "-metricsPort",
                str(metrics_port), *flags]
        if self.codec != "cuda" and "-ec.codec" not in flags:
            argv += ["-ec.codec", self.codec]  # cuda: the servers' default
        self.start(name, *argv, env=env)

    def http_json(self, path: str, port: int | None = None) -> dict:
        import urllib.request

        with urllib.request.urlopen(
                f"http://127.0.0.1:{port or self.master_port}{path}",
                timeout=60) as r:
            return json.loads(r.read())

    def wait_for(self, what: str, cond, timeout: float) -> float:
        """Poll `cond` until true; -> seconds waited.  A process that died
        meanwhile fails the wait at once."""
        t0 = time.perf_counter()
        while True:
            try:
                if cond():
                    return time.perf_counter() - t0
            except Exception:  # noqa: BLE001 — not up yet
                pass
            for name, p in self.procs.items():
                if p.poll() is not None and name not in self.killed:
                    raise AssertionError(f"{name} exited {p.returncode} "
                                         f"while waiting for {what}")
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"{what}: not within {timeout} s")
            time.sleep(0.1)

    def shell(self, command: str) -> tuple[float, str]:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell",
             "-master", f"127.0.0.1:{self.master_port}", "-c", command],
            cwd=self.work, env=self.env, capture_output=True, text=True,
            timeout=1800)
        wall = time.perf_counter() - t0
        with open(os.path.join(self.work, "shell.log"), "a") as f:
            f.write(f"$ shell -c {command!r}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            raise AssertionError(f"shell -c {command!r} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        return wall, proc.stdout

    def scrape(self, name: str) -> dict[str, float]:
        """The server's /metrics samples of the codec, service, launch and
        partial-sum families, as {"name{labels}": value}."""
        return self.scrape_port(self.nodes[name]["metrics"], _CODEC_FAMILIES
                                + (_LAUNCH_FAMILY, _SERVICE_FAMILY,
                                   _PARTIAL_FAMILY, _PARTIAL_FALLBACK_FAMILY,
                                   _PARTIAL_BYTES_FAMILY,
                                   _REBUILD_BYTES_FAMILY))

    def scrape_master(self) -> dict[str, float]:
        """The master's maintenance-plane samples."""
        return self.scrape_port(self.master_metrics, _MASTER_FAMILIES)

    @staticmethod
    def scrape_port(port: int, prefixes: tuple) -> dict[str, float]:
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=60) as r:
            text = r.read().decode()
        out = {}
        for line in text.splitlines():
            if line.startswith(prefixes):
                key, _, value = line.rpartition(" ")
                out[key] = float(value)
        return out

    def ec_shards(self, vid: int) -> dict[int, list[str]]:
        """The master's LookupEcVolume: shard id -> holder urls."""
        from seaweedfs_tpu_torch.pb import master_pb2
        from seaweedfs_tpu_torch.pb import rpc as rpclib

        stub = rpclib.master_stub(f"127.0.0.1:{self.master_port + 10000}",
                                  timeout=30)
        resp = stub.LookupEcVolume(master_pb2.LookupEcVolumeRequest(
            volume_id=vid))
        return {e.shard_id: sorted(loc.url for loc in e.locations)
                for e in resp.shard_id_locations}

    def terminate(self, names) -> dict:
        """SIGTERM each process in turn: it must exit 0 within
        CLUSTER_STOP_S with no traceback in its log after the signal."""
        exits = {}
        for name in names:
            p = self.procs[name]
            mark = os.path.getsize(self.logs[name])
            t0 = time.perf_counter()
            p.send_signal(signal.SIGTERM)
            try:
                rc = p.wait(timeout=CLUSTER_STOP_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name} still running "
                                     f"{CLUSTER_STOP_S} s after SIGTERM")
            with open(self.logs[name], "rb") as f:
                text = f.read().decode(errors="replace")
            after_term = text[mark:]
            if rc != 0 or "Traceback" in after_term:
                raise AssertionError(f"{name} exited {rc} after SIGTERM: "
                                     f"{after_term[-2000:]}")
            exits[name] = {"rc": rc, "seconds": time.perf_counter() - t0,
                           "tracebacks_in_log": text.count("Traceback")}
            if "Traceback" in text:  # before the signal: shown, not failed
                at = text.index("Traceback")
                exits[name]["first_traceback"] = text[at:at + 1500]
        return exits

    def tails(self) -> str:
        out = []
        for name, log in self.logs.items():
            with open(log, "rb") as f:
                f.seek(max(0, os.path.getsize(log) - 4000))
                out.append(f"--- {name} ({log}) ---\n"
                           + f.read().decode(errors="replace"))
        return "\n".join(out)

    def stop_all(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _moved(before: dict, after: dict, family: str = "",
           **labels) -> float:
    """The sum of the samples of `family` whose labels include `labels`
    that moved between two scrapes."""
    total = 0.0
    for key, value in after.items():
        if family and not key.startswith(family + "{"):
            continue
        if all(f'{k}="{v}"' in key for k, v in labels.items()):
            total += value - before.get(key, 0.0)
    return total


def _codec_ops(before: dict, after: dict, impl: str) -> dict:
    """Codec op counts that moved, by op, for one impl; the rebuilds timed
    on that impl as op "rebuild"."""
    out = {}
    for key, value in after.items():
        if f'impl="{impl}"' not in key or value <= before.get(key, 0):
            continue
        if key.startswith("seaweedfs_ec_op_seconds_count{"):
            op = key.split('op="', 1)[1].split('"', 1)[0]
        elif key.startswith("seaweedfs_ec_rebuild_seconds_count{"):
            op = "rebuild"
        else:
            continue
        out[op] = out.get(op, 0) + value - before.get(key, 0.0)
    return out


def _launches_moved(before: dict, after: dict) -> dict:
    return {k: int(_moved(before, after, _LAUNCH_FAMILY, kernel=k))
            for k in ("gf_matmul", "gf_matmul_batched")}


def _cluster_get_pass(name: str, master: "_Cluster", vid: int, keys: list,
                      records: dict, holders: "set[str] | None" = None
                      ) -> dict:
    """Every key GET by EC_READ_THREADS threads from the volume's holders
    as the master's /dir/lookup lists them (one lookup, cached, as a
    client's vid map does), each body held against its .dat record.
    `holders`: the URLs the lookup must list before the pass starts; it
    is polled until it does (a node whose heartbeat the master missed
    under load comes back within a few pulses), for at most
    CLUSTER_LIVENESS_S, then the pass fails naming what it listed."""
    def lookup() -> list[str]:
        return [loc["url"] for loc in master.http_json(
            f"/dir/lookup?volumeId={vid}")["locations"]]
    t0 = time.perf_counter()
    locs = lookup()
    while holders is not None and not holders <= set(locs):
        if time.perf_counter() - t0 > CLUSTER_LIVENESS_S:
            raise AssertionError(
                f"{name} GETs: /dir/lookup?volumeId={vid} lists {locs}, "
                f"not every holder of {sorted(holders)}, after "
                f"{CLUSTER_LIVENESS_S} s")
        time.sleep(0.5)
        locs = lookup()
    lookup_wait_s = time.perf_counter() - t0
    clients = {u: _KeepAlive(int(u.rsplit(":", 1)[1])) for u in locs}

    def get(i_key) -> float:
        i, key = i_key
        r = records[key]
        url = locs[i % len(locs)]
        t0 = time.perf_counter()
        status, headers, body = clients[url].request(
            "GET", "/" + _fid(vid, key, r["cookie"]))
        dt = time.perf_counter() - t0
        if status != 200 or hashlib.sha256(body).hexdigest() \
                != r["data_sha256"]:
            raise AssertionError(f"GET of needle {key:x} from {url}: "
                                 f"{status}, body differs from its record")
        return dt

    t0 = time.perf_counter()
    with ThreadPoolExecutor(EC_READ_THREADS) as pool:
        lat = list(pool.map(get, enumerate(keys)))
    return _latency_row(name, lat, time.perf_counter() - t0,
                        bytes=sum(records[k]["size"] for k in keys),
                        holders=locs, lookup_wait_s=lookup_wait_s,
                        byte_equal=True)


def _cluster_writes(master: "_Cluster", total: int, seed: int) -> dict:
    """Step 1: seeded needles of 1 B..256 KiB, `total` bytes, each by
    /dir/assign?replication=001, a POST to the assigned server (which
    fans it out to its replica) and a read back through /dir/lookup."""
    import urllib.request

    rng = np.random.default_rng(seed + 60)
    payloads, size = [], 0
    while size < total:
        p = rng.integers(0, 256, int(rng.integers(1, NEEDLE_MAX_DATA + 1)),
                         dtype=np.uint8).tobytes()
        payloads.append(p)
        size += len(p)
    mport = master.master_port
    assign_lat, write_lat = [], []

    def write(payload: bytes) -> str:
        t0 = time.perf_counter()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/dir/assign?replication=001",
                timeout=60) as r:
            a = json.loads(r.read())
        t1 = time.perf_counter()
        req = urllib.request.Request(f"http://{a['url']}/{a['fid']}",
                                     data=payload, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            if r.status != 201:
                raise AssertionError(f"POST {a['fid']}: {r.status}")
        t2 = time.perf_counter()
        assign_lat.append(t1 - t0)
        write_lat.append(t2 - t0)
        vid = a["fid"].split(",")[0]
        locs = master.http_json(f"/dir/lookup?volumeId={vid}")["locations"]
        if len(locs) != 2:
            raise AssertionError(f"volume {vid}: {len(locs)} replicas, "
                                 "replication 001 wants 2")
        for loc in locs:
            with urllib.request.urlopen(
                    f"http://{loc['url']}/{a['fid']}", timeout=60) as r:
                if r.read() != payload:
                    raise AssertionError(f"{a['fid']} from {loc['url']} "
                                         "differs from what was written")
        return vid

    t0 = time.perf_counter()
    with ThreadPoolExecutor(EC_READ_THREADS) as pool:
        vids = sorted(set(pool.map(write, payloads)))
    wall = time.perf_counter() - t0
    lat = np.asarray(write_lat)
    return {"needles": len(payloads), "bytes": size, "threads":
            EC_READ_THREADS, "wall_s": wall, "volumes": vids,
            "assigns_per_s": len(payloads) / wall,
            "write_GBps": size / wall / 1e9,
            "assign_p50_ms": float(np.percentile(assign_lat, 50)) * 1e3,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "readback_equal": True}


def phase_cluster(rs_cuda, gf256, work: str, size: int, seed: int,
                  power: str, reduced: list[str], codec: str = "cuda",
                  device: str = "cuda", free_port=free_port_pair,
                  write_bytes: int = CLUSTER_WRITE_BYTES) -> dict:
    """The system as its operators start it: `python -m seaweedfs_tpu_torch
    master` (its dead-node mass repair off, SEAWEEDFS_TPU_MASS_REPAIR=0:
    the subject here is the shell's rebuild), three `volume` processes on
    their default codec (`cuda`; `codec` other than cuda is passed as
    -ec.codec) and `shell -c` for each admin command.  A (rack1, alone in
    its rack) holds a sealed
    volume of `size` bytes of real needle records made before it starts;
    B and C share rack0.  Steps, each on its own line: (0) start, every
    node and the volume listed by /dir/status; (1) replicated writes
    through assigns; (2) `ec.encode -volumeId=1` from the shell: 14 shards
    over the 3 nodes as balanced_ec_distribution plans them, every
    slice's parity equal to the plain version, the card's counts moved on
    the servers; (3) healthy GETs of 4096 keys through the master's
    lookup, bodies equal to the .dat records; (4) C SIGKILLed, the master
    drops it, the same GETs degraded on A and B; (5) `ec.rebuild -force`:
    C's shards rebuilt equal by sha256; (6) `ec.decode -volumeId=1`: the
    .dat equal by sha256 and served; (7) SIGTERM: each process exits
    within 30 s with no traceback after it.  Each step's launch and op
    counts are the servers' own, read from /metrics just before and just
    after it.  -> launches by kernel and step, and the rows."""
    from seaweedfs_tpu_torch.pb import master_pb2
    from seaweedfs_tpu_torch.pb import rpc as rpclib
    from seaweedfs_tpu_torch.shell.ec_commands import (_free_ec_slots,
                                                       _iter_nodes)
    from seaweedfs_tpu_torch.topology.placement import \
        balanced_ec_distribution

    t_phase = time.perf_counter()
    dirs = {n: os.path.join(work, n) for n in ("a", "b", "c")}
    for d in dirs.values():
        os.makedirs(d)
    base = os.path.join(dirs["a"], "1")
    t0 = time.perf_counter()
    needles = make_volume(base, size, seed, device)
    make_s = time.perf_counter() - t0
    dat_size, records = _needle_records(base, seed)
    dat_sha = sha256_of(base + ".dat")
    keys = sorted(records)
    cl = _Cluster(work, codec, free_port)
    rows: dict[str, dict] = {}
    paths: dict[str, dict] = {"gf_matmul": {}, "gf_matmul_batched": {}}

    def step(name: str, row: dict) -> None:
        row = {"phase": f"cluster_{name}", **row, "nvidia_smi": power}
        emit(row)
        rows[name] = row

    def scrape_all(names=("a", "b", "c")) -> dict:
        return {n: cl.scrape(n) for n in names if n not in cl.killed}

    def counted(name: str, before: dict, after: dict) -> dict:
        """Per server: the launches, the codec ops on the servers' codec
        and the host codec's apply_rows that moved in one step."""
        out = {}
        for n in after:
            launches = _launches_moved(before[n], after[n])
            for k, v in launches.items():
                if v:
                    paths[k][f"cluster_{name}_{n}"] = v
            out[n] = {"launches": launches,
                      "ops": _codec_ops(before[n], after[n], codec),
                      "service_jobs": _moved(before[n], after[n],
                                             _SERVICE_FAMILY),
                      "partial_fetches": _moved(before[n], after[n],
                                                _PARTIAL_FAMILY,
                                                kind="fetch", result="ok"),
                      "partial_serves": _moved(before[n], after[n],
                                               _PARTIAL_FAMILY,
                                               kind="serve", result="ok"),
                      "partial_fallbacks": _moved(
                          before[n], after[n], _PARTIAL_FALLBACK_FAMILY),
                      "host_apply_rows": _moved(
                          before[n], after[n],
                          "seaweedfs_ec_op_seconds_count",
                          op="apply_rows", impl="cpu")}
        return out

    def check_route(what: str, counts: dict, servers,
                    ops: bool = False) -> None:
        """The servers' codec did the work on `servers`: on the card the
        kernels launched there (the wrappers' own counts); with `ops`, the
        codec's instrumented ops moved too (the direct encode route calls
        none of them).  The host codec's apply_rows moved on none of them
        (unless the servers' codec is the host's)."""
        for n in servers:
            c = counts[n]
            if codec == "cuda" and not sum(c["launches"].values()):
                raise AssertionError(f"{what}: no kernel launched on {n}: "
                                     f"{c}")
            if ops and not c["ops"]:
                raise AssertionError(f"{what}: no {codec} codec op moved "
                                     f"on {n}: {c}")
            if codec != "cpu" and c["host_apply_rows"]:
                raise AssertionError(f"{what}: the host codec's "
                                     f"apply_rows moved on {n}: {c}")

    try:
        # 0. start: the master, then A (rack1), then B and C (rack0), each
        # registered before the next starts, so the topology lists them in
        # that order.  The master's dead-node mass repair (on by default)
        # is switched off: this phase's subject is the shell's ec.rebuild
        cl.start_master(env={"SEAWEEDFS_TPU_MASS_REPAIR": "0"})
        cl.wait_for("the master's /dir/status",
                    lambda: cl.http_json("/dir/status") is not None,
                    CLUSTER_START_S)
        t0 = time.perf_counter()
        for name, rack in (("a", "rack1"), ("b", "rack0"), ("c", "rack0")):
            cl.start_volume(name, rack, dirs[name])
            url = cl.nodes[name]["url"]
            cl.wait_for(f"{name} registered", lambda u=url: u in cl.http_json(
                "/dir/status")["DataNodes"], CLUSTER_START_S)
        a_url, b_url, c_url = (cl.nodes[n]["url"] for n in "abc")
        cl.wait_for("volume 1 listed", lambda: 1 in cl.http_json(
            "/dir/status")["DataNodes"][a_url]["volumes"], CLUSTER_START_S)
        for n in "abc":
            cl.wait_for(f"{n}'s /metrics", lambda n=n: cl.scrape(n) is not None,
                        CLUSTER_START_S)
        step("start", {"codec": codec, "start_s": time.perf_counter() - t0,
                       "make_volume_s": make_s, "volume_bytes": dat_size,
                       "needles": needles, "nodes": 3,
                       "reduced": reduced})

        # 1. replicated writes
        before = scrape_all()
        w = _cluster_writes(cl, write_bytes, seed)
        # the heartbeats carry the grown volumes to the topology, which the
        # shell's spread plan reads: wait for both replicas of each
        cl.wait_for("the written volumes in the topology", lambda: all(
            sum(int(v) in n["volumes"] for n in cl.http_json(
                "/dir/status")["DataNodes"].values()) == 2
            for v in w["volumes"]), CLUSTER_START_S)
        step("writes", {**w, "counts": counted("writes", before,
                                               scrape_all())})

        # 2. ec.encode from the shell
        stub = rpclib.master_stub(f"127.0.0.1:{cl.master_port + 10000}",
                                  timeout=60)
        topo = stub.VolumeList(master_pb2.VolumeListRequest()).topology_info
        free = {dn.id: _free_ec_slots(dn) for _dc, _r, dn in _iter_nodes(topo)}
        free[a_url] = max(free.get(a_url, 0), 1)
        plan = balanced_ec_distribution(free, 14)
        before = scrape_all()
        wall, out = cl.shell("ec.encode -volumeId=1")
        cl.wait_for("14 shards at the master", lambda: len(
            cl.ec_shards(1)) == 14, CLUSTER_START_S)
        after = scrape_all()
        counts = counted("encode", before, after)
        spread = {}
        for sid, holders in cl.ec_shards(1).items():
            for u in holders:
                spread.setdefault(u, []).append(sid)
        spread = {u: sorted(s) for u, s in spread.items()}
        if spread != {u: sorted(s) for u, s in plan.items()} \
                or len(spread) != 3:
            raise AssertionError(f"spread {spread} is not the plan {plan} "
                                 "over 3 nodes")
        if os.path.exists(base + ".dat"):
            raise AssertionError("the source .dat survived ec.encode")
        check_route("ec.encode", counts, ["a"])
        by_url = {cl.nodes[n]["url"]: n for n in "abc"}
        shard_path = {sid: os.path.join(dirs[by_url[u[0]]], f"1.ec{sid:02d}")
                      for sid, u in cl.ec_shards(1).items()}
        links = os.path.join(work, "parity_view")
        os.makedirs(links)
        for sid, p in shard_path.items():
            os.symlink(p, os.path.join(links, f"1.ec{sid:02d}"))
        from seaweedfs_tpu_torch.storage.ec import encoder as enc

        checked = check_parity(os.path.join(links, "1"), rs_cuda, gf256,
                               enc.DEFAULT_SLICE, device=device)
        shard_size = os.path.getsize(shard_path[0])
        step("encode", {"seconds": wall, "GBps": dat_size / wall / 1e9,
                        "shell_output": out.strip()[-400:],
                        "spread": {by_url[u]: s for u, s in spread.items()},
                        "plan_equal": True, "parity_slices_checked":
                        checked, "shard_bytes": shard_size,
                        "counts": counts})

        # 3. healthy GETs through the master's lookup, once it lists all
        # three holders: a pass through A alone (the master missed B's
        # and C's pulses) would leave every needle in A's needle cache,
        # and A would decode nothing after C dies
        before = scrape_all()
        healthy = _cluster_get_pass("healthy", cl, 1, keys, records,
                                    holders={a_url, b_url, c_url})
        step("healthy_gets", {**healthy, "counts": counted(
            "healthy_gets", before, scrape_all())})

        # 4. C dies; the master drops it; the same GETs, degraded
        c_shards = sorted(s for s, u in cl.ec_shards(1).items()
                          if c_url in u)
        c_sha = dict(zip(c_shards, _parallel_sha256(
            [shard_path[s] for s in c_shards])))
        before = scrape_all(("a", "b"))
        cl.killed.add("c")
        cl.procs["c"].kill()
        cl.procs["c"].wait()
        dropped_s = cl.wait_for("the master drops C", lambda: all(
            c_url not in u for u in cl.ec_shards(1).values()),
            CLUSTER_LIVENESS_S)
        # the pass starts once the lookup lists both survivors (ROADMAP
        # C-2: under load the master can miss a live node's pulses)
        degraded = _cluster_get_pass("degraded", cl, 1, keys, records,
                                     holders={a_url, b_url})
        counts = counted("degraded_gets", before, scrape_all(("a", "b")))
        # each survivor decoded what it was asked for: on its codec (the
        # kernel, on the card) or by partial sums from its peer
        for n in ("a", "b"):
            c = counts[n]
            if not (sum(c["launches"].values()) or c["ops"]
                    or c["partial_fetches"]):
                raise AssertionError(
                    f"degraded GETs: {n} decoded nothing; /dir/lookup "
                    f"listed {degraded['holders']} (A {a_url}, B {b_url}) "
                    f"after {degraded['lookup_wait_s']:.2f} s; counts "
                    f"{counts}")
        step("degraded_gets", {**degraded, "lost_shards": c_shards,
                               "master_dropped_c_s": dropped_s,
                               "counts": counts})

        # 5. ec.rebuild -force restores C's shards on A or B
        before = scrape_all(("a", "b"))
        wall, out = cl.shell("ec.rebuild -force")
        cl.wait_for("14 shards on A and B", lambda: len(cl.ec_shards(1)) == 14
                    and all(c_url not in u for u in cl.ec_shards(1).values()),
                    CLUSTER_START_S)
        counts = counted("rebuild", before, scrape_all(("a", "b")))
        rebuilt = {}
        for sid, holders in cl.ec_shards(1).items():
            if sid in c_sha:
                rebuilt[sid] = os.path.join(dirs[by_url[holders[0]]],
                                            f"1.ec{sid:02d}")
        got = dict(zip(rebuilt, _parallel_sha256(list(rebuilt.values()))))
        if got != c_sha:
            raise AssertionError("rebuilt shards differ from C's")
        rebuilders = sorted({by_url[u[0]] for s, u in cl.ec_shards(1).items()
                             if s in c_sha})
        check_route("ec.rebuild", counts, rebuilders, ops=True)
        step("rebuild", {"seconds": wall,
                         "GBps_read": 10 * shard_size / wall / 1e9,
                         "rebuilt": c_shards, "on": rebuilders,
                         "sha256_equal": True,
                         "shell_output": out.strip()[-400:],
                         "counts": counts})

        # 6. ec.decode back to a volume
        before = scrape_all(("a", "b"))
        wall, out = cl.shell("ec.decode -volumeId=1")
        holder = next(n for n in "ab"
                      if os.path.exists(os.path.join(dirs[n], "1.dat")))
        decoded_sha = sha256_of(os.path.join(dirs[holder], "1.dat"))
        if decoded_sha != dat_sha:
            raise AssertionError("the decoded .dat differs from the original")
        cl.wait_for("volume 1 back at the master", lambda: 1 in cl.http_json(
            "/dir/status")["DataNodes"][cl.nodes[holder]["url"]]["volumes"],
            CLUSTER_START_S)
        sample = keys[::max(1, len(keys) // CLUSTER_DECODE_SAMPLE)][
            :CLUSTER_DECODE_SAMPLE]
        served = _cluster_get_pass("decoded", cl, 1, sample, records)
        step("decode", {"seconds": wall, "GBps": dat_size / wall / 1e9,
                        "on": holder, "dat_sha256_equal": True,
                        "gets": served, "shell_output": out.strip()[-400:],
                        "counts": counted("decode", before,
                                          scrape_all(("a", "b")))})

        # 7. SIGTERM: clean exits
        step("stop", {"exits": cl.terminate(("a", "b", "master"))})
    except BaseException:
        print(cl.tails(), file=sys.stderr, flush=True)
        raise
    finally:
        cl.stop_all()
    summary = {"phase": "cluster_summary",
               "wall_s": time.perf_counter() - t_phase,
               "launches_by_path": paths, "nvidia_smi": power}
    emit(summary)
    return {"launches_by_path": paths, "rows": rows}


# -- phase 4g: maintenance ----------------------------------------------------

MAINT_NODES = (("a", "rack0"), ("b", "rack0"), ("c", "rack1"), ("d", "rack1"))
MAINT_VOLUMES_PER_NODE = 2  # made before the processes start
MAINT_VOLUME_BYTES = GIB // 2  # each; the master's limit is the same size
MAINT_COOLDOWN_S = 5
MAINT_POLICY = {"*": {"ec_cooldown_seconds": MAINT_COOLDOWN_S}}
# a lifecycle cycle longer than a volume server's full-beat period (3 s,
# checked each 1 s): the seals of one cycle are all seen by the next
MAINT_INTERVAL_S = 6
# The controller runs one job per node (the reference's only value), so a
# node's two encodes run in turn, and a later encode plans its spread from
# a snapshot holding the earlier ones' shards and freed slots: the free-slot
# planner then stacks 5 of its shards on one node (ROADMAP C-1).  The
# phase makes that deterministic: each node's first volume cools at
# MAINT_WAVE1_S from the start (every node registered and every volume
# sealed by then), its second MAINT_WAVE_GAP_S later, so the 4 first
# encodes plan from one snapshot (4/4/3/3, the first two nodes in topology
# order taking 4) and the 4 second ones from the next, after the first
# wave's sources dropped (2/2/5/5).  D registers first, so rack1 leads the
# topology order: D and C take 4 and 2, A and B 3 and 5.  Every node must
# have registered two lifecycle cycles before the first wave cools: D's
# start, then A's, B's and C's together, took 19-22 s on a quiet host and
# 33 s on a loaded one, so the first wave cools at 60 s (48 s to register).
MAINT_WAVE1_S = 60.0
MAINT_WAVE_GAP_S = 10.0
MAINT_ENCODE_S = 900.0  # every volume sealed, encoded, its source dropped
MAINT_REPAIR_S = 900.0  # every lost shard rebuilt and mounted


def _ec_spread(cl: "_Cluster") -> dict[int, dict[str, list[int]]]:
    """The master's /dir/status: volume id -> node url -> shard ids."""
    out: dict[int, dict[str, list[int]]] = {}
    for url, node in cl.http_json("/dir/status")["DataNodes"].items():
        for vid, sids in node["ecShards"].items():
            out.setdefault(int(vid), {})[url] = sorted(sids)
    return out


def _maintenance_get_pass(cl: "_Cluster", records: dict) -> dict:
    """Every sampled key of every volume GET by EC_READ_THREADS threads
    from the volume's holders as the master's /dir/lookup lists them (one
    lookup per volume, cached), each body held against its .dat record."""
    t_start = time.perf_counter()
    locs = {vid: [loc["url"] for loc in cl.http_json(
        f"/dir/lookup?volumeId={vid}")["locations"]] for vid in records}
    clients = {u: _KeepAlive(int(u.rsplit(":", 1)[1]))
               for urls in locs.values() for u in urls}
    work = [(vid, key) for vid in sorted(records)
            for key in sorted(records[vid])]

    def get(i_item) -> float:
        i, (vid, key) = i_item
        r = records[vid][key]
        url = locs[vid][i % len(locs[vid])]
        t0 = time.perf_counter()
        status, _headers, body = clients[url].request(
            "GET", "/" + _fid(vid, key, r["cookie"]))
        dt = time.perf_counter() - t0
        if status != 200 or hashlib.sha256(body).hexdigest() \
                != r["data_sha256"]:
            raise AssertionError(f"GET of {vid},{key:x} from {url}: "
                                 f"{status}, body differs from its record")
        return dt

    with ThreadPoolExecutor(EC_READ_THREADS) as pool:
        lat = list(pool.map(get, enumerate(work)))
    return _latency_row(
        "during_repair", lat, time.perf_counter() - t_start,
        bytes=sum(records[v][k]["size"] for v, k in work),
        volumes=len(records), byte_equal=True, t_start=t_start,
        t_end=time.perf_counter())


def _shell_counts(out: str, label: str) -> dict:
    """The `{label}{...}` dict a volume.lifecycle / volume.repair status
    prints on its own line."""
    import ast

    for line in out.splitlines():
        if label in line:
            return ast.literal_eval(line.split(label, 1)[1].strip())
    raise AssertionError(f"no {label!r} line in: {out[-1000:]}")


def phase_maintenance(rs_cuda, gf256, work: str, size: int, seed: int,
                      power: str, reduced: list[str], codec: str = "cuda",
                      device: str = "cuda", free_port=free_port_pair,
                      gets: int = EC_READ_SAMPLE) -> dict:
    """The master's maintenance plane with no operator command: a master
    (`-volumeSizeLimitMB` the volumes' size, `-lifecycleInterval`
    MAINT_INTERVAL_S, `-lifecyclePolicy` {"*": {"ec_cooldown_seconds":
    5}}, the controller's and mass repair's defaults otherwise) and four
    `volume` processes on their default codec (`cuda`; `codec` other than
    cuda is passed as -ec.codec), A and B in rack0, C and D in rack1, each
    `-max 40` holding two volumes of `size` bytes of real needle records
    made before it starts.  The master and D start first, A, B and C once
    D has registered; each node's volumes are stamped last written so
    that they cool in two waves (MAINT_WAVE1_S, MAINT_WAVE_GAP_S).
    Steps, each on its own line: (0) start; (1) the controller seals and
    EC-encodes all 8 volumes: 8 ec_encode jobs done (each job's seconds
    and transitions) in two waves of one cycle each, 14 shards of each
    mounted across the 4 nodes, D holding at most 4 of any volume (the
    nodes holding 5, whose death would be a loss, printed), every slice's
    parity equal to the plain version, each source .dat dropped, the
    batched kernel's launches moved on every generating node and the host
    codec's apply_rows on none; (2) D's shards hashed, D SIGKILLed:
    the seconds until the master drops it, until `shell -c volume.repair`
    (a process) lists every affected volume planned, and until every
    volume has 14 shards mounted again (the time to recover); (3) from
    the moment the master drops D, `gets` GETs of seeded needles across
    the 8 volumes through the master's lookup, every body equal to its
    .dat record; (4) the rebuilt shards equal D's by sha256, the repair's
    rate, each survivor's launches and host apply_rows, the bytes the
    survivors took in from peers (partial sums, and full fetches where a
    target chose them; the concurrent GETs' partial sums included)
    against a full fetch of every target's remote sources, the master's
    seaweedfs_repair_batch_*
    counters, and `volume.lifecycle` / `volume.repair` showing every
    ec_encode and mass_repair job done, none failed or parked; (5)
    SIGTERM: each process exits 0 within 30 s with no traceback after it.
    Counts are read just before and just after each step.  -> launches
    by kernel and step, and the rows."""
    import re
    import threading

    t_phase = time.perf_counter()
    names = [n for n, _r in MAINT_NODES]
    dirs = {n: os.path.join(work, n) for n in names}
    records: dict[int, dict] = {}
    t0 = time.perf_counter()
    needles = 0
    for n in names:
        os.makedirs(dirs[n])
        for _ in range(MAINT_VOLUMES_PER_NODE):
            vid = len(records) + 1
            base = os.path.join(dirs[n], str(vid))
            needles += make_volume(base, size, seed + vid, device)
            _size, records[vid] = _needle_records(
                base, seed + vid,
                sample=gets // (len(names) * MAINT_VOLUMES_PER_NODE))
    make_s = time.perf_counter() - t0
    vids = sorted(records)
    policy = os.path.join(work, "policy.json")
    with open(policy, "w") as f:
        json.dump(MAINT_POLICY, f)
    cl = _Cluster(work, codec, free_port)
    rows: dict[str, dict] = {}
    paths: dict[str, dict] = {"gf_matmul": {}, "gf_matmul_batched": {}}

    def step(name: str, row: dict) -> None:
        row = {"phase": f"maintenance_{name}", **row, "nvidia_smi": power}
        emit(row)
        rows[name] = row

    def scrape_all() -> dict:
        return {n: cl.scrape(n) for n in names if n not in cl.killed}

    def counted(name: str, before: dict, after: dict) -> dict:
        """Per server: the launches, the host codec's apply_rows, the
        codec service's jobs and the partial-sum traffic that moved."""
        out = {}
        for n in after:
            launches = _launches_moved(before[n], after[n])
            for k, v in launches.items():
                if v:
                    paths[k][f"maintenance_{name}_{n}"] = v
            out[n] = {"launches": launches,
                      "host_apply_rows": _moved(
                          before[n], after[n],
                          "seaweedfs_ec_op_seconds_count",
                          op="apply_rows", impl="cpu"),
                      "service_jobs": _moved(before[n], after[n],
                                             _SERVICE_FAMILY),
                      "partial_bytes_in": _moved(before[n], after[n],
                                                 _PARTIAL_BYTES_FAMILY,
                                                 op="recv"),
                      "remote_bytes_in": _moved(
                          before[n], after[n], _REBUILD_BYTES_FAMILY)
                      - _moved(before[n], after[n], _REBUILD_BYTES_FAMILY,
                               source="local"),
                      "partial_bytes_served": _moved(
                          before[n], after[n], _PARTIAL_BYTES_FAMILY,
                          op="serve")}
        return out

    # each node's i-th volume cools at MAINT_WAVE1_S + i * MAINT_WAVE_GAP_S
    # from here: its .dat's mtime is the write time the server reports
    t_stamp = time.time()
    waves: list[list[int]] = [[], []]
    for i, n in enumerate(names):
        for w in range(MAINT_VOLUMES_PER_NODE):
            vid = i * MAINT_VOLUMES_PER_NODE + w + 1
            waves[w].append(vid)
            at = t_stamp + MAINT_WAVE1_S + w * MAINT_WAVE_GAP_S \
                - MAINT_COOLDOWN_S
            os.utime(os.path.join(dirs[n], f"{vid}.dat"), (at, at))

    def registered(ns) -> bool:
        return set(cl.http_json("/dir/status")["DataNodes"]) >= {
            cl.nodes[n]["url"] for n in ns}

    try:
        # 0. start: the master and D, then A, B and C once D registered
        t0 = time.perf_counter()
        cl.start_master("-lifecycleInterval", str(MAINT_INTERVAL_S),
                        "-lifecyclePolicy", policy, limit_mb=size // MIB)
        t_master = time.perf_counter()
        first, rest = MAINT_NODES[-1], MAINT_NODES[:-1]
        cl.start_volume(first[0], first[1], dirs[first[0]])
        cl.wait_for("D registered", lambda: registered([first[0]]),
                    CLUSTER_START_S)
        for n, rack in rest:
            cl.start_volume(n, rack, dirs[n])
        cl.wait_for("every node registered", lambda: registered(names),
                    CLUSTER_START_S)
        for n in names:
            cl.wait_for(f"{n}'s /metrics", lambda n=n: cl.scrape(n)
                        is not None, CLUSTER_START_S)
        before = scrape_all()
        registered_s = time.time() - t_stamp
        if registered_s > MAINT_WAVE1_S - 2 * MAINT_INTERVAL_S:
            raise AssertionError(
                f"every node registered {registered_s} s after the stamp: "
                f"too late to seal every volume before the first wave "
                f"cools at {MAINT_WAVE1_S} s")
        by_url = {cl.nodes[n]["url"]: n for n in names}
        # the planner's node order: racks in order of first registration,
        # then each rack's nodes in theirs (TopologyInfo's walk)
        joined = [by_url[u] for u in cl.http_json("/dir/status")[
            "DataNodes"]]
        rack_of = dict(MAINT_NODES)
        racks = list(dict.fromkeys(rack_of[n] for n in joined))
        order = [n for r in racks for n in joined if rack_of[n] == r]
        step("start", {"codec": codec, "start_s": time.perf_counter() - t0,
                       "registered_s": registered_s,
                       "topology_order": order,
                       "make_volumes_s": make_s, "volumes": len(vids),
                       "volume_bytes": size, "needles": needles,
                       "nodes": len(names), "reduced": reduced})

        # 1. the controller seals and encodes every volume
        failed: list = []

        def encoded() -> bool:
            jobs = cl.http_json("/cluster/lifecycle")["jobs"]
            failed[:] = [j for j in jobs
                         if j["state"] in ("failed", "parked")]
            done = [j for j in jobs if j["transition"] == "ec_encode"
                    and j["state"] == "done"]
            return bool(failed) or len(done) == len(vids)

        cl.wait_for("every ec_encode job done", encoded, MAINT_ENCODE_S)
        if failed:
            raise AssertionError(f"lifecycle jobs failed: {failed}")
        cl.wait_for("every source .dat dropped", lambda: not any(
            os.path.exists(os.path.join(dirs[n], f"{v}.dat"))
            for n in names for v in vids), CLUSTER_START_S)
        cl.wait_for("14 shards of every volume at the master", lambda: all(
            sum(map(len, sp.values())) == 14 and len(sp) == len(names)
            for sp in (_ec_spread(cl).get(v, {}) for v in vids)),
            CLUSTER_START_S)
        encode_s = time.perf_counter() - t_master
        after = scrape_all()
        counts = counted("encode", before, after)
        spread = _ec_spread(cl)
        for v in vids:
            if sorted(s for sids in spread[v].values() for s in sids) \
                    != list(range(14)):
                raise AssertionError(f"volume {v}: shards {spread[v]}")
        worst = max(len(spread[v].get(cl.nodes["d"]["url"], []))
                    for v in vids)
        if worst > 4:
            raise AssertionError(f"D holds {worst} shards of a volume: its "
                                 f"death would be a loss ({spread})")
        # the nodes whose death would lose a volume: the planner's stacking
        stacked = {by_url[u]: sorted(v for v in vids
                                     if len(spread[v].get(u, [])) > 4)
                   for u in by_url}
        for n in names:
            c = counts[n]
            if codec == "cuda" and not c["launches"]["gf_matmul_batched"]:
                raise AssertionError(f"encode: no batched launch on {n}: "
                                     f"{c}")
            if codec != "cpu" and c["host_apply_rows"]:
                raise AssertionError(f"encode: the host codec's apply_rows "
                                     f"moved on {n}: {c}")
        from seaweedfs_tpu_torch.storage.ec import encoder as enc

        checked = 0
        for v in vids:
            view = os.path.join(work, f"parity_view_{v}")
            os.makedirs(view)
            for url, sids in spread[v].items():
                for sid in sids:
                    os.symlink(os.path.join(dirs[by_url[url]],
                                            f"{v}.ec{sid:02d}"),
                               os.path.join(view, f"{v}.ec{sid:02d}"))
            checked += check_parity(os.path.join(view, str(v)), rs_cuda,
                                    gf256, enc.DEFAULT_SLICE, device=device)
        shard_size = {v: os.path.getsize(os.path.join(
            work, f"parity_view_{v}", f"{v}.ec00")) for v in vids}
        doc = cl.http_json("/cluster/lifecycle")
        jobs = {}
        created, ended = {}, {}
        for j in doc["jobs"]:
            jobs.setdefault(j["volume_id"], []).append(
                {"transition": j["transition"],
                 "seconds": (j["updated_ms"] - j["created_ms"]) / 1e3})
            if j["transition"] == "ec_encode":
                created[j["volume_id"]] = j["created_ms"]
                ended[j["volume_id"]] = j["updated_ms"]
        # each wave journaled by one cycle, the second after the first ended
        for wave in waves:
            if max(created[v] for v in wave) - min(
                    created[v] for v in wave) > 1000 * MAINT_INTERVAL_S / 2:
                raise AssertionError(f"wave {wave} planned across cycles: "
                                     f"{created}")
        if min(created[v] for v in waves[1]) < max(
                ended[v] for v in waves[0]):
            raise AssertionError(f"the second wave planned before the first "
                                 f"ended: {created} {ended}")
        step("encode", {
            "seconds": encode_s,
            "GBps": size * len(vids) / encode_s / 1e9,
            "jobs": {str(v): jobs[v] for v in vids},
            "spread": {str(v): {by_url[u]: s for u, s in spread[v].items()}
                       for v in vids},
            "waves": waves,
            "wave_s": [(max(ended[v] for v in w) - min(created[v] for v in w))
                       / 1e3 for w in waves],
            "d_max_shards_per_volume": worst,
            "loss_if_dead": {n: v for n, v in stacked.items() if v},
            "parity_slices_checked": checked, "sources_dropped": True,
            "lifecycle_counts": doc["counts"], "counts": counts})

        # 2. D dies; the master repairs with no command
        d_url = cl.nodes["d"]["url"]
        d_keys = [(v, sid) for v in vids for sid in spread[v].get(d_url, [])]
        d_sha = dict(zip(d_keys, _parallel_sha256(
            [os.path.join(dirs["d"], f"{v}.ec{sid:02d}")
             for v, sid in d_keys])))
        affected = sorted({v for v, _sid in d_keys})
        before, master_before = scrape_all(), cl.scrape_master()
        before.pop("d")
        t_kill = time.perf_counter()
        cl.killed.add("d")
        cl.procs["d"].kill()
        cl.procs["d"].wait()
        cl.wait_for("the master drops D", lambda: d_url not in
                    cl.http_json("/dir/status")["DataNodes"],
                    CLUSTER_LIVENESS_S)
        detect_s = time.perf_counter() - t_kill

        # 3. GETs while the repair runs, from the moment D is dropped
        got_reads: dict = {}

        def reads() -> None:
            try:
                got_reads["row"] = _maintenance_get_pass(cl, records)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                got_reads["error"] = e

        reader = threading.Thread(target=reads, name="maintenance-gets")
        reader.start()
        polls = 0
        while True:
            polls += 1
            _wall, out = cl.shell("volume.repair")
            planned = {int(m) for m in re.findall(
                r"^\s+(\d+):mass_repair: ", out, re.M)}
            if planned >= set(affected):
                planned_s = time.perf_counter() - t_kill
                break
            if time.perf_counter() - t_kill > MAINT_REPAIR_S:
                raise AssertionError(f"volume.repair planned {planned} of "
                                     f"{affected}: {out[-2000:]}")

        def repaired() -> bool:
            sp = _ec_spread(cl)
            return all(sum(map(len, sp.get(v, {}).values())) == 14
                       and d_url not in sp.get(v, {}) for v in vids)

        cl.wait_for("every volume back to 14 shards", repaired,
                    MAINT_REPAIR_S)
        recover_s = time.perf_counter() - t_kill
        reader.join()
        if "error" in got_reads:
            raise got_reads["error"]
        read_row = got_reads["row"]
        read_row["started_after_kill_s"] = read_row.pop("t_start") - t_kill
        read_row["ended_after_kill_s"] = read_row.pop("t_end") - t_kill
        read_row["during_repair"] = \
            read_row["started_after_kill_s"] < recover_s
        step("dead_node", {"detect_s": detect_s, "planned_s": planned_s,
                           "volume_repair_polls": polls,
                           "time_to_recover_s": recover_s,
                           "repair_s": recover_s - detect_s,
                           "affected_volumes": affected,
                           "lost_shards": len(d_keys)})
        step("gets_during_repair", read_row)

        # 4. the rebuilt shards, the repair's rate and the plane's books
        after, master_after = scrape_all(), cl.scrape_master()
        counts = counted("repair", before, after)
        spread2 = _ec_spread(cl)
        rebuilt = {}
        for v, sid in d_keys:
            url = next(u for u, sids in spread2[v].items() if sid in sids)
            rebuilt[(v, sid)] = os.path.join(dirs[by_url[url]],
                                             f"{v}.ec{sid:02d}")
        got = dict(zip(rebuilt, _parallel_sha256(list(rebuilt.values()))))
        if got != d_sha:
            bad = [k for k in d_sha if got[k] != d_sha[k]]
            raise AssertionError(f"rebuilt shards differ from D's: {bad}")
        targets = {}
        for (v, _sid), p in rebuilt.items():
            targets[v] = os.path.basename(os.path.dirname(p))
        for n in sorted(set(targets.values())):
            if codec == "cuda" and not counts[n]["launches"][
                    "gf_matmul_batched"]:
                raise AssertionError(f"repair: no batched launch on the "
                                     f"rebuild target {n}: {counts[n]}")
        # a full fetch pulls every source the target does not hold
        full_fetch = sum(
            (10 - len(spread[v].get(cl.nodes[targets[v]]["url"], [])))
            * shard_size[v] for v in affected)
        _w, lc_out = cl.shell("volume.lifecycle")
        _w, mr_out = cl.shell("volume.repair")
        states = _shell_counts(lc_out, "states=")
        mr_counts = _shell_counts(mr_out, "counts:")
        ec_done = len(re.findall(r"^\s+\d+:ec_encode: done", lc_out, re.M))
        mr_done = len(re.findall(r"^\s+\d+:mass_repair: done", mr_out,
                                 re.M))
        if (ec_done != len(vids) or mr_done != len(affected)
                or mr_counts["repaired"] != len(affected)
                or mr_counts["failed"] or mr_counts["parked"]
                or set(states) != {"done"}):
            raise AssertionError(f"lifecycle / repair status:\n{lc_out}\n"
                                 f"{mr_out}")
        read_bytes = 10 * sum(shard_size[v] for v in affected)
        step("repair", {
            "sha256_equal": True, "rebuilt": len(rebuilt),
            "targets": {str(v): t for v, t in sorted(targets.items())},
            "GBps_read": read_bytes / (recover_s - detect_s) / 1e9,
            "lost_bytes": sum(shard_size[v] for v, _s in d_keys),
            "partial_bytes_in": sum(c["partial_bytes_in"]
                                    for c in counts.values()),
            "remote_bytes_in": sum(c["remote_bytes_in"]
                                   for c in counts.values()),
            "full_fetch_bytes": full_fetch,
            "repair_batch": {k: v - master_before.get(k, 0.0)
                             for k, v in master_after.items()
                             if k.startswith("seaweedfs_repair_batch_")
                             and "_bucket{" not in k
                             and v != master_before.get(k, 0.0)},
            "lifecycle_states": states, "mass_repair_counts": mr_counts,
            "ec_encode_done": ec_done, "mass_repair_done": mr_done,
            "counts": counts})

        # 5. SIGTERM: clean exits
        step("stop", {"exits": cl.terminate(("a", "b", "c", "master"))})
    except BaseException:
        print(cl.tails(), file=sys.stderr, flush=True)
        raise
    finally:
        cl.stop_all()
    summary = {"phase": "maintenance_summary",
               "wall_s": time.perf_counter() - t_phase,
               "launches_by_path": paths, "nvidia_smi": power}
    emit(summary)
    return {"launches_by_path": paths, "rows": rows}


# -- phase 4h: tier ----------------------------------------------------------

TIER_NODES = (("a", "rack0"), ("b", "rack1"))  # one volume each
TIER_VOLUME_BYTES = GIB  # each; the master's limit is the same size
TIER_COLLECTION = "tier"
TIER_BACKEND = ("s3", "tier")  # -tierBackends name "s3.tier", bucket "tier"
TIER_ACCESS_KEY, TIER_SECRET_KEY = "chipsmoke", "chip-smoke-tier-secret"
TIER_COOLDOWN_S = 5
TIER_INTERVAL_S = 3
TIER_POLICY = {TIER_COLLECTION: {"ec_cooldown_seconds": TIER_COOLDOWN_S,
                                 "tier_backend": ".".join(TIER_BACKEND),
                                 "tier_idle_seconds": TIER_COOLDOWN_S}}
TIER_GETS = 2048  # (c): from the remote tier, across both volumes
TIER_EC_GETS = 256  # (d): through the EC shards
TIER_SHELL_GETS = 256  # (e): after the download
TIER_S = 900.0  # every volume sealed, encoded and tiered
_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def serve_s3_endpoint(root: str, port_file: str, access_key: str,
                      secret_key: str) -> None:
    """A disk-backed S3-compatible endpoint on 127.0.0.1, run as a child
    process of the tier phase: PUT, ranged GET, DELETE and multipart
    initiate / part / complete / abort, objects under `root/<bucket>/`.
    Every request must carry a SigV4 header signature by `access_key` /
    `secret_key`, checked here with hashlib and hmac alone (not the
    port's signing code), over the body's sha256 too; a mismatch answers
    403.  GET /_stats (unsigned) answers the counters as JSON.  The bound
    port is written to `port_file`; SIGTERM stops the server and the
    process exits 0."""
    import hmac
    import threading
    import urllib.parse
    import uuid
    import xml.etree.ElementTree as ET
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    stats = {"puts": 0, "parts": 0, "completes": 0, "aborts": 0,
             "gets": 0, "range_gets": 0, "deletes": 0, "denied": 0,
             "bytes_in": 0, "bytes_out": 0}
    lock = threading.Lock()
    uploads = os.path.join(root, ".uploads")
    os.makedirs(uploads, exist_ok=True)

    def count(**kw) -> None:
        with lock:
            for k, v in kw.items():
                stats[k] += v

    def hmac256(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    def enc(x: str) -> str:
        return urllib.parse.quote(x, safe="-._~")

    class Denied(Exception):
        pass

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def reply(self, code: int, body: bytes = b"", headers=()) -> None:
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def verify(self, body: bytes) -> None:
            """SigV4 (AWS4-HMAC-SHA256, header form) over the request as
            received: method, raw path, sorted re-encoded query, the
            signed headers, and the body's sha256."""
            auth = self.headers.get("Authorization", "")
            if not auth.startswith("AWS4-HMAC-SHA256 "):
                raise Denied("no SigV4 signature")
            fields = dict(p.strip().split("=", 1) for p in
                          auth[len("AWS4-HMAC-SHA256 "):].split(","))
            ak, date, region, service, term = fields["Credential"].split("/")
            if ak != access_key or term != "aws4_request":
                raise Denied("unknown access key")
            payload = self.headers.get("x-amz-content-sha256", "")
            if payload != hashlib.sha256(body).hexdigest():
                raise Denied("payload hash mismatch")
            path, _, query = self.path.partition("?")
            pairs = []
            for part in query.split("&"):
                if part:
                    k, _, v = part.partition("=")
                    pairs.append((enc(urllib.parse.unquote_plus(k)),
                                  enc(urllib.parse.unquote_plus(v))))
            signed = fields["SignedHeaders"].split(";")
            canon = "\n".join([
                self.command, path,
                "&".join(f"{k}={v}" for k, v in sorted(pairs)),
                "".join(f"{h}:{' '.join(self.headers.get(h, '').split())}\n"
                        for h in signed),
                ";".join(signed), payload])
            scope = f"{date}/{region}/{service}/aws4_request"
            sts = "\n".join(["AWS4-HMAC-SHA256",
                             self.headers.get("x-amz-date", ""), scope,
                             hashlib.sha256(canon.encode()).hexdigest()])
            k = hmac256(("AWS4" + secret_key).encode(), date)
            for part in (region, service, "aws4_request"):
                k = hmac256(k, part)
            want = hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()
            if not hmac.compare_digest(want, fields["Signature"]):
                raise Denied("signature mismatch")

        def handle_one(self) -> None:
            if self.path == "/_stats":
                with lock:
                    return self.reply(200, json.dumps(stats).encode())
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
            try:
                self.verify(body)
            except (Denied, KeyError, ValueError) as e:
                count(denied=1)
                return self.reply(403, f"<Error><Code>AccessDenied</Code>"
                                       f"<Message>{e}</Message></Error>"
                                  .encode())
            path, _, query = self.path.partition("?")
            q = urllib.parse.parse_qs(query, keep_blank_values=True)
            bucket, _, key = urllib.parse.unquote(path).lstrip("/") \
                .partition("/")
            bdir = os.path.join(root, bucket)
            obj = os.path.join(bdir, urllib.parse.quote(key, safe=""))
            m = self.command
            if not key:
                if m == "PUT":
                    os.makedirs(bdir, exist_ok=True)
                    return self.reply(200)
                return self.reply(405)
            if not os.path.isdir(bdir):
                return self.reply(404, b"<Error><Code>NoSuchBucket</Code>"
                                       b"</Error>")
            if m == "POST" and "uploads" in q:
                uid = uuid.uuid4().hex
                os.makedirs(os.path.join(uploads, uid))
                return self.reply(200, (
                    "<InitiateMultipartUploadResult><Bucket>"
                    f"{bucket}</Bucket><Key>{key}</Key><UploadId>{uid}"
                    "</UploadId></InitiateMultipartUploadResult>").encode())
            if "uploadId" in q:
                udir = os.path.join(uploads, q["uploadId"][0])
                if not os.path.isdir(udir):
                    return self.reply(404, b"<Error><Code>NoSuchUpload"
                                           b"</Code></Error>")
                if m == "PUT":
                    part = int(q["partNumber"][0])
                    with open(os.path.join(udir, f"{part:05d}"), "wb") as f:
                        f.write(body)
                    count(parts=1, bytes_in=len(body))
                    etag = hashlib.md5(body).hexdigest()
                    return self.reply(200, headers=[("ETag", f'"{etag}"')])
                if m == "POST":
                    parts = [(int(p.findtext("PartNumber")),
                              p.findtext("ETag").strip('"'))
                             for p in ET.fromstring(body).iter("Part")]
                    tmp = obj + ".part"
                    with open(tmp, "wb") as out:
                        for num, etag in parts:
                            pf = os.path.join(udir, f"{num:05d}")
                            with open(pf, "rb") as f:
                                blob = f.read()
                            if hashlib.md5(blob).hexdigest() != etag:
                                return self.reply(400, b"<Error><Code>"
                                                  b"InvalidPart</Code>"
                                                  b"</Error>")
                            out.write(blob)
                    os.replace(tmp, obj)
                    shutil.rmtree(udir)
                    count(completes=1)
                    return self.reply(200, (
                        "<CompleteMultipartUploadResult><Key>"
                        f"{key}</Key></CompleteMultipartUploadResult>")
                        .encode())
                if m == "DELETE":
                    shutil.rmtree(udir)
                    count(aborts=1)
                    return self.reply(204)
                return self.reply(405)
            if m == "PUT":
                tmp = obj + ".part"
                with open(tmp, "wb") as f:
                    f.write(body)
                os.replace(tmp, obj)
                count(puts=1, bytes_in=len(body))
                return self.reply(200, headers=[
                    ("ETag", f'"{hashlib.md5(body).hexdigest()}"')])
            if m == "DELETE":
                if os.path.exists(obj):
                    os.remove(obj)
                count(deletes=1)
                return self.reply(204)
            if m != "GET":
                return self.reply(405)
            if not os.path.exists(obj):
                return self.reply(404, b"<Error><Code>NoSuchKey</Code>"
                                       b"</Error>")
            size = os.path.getsize(obj)
            lo, hi, code = 0, size - 1, 200
            rng = self.headers.get("Range", "")
            if rng.startswith("bytes="):
                a, _, b = rng[len("bytes="):].partition("-")
                lo, hi, code = int(a), min(int(b or size - 1), size - 1), 206
            length = max(0, hi - lo + 1)
            self.send_response(code)
            self.send_header("Content-Length", str(length))
            if code == 206:
                self.send_header("Content-Range", f"bytes {lo}-{hi}/{size}")
            self.end_headers()
            with open(obj, "rb") as f:
                sent = 0
                while sent < length:
                    sent += self.connection.sendfile(f, lo + sent,
                                                     length - sent)
            count(gets=int(code == 200), range_gets=int(code == 206),
                  bytes_out=length)

        do_GET = do_PUT = do_POST = do_DELETE = handle_one

    class Server(ThreadingHTTPServer):
        # a deep accept queue: the volume servers open a connection per
        # ranged GET, 32 at once in step (c), and a SYN dropped from the
        # socketserver default of 5 waits out a 1 s retransmit
        request_queue_size = 1024
        daemon_threads = True

    httpd = Server(("127.0.0.1", 0), Handler)
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=httpd.shutdown, daemon=True).start())
    with open(port_file + ".tmp", "w") as f:
        f.write(str(httpd.server_address[1]))
    os.replace(port_file + ".tmp", port_file)
    httpd.serve_forever()
    httpd.server_close()


class _S3Endpoint:
    """serve_s3_endpoint in a child process of this script's own code."""

    def __init__(self, work: str, env: dict):
        self.root = os.path.join(work, "s3")
        os.makedirs(os.path.join(self.root, TIER_BACKEND[1]))
        port_file = os.path.join(work, "s3.port")
        self.log = os.path.join(work, "s3.log")
        here = os.path.dirname(os.path.abspath(__file__))
        with open(self.log, "wb") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-c",
                 "import sys, chip_smoke; chip_smoke.serve_s3_endpoint("
                 "*sys.argv[1:])", self.root, port_file, TIER_ACCESS_KEY,
                 TIER_SECRET_KEY], cwd=here, env=env, stdout=f,
                stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        while not os.path.exists(port_file):
            if self.proc.poll() is not None or \
                    time.perf_counter() - t0 > CLUSTER_START_S:
                raise AssertionError(f"the S3 endpoint did not start: "
                                     f"{open(self.log).read()[-2000:]}")
            time.sleep(0.05)
        with open(port_file) as f:
            self.port = int(f.read())
        self.url = f"http://127.0.0.1:{self.port}"

    def stats(self) -> dict:
        import urllib.request

        with urllib.request.urlopen(self.url + "/_stats", timeout=60) as r:
            return json.loads(r.read())

    def object_path(self, key: str) -> str:
        return os.path.join(self.root, TIER_BACKEND[1], key)

    def stop(self) -> int:
        """SIGTERM: -> the exit code, which must be 0."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=CLUSTER_STOP_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
                raise AssertionError("the S3 endpoint ignored SIGTERM")
        return self.proc.returncode


def _tier_get_pass(name: str, url: str, vid: int, keys: list[int],
                   records: dict, latencies: list | None = None) -> dict:
    """_http_get_pass of volume `vid`'s `keys` on the server at `url`."""
    row = _http_get_pass(_KeepAlive(int(url.rsplit(":", 1)[1])), name,
                         keys, records[vid], vid=vid, latencies=latencies)
    return {**row, "server": url}


def phase_tier(rs_cuda, gf256, work: str, size: int, seed: int, power: str,
               reduced: list[str], codec: str = "cuda",
               device: str = "cuda", free_port=free_port_pair,
               gets: int = TIER_GETS, ec_gets: int = TIER_EC_GETS,
               shell_gets: int = TIER_SHELL_GETS) -> dict:
    """The remote tier with 5-byte offsets, driven by the master's
    lifecycle controller: a local S3-compatible endpoint (serve_s3_endpoint,
    a child process, SigV4 checked by its own code), a master
    (`-volumeSizeLimitMB` the volumes' size, `-lifecycleInterval`
    TIER_INTERVAL_S, `-lifecyclePolicy` TIER_POLICY: collection `tier`
    encoded after TIER_COOLDOWN_S and tiered to `s3.tier`) and two
    `volume` processes with `-offset.5bytes -tierBackends <json>
    -ec.codec=<codec>`, A and B, each holding one volume of collection
    `tier` of `size` bytes of real needle records with a 17-byte-entry
    .idx, made before it starts.  Steps, each on its own line: (a) the
    controller seals both volumes, encodes each on its node's codec
    keeping the source (the batched kernel's launches on each node, read
    from /metrics) and tiers its .dat to the endpoint, every job done;
    (b) each object equals its .dat by sha256 (taken before the move),
    the local .dat is gone, the .vif names the object, .ec00-.ec13 pass
    the parity check, every .ecx is the key-sorted 17-byte .idx; (c)
    `gets` GETs from 16 threads across both volumes, each from the node
    whose volume's .dat is remote (ranged GETs at the endpoint move),
    each body equal to its record; (d) `ec_gets` needles of each volume
    GET from the other node, which holds only EC shards of it (its local
    shards and the peer's by remote fetch, the 17-byte .ecx searched; the
    endpoint's ranged GETs do not move), each equal; (e) `shell -c
    "volume.tier.download -volumeId=1"` (the .dat back, equal by sha256,
    GETs equal), then `volume.tier.upload -volumeId=1 -dest=s3.tier` (the
    object equal by sha256), each move's GB/s, and `shell_gets` GETs of
    keys no earlier step read, from the local .dat, equal; (f) a request signed with
    a wrong secret answers 403, and a tier move of volume 1 to a backend
    no server registered fails FAILED_PRECONDITION with the .dat unchanged;
    (g) SIGTERM: every process, the endpoint's too, exits 0.  Counts are
    read just before and just after each step.  -> launches by kernel
    and step, and the rows."""
    import urllib.error

    import grpc

    from seaweedfs_tpu_torch.pb import rpc as rpclib
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
    from seaweedfs_tpu_torch.storage.backend_s3 import S3Backend
    from seaweedfs_tpu_torch.storage.ec import encoder as enc

    t_phase = time.perf_counter()
    names = [n for n, _r in TIER_NODES]
    dirs = {n: os.path.join(work, n) for n in names}
    vid_of = {n: i + 1 for i, n in enumerate(names)}
    node_of = {v: n for n, v in vid_of.items()}
    other = {names[0]: names[1], names[1]: names[0]}
    bases = {v: os.path.join(dirs[n], f"{TIER_COLLECTION}_{v}")
             for n, v in vid_of.items()}
    records: dict[int, dict] = {}
    needles: dict[int, int] = {}
    t0 = time.perf_counter()
    for n, v in vid_of.items():
        os.makedirs(dirs[n])
        needles[v] = make_volume(bases[v], size, seed + 70 + v, device,
                                 offset_bytes=5)
        # (c) reads the first gets / 2 keys of each volume, (e) the next
        # shell_gets, which no earlier GET put in a needle cache
        _size, records[v] = _needle_records(
            bases[v], seed + 70 + v,
            sample=gets // len(names) + shell_gets, offset_bytes=5)
    make_s = time.perf_counter() - t0
    dat_sha = dict(zip(vid_of.values(), _parallel_sha256(
        [bases[v] + ".dat" for v in vid_of.values()])))
    cl = _Cluster(work, codec, free_port)
    s3 = _S3Endpoint(work, cl.env)
    backend_name = ".".join(TIER_BACKEND)
    tier_json = os.path.join(work, "tier.json")
    with open(tier_json, "w") as f:
        json.dump({backend_name: {
            "endpoint": s3.url, "bucket": TIER_BACKEND[1],
            "access_key": TIER_ACCESS_KEY,
            "secret_key": TIER_SECRET_KEY}}, f)
    policy = os.path.join(work, "policy.json")
    with open(policy, "w") as f:
        json.dump(TIER_POLICY, f)
    rows: dict[str, dict] = {}
    paths: dict[str, dict] = {"gf_matmul": {}, "gf_matmul_batched": {}}

    def step(name: str, row: dict) -> None:
        row = {"phase": f"tier_{name}", **row, "nvidia_smi": power}
        emit(row)
        rows[name] = row

    def scrape_all() -> dict:
        return {n: cl.scrape(n) for n in names}

    def counted(name: str, before: dict, after: dict) -> dict:
        out = {}
        for n in after:
            launches = _launches_moved(before[n], after[n])
            for k, v in launches.items():
                if v:
                    paths[k][f"tier_{name}_{n}"] = v
            out[n] = {"launches": launches,
                      "host_apply_rows": _moved(
                          before[n], after[n],
                          "seaweedfs_ec_op_seconds_count",
                          op="apply_rows", impl="cpu"),
                      "service_jobs": _moved(before[n], after[n],
                                             _SERVICE_FAMILY)}
        return out

    def url(n: str) -> str:
        return cl.nodes[n]["url"]

    def items(n_each: int, offset: int = 0) -> dict:
        """vid -> the first `n_each` of its sampled keys after `offset`."""
        return {v: sorted(records[v])[offset:offset + n_each]
                for v in records}

    try:
        # 0. start: the endpoint (above), the master, A and B
        t0 = time.perf_counter()
        cl.start_master("-lifecycleInterval", str(TIER_INTERVAL_S),
                        "-lifecyclePolicy", policy, limit_mb=size // MIB)
        t_master = time.perf_counter()
        for n, rack in TIER_NODES:
            cl.start_volume(n, rack, dirs[n], "-offset.5bytes",
                            "-tierBackends", tier_json, "-ec.codec", codec)
        cl.wait_for("both nodes registered", lambda: set(cl.http_json(
            "/dir/status")["DataNodes"]) >= {url(n) for n in names},
            CLUSTER_START_S)
        for n in names:
            cl.wait_for(f"{n}'s /metrics", lambda n=n: cl.scrape(n)
                        is not None, CLUSTER_START_S)
        before = scrape_all()
        s3_before = s3.stats()
        step("start", {"codec": codec, "start_s": time.perf_counter() - t0,
                       "make_volumes_s": make_s, "volume_bytes": size,
                       "needles": needles, "offset_bytes": 5,
                       "idx_bytes": {str(v): os.path.getsize(
                           bases[v] + ".idx") for v in bases},
                       "policy": TIER_POLICY, "reduced": reduced})

        # (a) the controller seals, encodes (keeping the source) and tiers
        failed: list = []

        def tiered() -> bool:
            jobs = cl.http_json("/cluster/lifecycle")["jobs"]
            failed[:] = [j for j in jobs
                         if j["state"] in ("failed", "parked")]
            done = {(j["volume_id"], j["transition"]) for j in jobs
                    if j["state"] == "done"}
            return bool(failed) or all((v, "tier") in done for v in bases)

        cl.wait_for("every volume sealed, encoded and tiered", tiered,
                    TIER_S)
        if failed:
            raise AssertionError(f"lifecycle jobs failed: {failed}")
        pipeline_s = time.perf_counter() - t_master
        after = scrape_all()
        counts = counted("encode_and_tier", before, after)
        for n in names:
            c = counts[n]
            if codec == "cuda" and not c["launches"]["gf_matmul_batched"]:
                raise AssertionError(f"encode: no batched launch on {n}: "
                                     f"{c}")
            if codec != "cpu" and c["host_apply_rows"]:
                raise AssertionError(f"encode: the host codec's apply_rows "
                                     f"moved on {n}: {c}")
        doc = cl.http_json("/cluster/lifecycle")
        jobs: dict = {}
        for j in doc["jobs"]:
            jobs.setdefault(j["volume_id"], {})[j["transition"]] = {
                "seconds": (j["updated_ms"] - j["created_ms"]) / 1e3,
                "detail": j.get("detail", "")}
        for v in bases:
            if set(jobs[v]) != {"seal", "ec_encode", "tier"}:
                raise AssertionError(f"volume {v}'s jobs: {jobs[v]}")
        s3_mid = s3.stats()
        step("encode_and_tier", {
            "pipeline_s": pipeline_s, "jobs": {str(v): jobs[v]
                                               for v in bases},
            "encode_GBps": {str(v): size / jobs[v]["ec_encode"]["seconds"]
                            / 1e9 for v in bases},
            "tier_upload_GBps": {str(v): size / jobs[v]["tier"]["seconds"]
                                 / 1e9 for v in bases},
            "s3": {k: s3_mid[k] - s3_before[k] for k in s3_mid},
            "lifecycle_counts": doc["counts"], "counts": counts})

        # (b) the bytes are where they should be
        spread = _ec_spread(cl)
        by_url = {url(n): n for n in names}
        obj_sha = dict(zip(bases, _parallel_sha256(
            [s3.object_path(os.path.basename(bases[v]) + ".dat")
             for v in bases])))
        if obj_sha != dat_sha:
            raise AssertionError(f"objects differ from the .dats: {obj_sha} "
                                 f"{dat_sha}")
        checked, ecx_entries = 0, {}
        for v, base in bases.items():
            if os.path.exists(base + ".dat"):
                raise AssertionError(f"{base}.dat still local after the tier")
            with open(base + ".vif") as f:
                rf = json.load(f)["files"][0]
            if (rf["backendType"], rf["backendId"], rf["key"]) != (
                    *TIER_BACKEND, os.path.basename(base) + ".dat") \
                    or int(rf["fileSize"]) != size:
                raise AssertionError(f"{base}.vif: {rf}")
            if sorted(s for sids in spread[v].values() for s in sids) \
                    != list(range(14)):
                raise AssertionError(f"volume {v}: shards {spread[v]}")
            view = os.path.join(work, f"parity_view_{v}")
            os.makedirs(view)
            for u, sids in spread[v].items():
                for sid in sids:
                    os.symlink(os.path.join(
                        dirs[by_url[u]], f"{TIER_COLLECTION}_{v}.ec{sid:02d}"),
                        os.path.join(view, f"{v}.ec{sid:02d}"))
            checked += check_parity(os.path.join(view, str(v)), rs_cuda,
                                    gf256, enc.DEFAULT_SLICE, device=device)
            for n in names:  # every holder's copy of the .ecx
                held = os.path.join(dirs[n], f"{TIER_COLLECTION}_{v}")
                if url(n) in spread[v]:
                    got = check_ecx(held, offset_bytes=5,
                                    idx_base=bases[v])
                    if os.path.getsize(held + ".ecx") != 17 * needles[v] \
                            or got != needles[v]:
                        raise AssertionError(f"{held}.ecx: {got} entries")
                    ecx_entries[f"{v}@{n}"] = got
        step("placement", {
            "objects_sha256_equal": True, "local_dat_gone": True,
            "vif_names_object": True, "parity_slices_checked": checked,
            "spread": {str(v): {by_url[u]: s for u, s in spread[v].items()}
                       for v in bases},
            "ecx_entries": ecx_entries, "ecx_entry_bytes": 17})

        # (c) GETs served from the remote tier
        per = gets // len(bases)
        before, s3_before = scrape_all(), s3.stats()
        t0 = time.perf_counter()
        got_rows, lat_of = {}, {v: [] for v in bases}

        def remote_pass(v: int) -> None:
            got_rows[v] = _tier_get_pass(f"remote_{v}", url(node_of[v]), v,
                                         items(per)[v], records, lat_of[v])

        with ThreadPoolExecutor(len(bases)) as pool:
            list(pool.map(remote_pass, bases))
        wall = time.perf_counter() - t0
        s3_after, after = s3.stats(), scrape_all()
        range_gets = s3_after["range_gets"] - s3_before["range_gets"]
        if not range_gets:
            raise AssertionError("(c): no ranged GET reached the endpoint")
        reads = sum(r["reads"] for r in got_rows.values())
        lat = np.concatenate([lat_of[v] for v in bases])
        step("remote_gets", {
            "reads": reads, "threads": EC_READ_THREADS * len(bases),
            "wall_s": wall, "reads_per_s": reads / wall,
            "by_volume": {str(v): got_rows[v] for v in bases},
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "endpoint_range_gets": range_gets,
            "endpoint_bytes_out": s3_after["bytes_out"]
            - s3_before["bytes_out"], "byte_equal": True,
            "counts": counted("remote_gets", before, after)})

        # (d) through the EC shards, from the node without the .dat
        before, s3_before = scrape_all(), s3.stats()
        ec_rows = {}
        for v in bases:
            n = other[node_of[v]]
            ec_rows[v] = _tier_get_pass(f"ec_{v}_from_{n}", url(n), v,
                                        items(ec_gets // len(bases))[v],
                                        records)
        s3_after, after = s3.stats(), scrape_all()
        if s3_after["range_gets"] != s3_before["range_gets"]:
            raise AssertionError("(d): EC reads went to the remote tier")
        step("ec_gets", {
            "route": "HTTP GET from the node holding only EC shards of the "
                     "volume: its EcVolume searches the 17-byte .ecx and "
                     "reads its own shards, the peer's by remote fetch",
            "by_volume": {str(v): r for v, r in ec_rows.items()},
            "reads": sum(r["reads"] for r in ec_rows.values()),
            "byte_equal": True, "endpoint_range_gets": 0,
            "counts": counted("ec_gets", before, after)})

        # (e) the shell's round trip of volume 1
        v1 = vid_of[names[0]]
        n1 = node_of[v1]
        down_s, out_down = cl.shell(f"volume.tier.download -volumeId={v1}")
        if sha256_of(bases[v1] + ".dat") != dat_sha[v1] \
                or os.path.exists(s3.object_path(
                    os.path.basename(bases[v1]) + ".dat")):
            raise AssertionError("volume.tier.download: the .dat differs "
                                 "or the object stayed")
        shell_row = _tier_get_pass("after_download", url(n1), v1,
                                   items(shell_gets, per)[v1], records)

        # (f) two refusals, with volume 1 local
        stub = rpclib.volume_server_stub(
            f"127.0.0.1:{cl.nodes[n1]['port'] + 10000}", timeout=600)
        try:
            list(stub.VolumeTierMoveDatToRemote(
                vs_pb.VolumeTierMoveDatToRemoteRequest(
                    volume_id=v1, destination_backend_name="s3.nobody")))
            raise AssertionError("a move to an unregistered backend passed")
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.FAILED_PRECONDITION \
                    or "not configured" not in (e.details() or ""):
                raise
            refused_rpc = f"{e.code().name}: {e.details()}"
        if sha256_of(bases[v1] + ".dat") != dat_sha[v1]:
            raise AssertionError("the refused move changed the .dat")
        denied_before = s3.stats()["denied"]
        wrong = S3Backend("wrong", s3.url, TIER_BACKEND[1],
                          access_key=TIER_ACCESS_KEY,
                          secret_key="not-" + TIER_SECRET_KEY)
        try:
            wrong.read_range(
                os.path.basename(bases[vid_of[names[1]]]) + ".dat", 0, 16)
            raise AssertionError("a wrong secret was served")
        except urllib.error.HTTPError as e:
            if e.code != 403:
                raise
            wrong_key = e.code
        if s3.stats()["denied"] != denied_before + 1:
            raise AssertionError("the endpoint did not count the refusal")

        up_s, out_up = cl.shell(
            f"volume.tier.upload -volumeId={v1} -dest={backend_name}")
        key1 = os.path.basename(bases[v1]) + ".dat"
        if sha256_of(s3.object_path(key1)) != dat_sha[v1] \
                or os.path.exists(bases[v1] + ".dat"):
            raise AssertionError("volume.tier.upload: the object differs or "
                                 "the .dat stayed")
        step("shell", {
            "download_s": down_s, "download_GBps": size / down_s / 1e9,
            "upload_s": up_s, "upload_GBps": size / up_s / 1e9,
            "download_out": out_down.strip(), "upload_out": out_up.strip(),
            "sha256_equal": True, "gets_after_download": shell_row})
        step("refusals", {"wrong_secret_status": wrong_key,
                          "unregistered_backend": refused_rpc,
                          "dat_unchanged": True})

        # (g) SIGTERM: clean exits
        exits = cl.terminate((*names, "master"))
        exits["s3"] = {"rc": s3.stop()}
        if exits["s3"]["rc"] != 0:
            raise AssertionError(f"the S3 endpoint exited {exits['s3']}")
        step("stop", {"exits": exits})
    except BaseException:
        print(cl.tails(), file=sys.stderr, flush=True)
        with open(s3.log, "rb") as f:
            print(f"--- s3 ---\n{f.read()[-4000:].decode(errors='replace')}",
                  file=sys.stderr, flush=True)
        raise
    finally:
        cl.stop_all()
        if s3.proc.poll() is None:
            s3.proc.kill()
            s3.proc.wait()
    summary = {"phase": "tier_summary",
               "wall_s": time.perf_counter() - t_phase,
               "launches_by_path": paths, "nvidia_smi": power}
    emit(summary)
    return {"launches_by_path": paths, "rows": rows}


# -- phase 4i: quorum --------------------------------------------------------

QUORUM_MASTERS = ("m0", "m1", "m2")
QUORUM_NODES = MAINT_NODES  # A and B in rack0, C and D in rack1
QUORUM_VOLUME_BYTES = GIB  # each node's sealed volume; the masters' limit
QUORUM_WRITES = 256  # step 1: through a follower's /dir/assign
QUORUM_WRITE_MAX = 64 * 1024
QUORUM_GETS = 2048  # step 5: during the repair, across the 4 volumes
QUORUM_HOT_KEYS = 16  # step 6: keys read QUORUM_HOT_READS times each
QUORUM_HOT_READS = 8
# the first needle of each volume spans the first 1 MiB block of every
# data shard, so a drop-shard canary read on any node holding a data shard
# decodes one of its intervals (on the node's card)
QUORUM_LEAD_BYTES = 10 * MIB + 512 * 1024
QUORUM_COOLDOWN_S = 5
QUORUM_POLICY = {"*": {"ec_cooldown_seconds": QUORUM_COOLDOWN_S}}
QUORUM_INTERVAL_S = 3  # lifecycle cycle seconds
# every volume cools this long after the processes start: the election,
# the four registrations and step 1's writes come first
QUORUM_COOL_S = 40.0
# tests/test_slo_cluster.py's burn-window scale: the page tier evaluates
# 1.5 s / 18 s windows
QUORUM_WINDOW_SCALE = "0.005"
# step 3's rot: parity shard 10 is a source of every decode of a data
# interval (the decode plan takes the first 10 present shards), and byte
# 100 lies inside the lead needle's interval of every data shard
QUORUM_FLIP = (10, 100)
QUORUM_S = 300.0  # bound of each wait


def _raft_of(cl: "_Cluster", port: int) -> dict:
    doc = cl.http_json("/cluster/status", port=port)
    return {**doc["Raft"], "leader": doc["Leader"]}


def _fed_samples(cl: "_Cluster", families: str) -> dict[str, float]:
    """The leader's federated /cluster/metrics?family=...: {sample: v}."""
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{cl.master_port}/cluster/metrics?family="
            f"{families}", timeout=60) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def _per_instance(samples: dict, family: str, **labels) -> dict[str, float]:
    out: dict[str, float] = {}
    for key, v in samples.items():
        if not key.startswith(family + "{") or not all(
                f'{k}="{val}"' in key for k, val in labels.items()):
            continue
        inst = key.split('instance="', 1)[1].split('"', 1)[0]
        out[inst] = out.get(inst, 0.0) + v
    return out


def _lead_record(base: str) -> dict:
    """The volume's first needle (right after the superblock): key,
    cookie and its data's sha256."""
    from seaweedfs_tpu_torch.storage.needle import Needle, actual_size

    with open(base + ".dat", "rb") as f:
        f.seek(8)
        head = f.read(16)
        size = int.from_bytes(head[12:16], "big")
        f.seek(8)
        nd = Needle.from_bytes(f.read(actual_size(size, 3)), 3)
    return {"key": nd.id, "cookie": nd.cookie, "size": len(nd.data),
            "data_sha256": hashlib.sha256(nd.data).hexdigest()}


def _empty_volume(base: str) -> None:
    """A writable volume holding no needle: the superblock and an empty
    .idx."""
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock

    with open(base + ".dat", "wb") as f:
        f.write(SuperBlock().to_bytes())
    open(base + ".idx", "wb").close()


def _quorum_writes(cl: "_Cluster", follower: int, leader: int, n: int,
                   seed: int, collection: str = "") -> dict:
    """`n` seeded needles of 1 B..QUORUM_WRITE_MAX: each assigned through
    the follower's /dir/assign (a 307 to the leader, followed), POSTed to
    the assigned server by 16 threads; the first assign is asked without
    following, to see the redirect; every fid unique, every needle read
    back equal."""
    import urllib.error
    import urllib.request

    q = f"?collection={collection}" if collection else ""

    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **k):
            return None

    try:
        urllib.request.build_opener(NoRedirect).open(
            f"http://127.0.0.1:{follower}/dir/assign{q}", timeout=60)
        raise AssertionError("a follower's /dir/assign answered itself")
    except urllib.error.HTTPError as e:
        code, location = e.code, e.headers.get("Location", "")
        e.close()
    if code != 307 or not location.startswith(f"http://127.0.0.1:{leader}/"):
        raise AssertionError(f"follower assign: {code} {location!r}")
    rng = np.random.default_rng(seed + 70)
    payloads = [rng.integers(0, 256, int(rng.integers(1, QUORUM_WRITE_MAX)),
                             dtype=np.uint8).tobytes() for _ in range(n)]

    def write(payload: bytes) -> tuple[str, str]:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{follower}/dir/assign{q}",
                timeout=60) as r:
            a = json.loads(r.read())
        req = urllib.request.Request(f"http://{a['url']}/{a['fid']}",
                                     data=payload, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            if r.status != 201:
                raise AssertionError(f"POST {a['fid']}: {r.status}")
        return a["fid"], a["url"]

    t0 = time.perf_counter()
    with ThreadPoolExecutor(EC_READ_THREADS) as pool:
        fids = list(pool.map(write, payloads))
    wall = time.perf_counter() - t0
    if len({f for f, _u in fids}) != n:
        raise AssertionError("a fid was assigned twice")
    for (fid, url), payload in zip(fids, payloads):
        with urllib.request.urlopen(f"http://{url}/{fid}", timeout=60) as r:
            if r.read() != payload:
                raise AssertionError(f"{fid} read back differs")
    return {"needles": n, "bytes": sum(map(len, payloads)), "wall_s": wall,
            "writes_per_s": n / wall, "redirect": code,
            "fids_unique": True, "readback_equal": True,
            "volumes": sorted({int(f.split(",")[0]) for f, _u in fids})}


def phase_quorum(rs_cuda, gf256, work: str, size: int, seed: int,
                 power: str, reduced: list[str], codec: str = "cuda",
                 device: str = "cuda", free_port=free_port_pair,
                 gets: int = QUORUM_GETS, writes: int = QUORUM_WRITES,
                 cool_s: float = QUORUM_COOL_S,
                 lead: int = QUORUM_LEAD_BYTES) -> dict:
    """SeaweedFS's documented HA layout driven through a failover: three
    `master` processes in one raft quorum (`-peers` naming all three, each
    its own `-raftDir` and `-lifecycleDir`, `-lifecycleInterval`
    QUORUM_INTERVAL_S, `-lifecyclePolicy` {"*": {"ec_cooldown_seconds":
    5}}, `-sloInterval 1 -canaryInterval 1 -debugDir`, and
    SEAWEEDFS_TPU_SLO_WINDOW_SCALE=0.005 as tests/test_slo_cluster.py sets
    it) and four `volume` processes on their default codec (`cuda`; a
    `codec` other than cuda is passed as -ec.codec), A and B in rack0, C
    and D in rack1, each `-mserver` naming the three masters and
    SEAWEEDFS_TPU_EC_PARTIAL=0 (a degraded interval is decoded on the
    server's own codec, the card, from gathered shards instead of the
    peers' host-side partial sums).  Each node holds one sealed volume of
    `size` bytes of real needle records whose first needle has `lead`
    bytes of data, stamped to cool `cool_s` after the start, and one
    empty writable volume.  Steps, each on its own line: (0) the seconds
    until exactly one master reports `leader` at the highest term
    (/cluster/status's Raft block), and until all four nodes registered
    with it; (1) `writes` seeded needles through a follower's /dir/assign
    (a 307 to the leader), every fid unique, every needle read back
    equal; (2) the lifecycle seals and encodes the 4 volumes; the moment
    the leader's /cluster/lifecycle shows an ec_encode job running, the
    leader is SIGKILLed: the seconds until a new leader is elected, until
    it is warmed (an assign answers 200), until every volume has 14
    shards mounted and its source dropped; every ec_encode job done
    exactly once in the new leader's journal, the surviving follower's
    job set the same, every slice's parity equal to the plain version,
    batched launches on every generating node and the host codec's
    apply_rows on none, and volume ids grown after the failover distinct
    from every earlier one; (3) ec_degraded canary probes ok on every
    node, read with the card's launch counters through the leader's
    federated /cluster/metrics (they move on every probed node), the
    probe's p50; then one byte of parity shard 10 of one volume flipped
    on its holder: the availability page fires in /cluster/alerts and in
    `shell -c cluster.alerts`, the flight recorder writes a bundle under
    the leader's -debugDir on its own and `shell -c cluster.debug` lists
    it; the byte restored, the alert resolves; (4) the killed master
    restarted on its -raftDir rejoins as a follower, its commit index
    reaches the leader's and its /cluster/lifecycle lists the same done
    jobs; (5) D (or, if the encodes stacked more than 4 shards of a
    volume on D, a node holding at most 4 of every volume) SIGKILLed:
    the new leader's mass repair, its journal carried through raft,
    rebuilds the lost shards on the survivors' cards (equal by sha256,
    batched launches on every target), the time to recover as in 4g, and
    `gets` seeded GETs during the repair, every body equal to its
    record; (6) one degraded GET (the lead needle of a volume that lost a
    data shard, from a survivor, with a traceparent) stitched by
    /cluster/traces across the volume processes it touched, and
    /cluster/hot listing a pass of QUORUM_HOT_KEYS keys read
    QUORUM_HOT_READS times each; (7) SIGTERM: clean exits.  -> launches
    by kernel and step, and the rows."""
    import re
    import threading
    import urllib.request

    from seaweedfs_tpu_torch.storage.file_id import FileId

    t_phase = time.perf_counter()
    names = [n for n, _r in QUORUM_NODES]
    dirs = {n: os.path.join(work, n) for n in names}
    vids = list(range(1, len(names) + 1))
    records: dict[int, dict] = {}
    leads: dict[int, dict] = {}
    t0 = time.perf_counter()
    needles = 0
    for i, n in enumerate(names):
        os.makedirs(dirs[n])
        vid = vids[i]
        base = os.path.join(dirs[n], str(vid))
        needles += make_volume(base, size, seed + vid, device,
                               lead_data=lead)
        leads[vid] = _lead_record(base)
        _size, records[vid] = _needle_records(
            base, seed + vid, sample=gets // len(names))
        records[vid].pop(leads[vid]["key"], None)
        _empty_volume(os.path.join(dirs[n], str(len(names) + vid)))
    make_s = time.perf_counter() - t0
    policy = os.path.join(work, "policy.json")
    with open(policy, "w") as f:
        json.dump(QUORUM_POLICY, f)
    cl = _Cluster(work, codec, free_port)
    ports = {m: free_port() for m in QUORUM_MASTERS}
    peers = ",".join(f"127.0.0.1:{p}" for p in ports.values())
    mserver = peers
    by_port = {p: m for m, p in ports.items()}
    master_argv: dict[str, list[str]] = {}
    for m, p in ports.items():
        for sub in ("raft", "lifecycle", "debug"):
            os.makedirs(os.path.join(work, f"{m}_{sub}"))
        master_argv[m] = [
            "master", "-ip", "127.0.0.1", "-port", str(p), "-peers", peers,
            "-raftDir", os.path.join(work, f"{m}_raft"),
            "-lifecycleDir", os.path.join(work, f"{m}_lifecycle"),
            "-lifecycleInterval", str(QUORUM_INTERVAL_S),
            "-lifecyclePolicy", policy, "-volumeSizeLimitMB",
            str(size // MIB), "-maintenanceInterval", "0",
            "-metricsPort", str(free_port()), "-sloInterval", "1",
            "-canaryInterval", "1",
            "-debugDir", os.path.join(work, f"{m}_debug")]
    # every page captures a bundle (tests/test_flight_recorder.py's chaos
    # setting): the cluster's own pages during the failover must not put
    # the rot's page inside the default 60 s cooldown
    master_env = {"SEAWEEDFS_TPU_SLO_WINDOW_SCALE": QUORUM_WINDOW_SCALE,
                  "SEAWEEDFS_TPU_DEBUG_BUNDLE_COOLDOWN_S": "0"}
    rows: dict[str, dict] = {}
    paths: dict[str, dict] = {"gf_matmul": {}, "gf_matmul_batched": {}}

    def step(name: str, row: dict) -> None:
        row = {"phase": f"quorum_{name}", **row, "nvidia_smi": power}
        emit(row)
        rows[name] = row

    def alive_masters() -> list[int]:
        return [p for m, p in ports.items()
                if m not in cl.killed and cl.procs[m].poll() is None]

    def one_leader(among: list[int], above: int = 0) -> "int | None":
        """The port of the one master reporting `leader` at the highest
        term among `among` (a term above `above`), else None."""
        docs = {p: _raft_of(cl, p) for p in among}
        top = max(d["term"] for d in docs.values())
        leaders = [p for p, d in docs.items() if d["role"] == "leader"]
        if (len(leaders) == 1 and docs[leaders[0]]["term"] == top
                and top > above):
            return leaders[0]
        return None

    def scrape_all() -> dict:
        return {n: cl.scrape(n) for n in names if n not in cl.killed}

    def counted(name: str, before: dict, after: dict) -> dict:
        out = {}
        for n in after:
            launches = _launches_moved(before[n], after[n])
            for k, v in launches.items():
                if v:
                    paths[k][f"quorum_{name}_{n}"] = v
            out[n] = {"launches": launches,
                      "host_apply_rows": _moved(
                          before[n], after[n],
                          "seaweedfs_ec_op_seconds_count",
                          op="apply_rows", impl="cpu")}
        return out

    def lifecycle_jobs(port: int) -> dict:
        return {(j["volume_id"], j["transition"]): j for j in
                cl.http_json("/cluster/lifecycle", port=port)["jobs"]}

    t_stamp = time.time()
    for i, n in enumerate(names):
        at = t_stamp + cool_s - QUORUM_COOLDOWN_S
        os.utime(os.path.join(dirs[n], f"{vids[i]}.dat"), (at, at))
    try:
        # 0. election and registration
        t0 = time.perf_counter()
        for m in QUORUM_MASTERS:
            cl.start(m, *master_argv[m], env=master_env)
        leader = cl.wait_for("one leader at the highest term", lambda:
                             one_leader(list(ports.values())), QUORUM_S)
        elect_s = time.perf_counter() - t0
        leader = one_leader(list(ports.values()))
        cl.master_port = leader
        term0 = _raft_of(cl, leader)["term"]
        t1 = time.perf_counter()
        for n, rack in QUORUM_NODES:
            cl.start_volume(n, rack, dirs[n], mserver=mserver,
                            env={"SEAWEEDFS_TPU_EC_PARTIAL": "0"})
        urls = {cl.nodes[n]["url"]: n for n in names}
        cl.wait_for("every node registered with the leader", lambda: set(
            cl.http_json("/dir/status")["DataNodes"]) >= set(urls),
            QUORUM_S)
        register_s = time.perf_counter() - t1
        for n in names:
            cl.wait_for(f"{n}'s /metrics", lambda n=n: cl.scrape(n)
                        is not None, QUORUM_S)
        step("election", {"codec": codec, "elect_s": elect_s,
                          "register_s": register_s,
                          "leader": by_port[leader], "term": term0,
                          "make_volumes_s": make_s, "volumes": len(vids),
                          "volume_bytes": size, "needles": needles,
                          "lead_needle_bytes": lead,
                          "nodes": len(names), "masters": len(ports),
                          "reduced": reduced})

        # 1. writes through a follower
        follower = next(p for p in ports.values() if p != leader)
        w = _quorum_writes(cl, follower, leader, writes, seed)
        before_vids = set(vids) | {len(names) + v for v in vids} \
            | set(w["volumes"])
        if time.time() - t_stamp > cool_s - QUORUM_INTERVAL_S:
            raise AssertionError(
                f"writes done {time.time() - t_stamp} s after the stamp: "
                f"too late before the volumes cool at {cool_s} s")
        step("writes", {"through": by_port[follower], **w})

        # 2. failover mid-encode
        before = scrape_all()
        running: list = []

        def encode_running() -> bool:
            running[:] = [k for k, j in lifecycle_jobs(leader).items()
                          if k[1] == "ec_encode" and j["state"] == "running"]
            return bool(running)

        cl.wait_for("an ec_encode job running", encode_running, QUORUM_S)
        t_kill = time.perf_counter()
        dead_master = by_port[leader]
        cl.killed.add(dead_master)
        cl.procs[dead_master].kill()
        cl.procs[dead_master].wait()
        rest = alive_masters()
        new = cl.wait_for("a new leader", lambda: one_leader(
            rest, above=term0), QUORUM_S)
        new = one_leader(rest, above=term0)
        elected_s = time.perf_counter() - t_kill
        cl.master_port = new
        with urllib.request.urlopen(
                f"http://127.0.0.1:{new}/dir/assign", timeout=60) as r:
            if r.status != 200 or "fid" not in json.loads(r.read()):
                raise AssertionError("the new leader's assign failed")
        warmed_s = time.perf_counter() - t_kill
        failed: list = []

        def encoded() -> bool:
            jobs = lifecycle_jobs(new)
            failed[:] = [k for k, j in jobs.items()
                         if j["state"] in ("failed", "parked")]
            done = [k for k, j in jobs.items()
                    if k[1] == "ec_encode" and j["state"] == "done"]
            return bool(failed) or len(done) == len(vids)

        cl.wait_for("every ec_encode job done", encoded, QUORUM_S)
        if failed:
            raise AssertionError(f"lifecycle jobs failed: {failed}")
        cl.wait_for("every source .dat dropped", lambda: not any(
            os.path.exists(os.path.join(dirs[n], f"{v}.dat"))
            for n, v in zip(names, vids)), QUORUM_S)
        cl.wait_for("14 shards of every volume at the new leader",
                    lambda: all(sum(map(len, sp.values())) == 14
                                for sp in (_ec_spread(cl).get(v, {})
                                           for v in vids)), QUORUM_S)
        encoded_s = time.perf_counter() - t_kill
        jobs = lifecycle_jobs(new)
        enc_jobs = {k: j for k, j in jobs.items() if k[1] == "ec_encode"}
        if sorted(v for v, _t in enc_jobs) != vids or any(
                j["state"] != "done" for j in enc_jobs.values()):
            raise AssertionError(f"ec_encode jobs: {enc_jobs}")
        resumed = {v: j.get("resumed", 0) for (v, _t), j in enc_jobs.items()}
        if not any(resumed[v] for v, _t in running):
            raise AssertionError(f"no running job was resumed: {resumed}")
        surviving = next(p for p in rest if p != new)

        def same_jobs() -> bool:
            a = {k: j["state"] for k, j in lifecycle_jobs(surviving).items()}
            return a == {k: j["state"] for k, j in
                         lifecycle_jobs(new).items()}

        cl.wait_for("the follower's job set equal", same_jobs, QUORUM_S)
        after = scrape_all()
        counts = counted("encode", before, after)
        for n in names:
            c = counts[n]
            if codec == "cuda" and not c["launches"]["gf_matmul_batched"]:
                raise AssertionError(f"encode: no batched launch on {n}: "
                                     f"{c}")
            if codec != "cpu" and c["host_apply_rows"]:
                raise AssertionError(f"encode: the host codec's apply_rows "
                                     f"moved on {n}: {c}")
        spread = _ec_spread(cl)
        from seaweedfs_tpu_torch.storage.ec import encoder as enc

        checked = 0
        for v in vids:
            if sorted(s for sids in spread[v].values() for s in sids) \
                    != list(range(14)):
                raise AssertionError(f"volume {v}: shards {spread[v]}")
            view = os.path.join(work, f"parity_view_{v}")
            os.makedirs(view)
            for url, sids in spread[v].items():
                for sid in sids:
                    os.symlink(os.path.join(dirs[urls[url]],
                                            f"{v}.ec{sid:02d}"),
                               os.path.join(view, f"{v}.ec{sid:02d}"))
            checked += check_parity(os.path.join(view, str(v)), rs_cuda,
                                    gf256, enc.DEFAULT_SLICE, device=device)
        grown = cl.http_json("/vol/grow?collection=quorum&count=2")
        after_vids = set(grown["volumeIds"])
        if len(after_vids) != 2 or after_vids & before_vids:
            raise AssertionError(f"volume ids reissued: before "
                                 f"{sorted(before_vids)}, after {grown}")
        step("failover", {
            "killed": dead_master, "new_leader": by_port[new],
            "running_at_kill": [v for v, _t in running],
            "elected_s": elected_s, "warmed_s": warmed_s,
            "encoded_s": encoded_s,
            "term": _raft_of(cl, new)["term"],
            "jobs_done": len(enc_jobs), "resumed": resumed,
            "follower_jobs_equal": True,
            "spread": {str(v): {urls[u]: s for u, s in spread[v].items()}
                       for v in vids},
            "parity_slices_checked": checked, "sources_dropped": True,
            "vids_before": sorted(before_vids),
            "vids_after": sorted(after_vids), "counts": counts})

        # 3. canary and SLO on the card
        fam = "seaweedfs_canary_probe,seaweedfs_cuda_kernel_launches"
        t_probes = time.time()
        fed0 = _fed_samples(cl, fam)
        before = scrape_all()
        t3 = time.perf_counter()

        def probed_ok() -> bool:
            doc = cl.http_json("/cluster/alerts")
            targets = doc["canary"]["probes"].get("ec_degraded", {}).get(
                "targets", {})
            ok = {t.split("/")[0] for t, r in targets.items()
                  if r["result"] == "ok" and r["at"] >= t_probes}
            return ok >= set(urls)

        cl.wait_for("ec_degraded probes ok on every node", probed_ok,
                    QUORUM_S)
        probe_s = time.perf_counter() - t3
        fed1 = _fed_samples(cl, fam)
        after = scrape_all()
        counts = counted("canary", before, after)
        launched = {urls[i]: v - _per_instance(
            fed0, "seaweedfs_cuda_kernel_launches_total",
            kernel="gf_matmul").get(i, 0.0) for i, v in _per_instance(
            fed1, "seaweedfs_cuda_kernel_launches_total",
            kernel="gf_matmul").items() if i in urls}
        probes_ok = sum(_per_instance(
            fed1, "seaweedfs_canary_probe_total", probe="ec_degraded",
            result="ok").values()) - sum(_per_instance(
                fed0, "seaweedfs_canary_probe_total", probe="ec_degraded",
                result="ok").values())
        if codec == "cuda" and not all(launched.get(n) for n in names):
            raise AssertionError(f"canary: the card's launches did not move "
                                 f"on every probed node: {launched}")
        lat = _fed_samples(cl, "seaweedfs_canary_probe_seconds")
        buckets = sorted(
            (float(k.split('le="', 1)[1].split('"', 1)[0]), v)
            for k, v in lat.items() if "_bucket{" in k
            and 'probe="ec_degraded"' in k and 'le="+Inf"' not in k)
        total = sum(v for k, v in lat.items() if "_count{" in k
                    and 'probe="ec_degraded"' in k)
        p50_le = next((le for le, v in buckets if v >= total / 2), None)
        mean_s = sum(v for k, v in lat.items() if "_sum{" in k
                     and 'probe="ec_degraded"' in k) / max(total, 1)
        # wait out any earlier page (the failover's probes) before the rot
        cl.wait_for("availability ok before the rot", lambda: cl.http_json(
            "/cluster/alerts")["states"]["availability"]["state"] == "ok",
            QUORUM_S)
        rot_v = vids[0]
        sid, off = QUORUM_FLIP
        holder = next(urls[u] for u, s in spread[rot_v].items() if sid in s)
        shard = os.path.join(dirs[holder], f"{rot_v}.ec{sid:02d}")

        def flip() -> None:
            with open(shard, "r+b") as f:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0xFF]))

        debug_dir = os.path.join(work, f"{by_port[new]}_debug")
        bundles_before = set(os.listdir(debug_dir))
        flip()
        t_flip = time.perf_counter()

        def firing() -> bool:
            doc = cl.http_json("/cluster/alerts")
            return doc["states"]["availability"]["state"] == "firing" \
                and any(a["slo"] == "availability" for a in doc["alerts"])

        cl.wait_for("the availability page firing", firing, QUORUM_S)
        fire_s = time.perf_counter() - t_flip
        _w, alerts_out = cl.shell("cluster.alerts")
        if not re.search(r"availability \[page\] firing", alerts_out):
            raise AssertionError(f"cluster.alerts: {alerts_out[-2000:]}")
        def new_bundles() -> list[str]:
            return sorted(b[:-len(".json")] for b in os.listdir(debug_dir)
                          if "-alert-" in b and b.endswith(".json")
                          and b not in bundles_before)

        cl.wait_for("a bundle captured on its own", new_bundles, QUORUM_S)
        bundle = new_bundles()[0]
        _w, debug_out = cl.shell("cluster.debug")
        if bundle not in debug_out:
            raise AssertionError(f"cluster.debug: {debug_out[-2000:]}")
        cap = _fed_samples(cl, "seaweedfs_debug_bundle")
        cap_s = sum(v for k, v in cap.items() if k.startswith(
            "seaweedfs_debug_bundle_capture_seconds_sum")) / max(1.0, sum(
                v for k, v in cap.items() if k.startswith(
                    "seaweedfs_debug_bundle_capture_seconds_count")))
        flip()
        t_restore, t_restore_wall = time.perf_counter(), time.time()

        def resolved() -> bool:
            """Ok, and the rotten volume probed ok since the
            restore (the page resolves between the rotten probes too, as
            its short window rolls past each)."""
            doc = cl.http_json("/cluster/alerts")
            targets = doc["canary"]["probes"]["ec_degraded"]["targets"]
            return doc["states"]["availability"]["state"] == "ok" \
                and any(t.endswith(f"/vol{rot_v}") and r["result"] == "ok"
                        and r["at"] >= t_restore_wall
                        for t, r in targets.items())

        cl.wait_for("the availability alert resolved", resolved, QUORUM_S)
        resolve_s = time.perf_counter() - t_restore
        history = [(h["state"], h.get("from")) for h in cl.http_json(
            "/cluster/alerts")["history"] if h["slo"] == "availability"]
        step("canary_slo", {
            "probe_all_nodes_s": probe_s, "probes_ok": probes_ok,
            "gf_matmul_launches_by_node": launched,
            "probe_p50_le_s": p50_le, "probe_mean_s": mean_s,
            "rot": {"volume": rot_v, "shard": sid, "offset": off,
                    "holder": holder},
            "flip_to_firing_s": fire_s, "bundle": bundle,
            "bundle_capture_s": cap_s, "resolve_s": resolve_s,
            "availability_transitions": history,
            "counts": counts})

        # 4. the killed master rejoins
        t4 = time.perf_counter()
        cl.start(dead_master + "_rejoined", *master_argv[dead_master],
                 env=master_env)
        cl.procs[dead_master] = cl.procs[dead_master + "_rejoined"]
        cl.killed.discard(dead_master)
        back = ports[dead_master]

        def rejoined() -> bool:
            me = _raft_of(cl, back)
            lead_port = one_leader(alive_masters())
            if lead_port is None or me["role"] != "follower":
                return False
            top = _raft_of(cl, lead_port)
            return (me["leaderId"] == f"127.0.0.1:{lead_port}"
                    and me["commitIndex"] >= top["commitIndex"])

        cl.wait_for("the restarted master a caught-up follower", rejoined,
                    QUORUM_S)
        rejoin_s = time.perf_counter() - t4
        new = one_leader(alive_masters())
        cl.master_port = new
        done = {k for k, j in lifecycle_jobs(new).items()
                if j["state"] == "done"}
        cl.wait_for("the rejoined master's done jobs equal", lambda: {
            k for k, j in lifecycle_jobs(back).items()
            if j["state"] == "done"} == done, QUORUM_S)
        me = _raft_of(cl, back)
        step("rejoin", {"master": dead_master, "rejoin_s": rejoin_s,
                        "role": me["role"], "term": me["term"],
                        "commit_index": me["commitIndex"],
                        "leader": by_port[new], "done_jobs": len(done)})

        # 5. a dead node under the quorum
        spread = _ec_spread(cl)
        most = {n: max(len(spread[v].get(cl.nodes[n]["url"], []))
                       for v in vids) for n in names}
        victim = "d" if most["d"] <= 4 else next(
            n for n in reversed(names) if most[n] <= 4)
        v_url = cl.nodes[victim]["url"]
        lost = [(v, s) for v in vids for s in spread[v].get(v_url, [])]
        lost_sha = dict(zip(lost, _parallel_sha256(
            [os.path.join(dirs[victim], f"{v}.ec{s:02d}")
             for v, s in lost])))
        # 6a. one degraded GET, traced: the lead needle of a volume D
        # held a data shard of, from a survivor whose holder map (warmed
        # by an untraced GET first) still names D, right after the kill:
        # D's interval fails over to a decode before any repair can start
        trace_v = next(v for v in vids
                       if any(s < 10 for s in spread[v].get(v_url, [])))
        server = next(n for n in names if n != victim)
        ld = leads[trace_v]
        lead_fid = "/" + _fid(trace_v, ld["key"], ld["cookie"])
        reader_conn = _KeepAlive(cl.nodes[server]["port"])
        status, _h, body = reader_conn.request("GET", lead_fid)
        if status != 200 or hashlib.sha256(body).hexdigest() \
                != ld["data_sha256"]:
            raise AssertionError(f"lead needle GET: {status}, body differs")
        rng = np.random.default_rng(seed + 80)
        trace_id = "".join(f"{x:02x}" for x in rng.integers(0, 256, 16))
        traceparent = (f"00-{trace_id}-"
                       + "".join(f"{x:02x}" for x in rng.integers(
                           0, 256, 8)) + "-01")
        s_before = cl.scrape(server)
        before = scrape_all()
        before.pop(victim)
        t_kill = time.perf_counter()
        cl.killed.add(victim)
        cl.procs[victim].kill()
        cl.procs[victim].wait()
        status, _h, body = reader_conn.request(
            "GET", lead_fid, headers={"traceparent": traceparent})
        if status != 200 or hashlib.sha256(body).hexdigest() \
                != ld["data_sha256"]:
            raise AssertionError(f"traced GET: {status}, body differs")
        decoded = _launches_moved(s_before, cl.scrape(server))
        cl.wait_for("the leader drops the dead node", lambda: v_url not in
                    cl.http_json("/dir/status")["DataNodes"], QUORUM_S)
        detect_s = time.perf_counter() - t_kill
        got_reads: dict = {}

        def reads() -> None:
            try:
                got_reads["row"] = _maintenance_get_pass(cl, records)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                got_reads["error"] = e

        reader = threading.Thread(target=reads, name="quorum-gets")
        reader.start()

        def repaired() -> bool:
            sp = _ec_spread(cl)
            return all(sum(map(len, sp.get(v, {}).values())) == 14
                       and v_url not in sp.get(v, {}) for v in vids)

        cl.wait_for("every volume back to 14 shards", repaired, QUORUM_S)
        recover_s = time.perf_counter() - t_kill
        reader.join()
        if "error" in got_reads:
            raise got_reads["error"]
        read_row = got_reads["row"]
        read_row["started_after_kill_s"] = read_row.pop("t_start") - t_kill
        read_row["ended_after_kill_s"] = read_row.pop("t_end") - t_kill
        read_row["during_repair"] = \
            read_row["started_after_kill_s"] < recover_s
        after = scrape_all()
        counts = counted("repair", before, after)
        spread2 = _ec_spread(cl)
        rebuilt = {}
        for v, s in lost:
            url = next(u for u, sids in spread2[v].items() if s in sids)
            rebuilt[(v, s)] = os.path.join(dirs[urls[url]],
                                           f"{v}.ec{s:02d}")
        got = dict(zip(rebuilt, _parallel_sha256(list(rebuilt.values()))))
        if got != lost_sha:
            bad = [k for k in lost_sha if got[k] != lost_sha[k]]
            raise AssertionError(f"rebuilt shards differ: {bad}")
        targets = sorted({os.path.basename(os.path.dirname(p))
                          for p in rebuilt.values()})
        for n in targets:
            if codec == "cuda" and not counts[n]["launches"][
                    "gf_matmul_batched"]:
                raise AssertionError(f"repair: no batched launch on the "
                                     f"rebuild target {n}: {counts[n]}")
        mass = {k: j for k, j in lifecycle_jobs(new).items()
                if k[1] == "mass_repair"}
        affected = sorted({v for v, _s in lost})
        if sorted(v for v, _t in mass) != affected or any(
                j["state"] != "done" for j in mass.values()):
            raise AssertionError(f"mass_repair jobs: {mass}")
        step("dead_node", {"killed": victim,
                           "most_shards_per_volume": most,
                           "detect_s": detect_s,
                           "time_to_recover_s": recover_s,
                           "repair_s": recover_s - detect_s,
                           "lost_shards": len(lost),
                           "affected_volumes": affected,
                           "sha256_equal": True, "targets": targets,
                           "mass_repair_done": len(mass),
                           "counts": counts})
        step("gets_during_repair", read_row)

        # 6. tracing: the stitched degraded GET, then the hot keys
        server_url = cl.nodes[server]["url"]

        live_urls = {cl.nodes[n]["url"] for n in names if n != victim}

        def stitched() -> bool:
            """/cluster/traces fans the query out to every live node: the
            serving process's GET span and its decode's spans, parented
            in it, and every live volume process answered.  The shard
            reads the decode gathered from the other volume processes
            are gRPC streams, which carry the trace id but are counted,
            not spanned (pb/rpc.py, as in the reference)."""
            doc = cl.http_json(f"/cluster/traces?trace={trace_id}")
            at = [sp for sp in doc["spans"] if sp["instance"] == server_url]
            names_at = {sp["name"] for sp in at}
            return ({"volumeServer.get", "ec.reconstruct"} <= names_at
                    and all(not sp["orphan"] for sp in at
                            if sp["name"] == "ec.reconstruct")
                    and live_urls <= set(doc["nodes"]))

        try:
            cl.wait_for("the degraded GET stitched", stitched, 30.0)
        except AssertionError:
            doc = cl.http_json(f"/cluster/traces?trace={trace_id}")
            raise AssertionError(f"trace {trace_id}: {doc}")
        doc = cl.http_json(f"/cluster/traces?trace={trace_id}")
        hot_v = vids[-1]
        hot_keys = sorted(records[hot_v])[:QUORUM_HOT_KEYS]
        hot_fids = {str(FileId.parse(_fid(hot_v, k, records[hot_v][k][
            "cookie"]))) for k in hot_keys}
        client = _KeepAlive(cl.nodes[server]["port"])
        for _ in range(QUORUM_HOT_READS):
            for k in hot_keys:
                st, _h, b = client.request("GET", "/" + _fid(
                    hot_v, k, records[hot_v][k]["cookie"]))
                if st != 200 or hashlib.sha256(b).hexdigest() \
                        != records[hot_v][k]["data_sha256"]:
                    raise AssertionError(f"hot GET of {k:x}: {st}")
        hot = cl.http_json(f"/cluster/hot?n={QUORUM_HOT_KEYS}")
        listed = {e["key"] for w_ in ("current", "previous")
                  for e in hot["dims"].get("needle", {}).get(w_, [])}
        if not hot_fids <= listed:
            raise AssertionError(f"/cluster/hot lists {sorted(listed)}, "
                                 f"not every key of {sorted(hot_fids)}")
        step("tracing", {
            "trace_id": trace_id, "volume": trace_v, "served_by": server,
            "decoded_launches": decoded,
            "instances": sorted({urls.get(s["instance"], by_port.get(
                int(s["instance"].rsplit(":", 1)[1]), s["instance"]))
                for s in doc["spans"]}),
            "span_names": sorted({s["name"] for s in doc["spans"]}),
            "nodes": {urls.get(i, by_port.get(int(i.rsplit(":", 1)[1]), i)):
                      n["spanCount"] for i, n in doc["nodes"].items()},
            "duration_ms": doc.get("durationMs"),
            "hot_keys_listed": len(hot_fids), "hot_nodes": len(hot["nodes"])})
        if codec == "cuda" and not decoded["gf_matmul"]:
            raise AssertionError(f"the traced GET decoded nothing on "
                                 f"{server}: {decoded}")

        # 7. SIGTERM: clean exits
        step("stop", {"exits": cl.terminate(
            [n for n in names if n != victim] + [
                m for m in QUORUM_MASTERS if m != dead_master]
            + [dead_master + "_rejoined"])})
    except BaseException:
        print(cl.tails(), file=sys.stderr, flush=True)
        raise
    finally:
        cl.stop_all()
    summary = {"phase": "quorum_summary",
               "wall_s": time.perf_counter() - t_phase,
               "launches_by_path": paths, "nvidia_smi": power}
    emit(summary)
    return {"launches_by_path": paths, "rows": rows}


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


# -- the mesh phase (parallel/ and the xor and bit-plane kernels) -----------

MESH_WIDTHS = (1, 7, 4099, 16 * MIB)
MESH_PLANS = 20  # seeded decode plans of 1-4 lost rows
MESH_VOLUMES = 64  # BASELINE config 4's volume count
MESH_VOLUME_BYTES = (32 * MIB, 96 * MIB)  # uneven sizes, ~4 GiB in all
VIRTUAL_VOLUMES = 16
VIRTUAL_VOLUME_BYTES = (8 * MIB, 24 * MIB)  # ~256 MiB in all
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate (data sheet)
SHA_THREADS = 8


def _sha_many(paths: list[str]) -> list[str]:
    with ThreadPoolExecutor(SHA_THREADS) as pool:
        return list(pool.map(sha256_of, paths))


def _zero_mesh_launches(rs_cuda, rs_xor, rs_bitplane) -> None:
    _zero_launches(rs_cuda)
    rs_xor.gf_apply_xor_batched.launches = 0
    rs_bitplane.gf_apply_bitplane.launches = 0


def _mesh_launches(rs_cuda, rs_xor, rs_bitplane) -> dict:
    return {**_launches(rs_cuda),
            "gf_xor": rs_xor.gf_apply_xor_batched.launches,
            "gf_bitplane_mma": rs_bitplane.gf_apply_bitplane.launches}


def mesh_plans(gf256, seed: int) -> list[tuple[str, np.ndarray]]:
    """The RS(10,4) parity matrix and MESH_PLANS seeded decode plans of 1
    to 4 lost shards (data and parity, any mix)."""
    rng = np.random.default_rng(seed)
    full = gf256.rs_matrix(10, 14)
    out = [("parity", gf256.rs_parity_matrix(10, 4))]
    for i in range(MESH_PLANS):
        lost = tuple(sorted(int(x) for x in
                            rng.choice(14, 1 + i % 4, replace=False)))
        present = [j for j in range(14) if j not in lost]
        out.append((f"plan{list(lost)}",
                    gf256.decode_plan_for(full, 10, present, lost)))
    return out


BITPLANE_SHAPES = ((1, 2, 3, 4, 10, 14), (1, 2, 5, 10, 14, 16),
                   (1, 7, 16, 33, 1024, 1028, 4099),  # 1028: 4-byte rows
                   (0, 4, 1))  # R, S, B, offset


def mesh_kernels_vs_plain(rs_cuda, rs_xor, rs_bitplane, plans, gen,
                          widths=MESH_WIDTHS) -> dict:
    """gf_xor (one entry and batched) and gf_bitplane_mma against their
    plain versions on the card, for every matrix of `plans` at every width
    of `widths` (batched entries are 1-byte-offset views: unaligned rows
    and entry strides), and both kernels for a seeded matrix of each
    (R, S) of BITPLANE_SHAPES at each width, on rows 16-byte aligned and
    4 and 1 bytes past (each of their access paths; gf_xor on the side
    rs_xor.horner_side picks, one entry and a batch of 2, and one entry
    on the other side, so both of its kernels run at every shape).
    gf_xor compiles
    nothing per matrix: the kernel cache's compile count
    (rs_cuda.cache_stats) must not move.  -> the largest error of each
    (0, or the run has already failed)."""
    t0 = time.perf_counter()
    worst = {"gf_xor": 0, "gf_bitplane_mma": 0}
    cases = 0
    compiles = rs_cuda.cache_stats()["compiles"]

    def check(name, got, want, what):
        nonlocal cases
        if got.device.type == "cuda":
            torch.cuda.synchronize()
        err = max_abs_err(got, want)
        cases += 1
        if err:
            raise AssertionError(f"{name} != plain for {what}: "
                                 f"max_abs_err {err}")
        worst[name] = max(worst[name], err)

    for b in widths:
        data = random_u8((10, b), gen)
        batch = random_u8((3, 10, b + 1), gen)[:, :, 1:]
        for name, m in plans:
            check("gf_xor", rs_xor.gf_apply_xor(m, data),
                  rs_xor.gf_apply_xor_reference(m, data), f"{name} B={b}")
            check("gf_xor", rs_xor.gf_apply_xor_batched(m, batch),
                  rs_xor.gf_apply_xor_batched_reference(m, batch),
                  f"{name} V=3 B={b} offset 1")
            check("gf_bitplane_mma", rs_bitplane.gf_apply_bitplane(m, data),
                  rs_bitplane.gf_apply_bitplane_reference(m, data),
                  f"{name} B={b}")
        del data, batch
        if gen.device.type == "cuda":
            torch.cuda.empty_cache()
    rng = np.random.default_rng(5)
    rows_r, rows_s, shape_widths, offsets = BITPLANE_SHAPES
    for r in rows_r:
        for s in rows_s:
            m = rng.integers(0, 256, (r, s), dtype=np.uint8)
            for b in shape_widths:
                for off in offsets:
                    # 2 entries of rows of stride b + 16 + off starting
                    # `off` bytes past a 16-byte boundary: the kernels'
                    # output rows are their own, so the input carries the
                    # unaligned paths
                    views = random_u8((2, s, b + 16 + off),
                                      gen)[:, :, off:off + b]
                    what = f"R={r} S={s} B={b} offset {off}"
                    check("gf_bitplane_mma",
                          rs_bitplane.gf_apply_bitplane(m, views[0]),
                          rs_bitplane.gf_apply_bitplane_reference(
                              m, views[0]), what)
                    want = torch.stack([rs_xor.gf_apply_xor_reference(m, x)
                                        for x in views])
                    check("gf_xor", rs_xor.gf_apply_xor(m, views[0]),
                          want[0], what)
                    check("gf_xor", rs_xor.gf_apply_xor_batched(m, views),
                          want, f"{what} V=2")
                    other = not rs_xor.horner_side(r, s)
                    check("gf_xor", rs_xor.gf_apply_xor(m, views[0], other),
                          want[0], f"{what} horner={other}")
    if rs_cuda.cache_stats()["compiles"] != compiles:
        raise AssertionError("the xor and bit-plane kernels compiled per "
                             "matrix: rs_cuda.cache_stats() compiles "
                             f"{compiles} -> "
                             f"{rs_cuda.cache_stats()['compiles']}")
    row = {"phase": "mesh_kernels_vs_plain", "matrices": len(plans),
           "widths": list(widths), "bitplane_shapes": BITPLANE_SHAPES,
           "cases": cases, "byte_equal": True, "max_abs_err": worst,
           "compiles": compiles, "wall_s": time.perf_counter() - t0}
    emit(row)
    return row


def _timed(fn, plain=None, plain_reps: int = 3) -> dict:
    out = {"ms": time_ms(fn), "back_to_back_ms": time_back_to_back_ms(fn)}
    if plain is not None:
        out["plain_ms"] = time_ms(plain, reps=plain_reps, warmup=1)
    return out


def _bound_row(t_bytes_ms: float, t_ops_ms: float) -> dict:
    return {"bound_ms": max(t_bytes_ms, t_ops_ms),
            "bound_by": "bytes" if t_bytes_ms >= t_ops_ms else "operations",
            "bytes_ms": t_bytes_ms, "ops_ms": t_ops_ms}


XOR_SIDE_SHAPES = ((1, 4, 10, 16), (1, 2, 4, 10, 16))  # R, S


def xor_sides(rs_xor, gen, b: int) -> list:
    """gf_xor's two kernels back to back on a seeded (R, S) matrix of each
    shape of XOR_SIDE_SHAPES at `b` bytes per shard: the chains on the
    outputs (`horner_ms`) and on the sources (`sources_ms`), each beside
    the operations rs_xor.xor_ops counts for it, and whether the side
    rs_xor.horner_side picks was the faster in this run."""
    rng = np.random.default_rng(7)
    rows_r, rows_s = XOR_SIDE_SHAPES
    data = random_u8((max(rows_s), b), gen)
    out = []
    for r in rows_r:
        for s in rows_s:
            m = rng.integers(1, 256, (r, s), dtype=np.uint8)
            x = data[:s]
            row = {"shape": [r, s],
                   "bytes_ms": (r + s) * b / HBM_BYTES_PER_S * 1e3}
            for side, horner in (("horner", True), ("sources", False)):
                row[f"{side}_ms"] = time_back_to_back_ms(
                    lambda: rs_xor.gf_apply_xor(m, x, horner))
                row[f"{side}_ops"] = rs_xor.xor_ops(m, b, horner=horner)
            picked = rs_xor.horner_side(r, s)
            row["picked"] = "horner" if picked else "sources"
            row["picked_faster"] = (row["horner_ms"] <= row["sources_ms"]
                                    ) == picked
            out.append(row)
    del data
    return out


def mesh_kernel_timing(rs_cuda, rs_xor, rs_bitplane, gf256, gf_network, gen,
                       power: str) -> dict:
    """RS(10,4) parity at 16 MiB per shard through each kernel: one launch
    (`ms`) and back to back, beside its bound and its plain version's
    time.  gf_xor also on the (4, 10) decode of .ec00-.ec03 at 16 MiB,
    with the operations it issues for each (rs_xor.xor_ops, the chains on
    the outputs for both), and both of its kernels back to back on seeded
    matrices of XOR_SIDE_SHAPES (`gf_xor_sides`: the times behind
    rs_xor.horner_side's choice).  gf_bitplane_mma also on the mesh
    rebuild's plans at 16 MiB: the
    (4, 10) decode of .ec00-.ec03 and its first 5 sources, the partial of
    a dp = 2 mesh; beside it torch._int_mm of the parity's bit-plane
    product alone (int32 sums of the (8R, 8S) bit matrix, at least 24
    rows, and the (8S, B) planes, column-major as cuBLASLt takes them), a
    yardstick the port never calls; gf_bitslice (gf_apply) on the same
    data."""
    m = gf256.rs_parity_matrix(10, 4)
    r, s = m.shape
    b = 16 * MIB
    data = random_u8((s, b), gen)
    rows = {}

    def ms_of(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    # gf_xor and gf_bitslice compute one function, so they share its bound:
    # each input and output byte once, and the fewest operations known to
    # compute it (the bit-sliced network's).  The xor kernel's own count
    # (rs_xor.xor_ops: the doublings, the combination tables and the XORs
    # of their reads) is what it chose to issue, not a bound: it is
    # reported beside it.  The (4, 10) decode of .ec00-.ec03 beside the
    # parity: the same shape, another matrix.
    plan = rebuild_plan(gf256)
    for name, xm in (("gf_xor", m), ("gf_xor_decode", plan)):
        bd = bound(gf_network, xm, b)
        ops = rs_xor.xor_ops(xm, b)
        rows[name] = {**_timed(
            lambda: rs_xor.gf_apply_xor(xm, data),
            lambda: rs_xor.gf_apply_xor_reference(xm, data)),
            **_bound_row(bd["bytes_ms"], bd["alu_ms"]),
            "shape": list(xm.shape), "kernel_ops": ops,
            "kernel_ops_ms": ops / INT32_OPS_PER_S * 1e3}
    for name, pm in (("gf_bitplane_mma", m), ("gf_bitplane_mma_decode",
                                              plan),
                     ("gf_bitplane_mma_partial",
                      np.ascontiguousarray(plan[:, :5]))):
        x = data[:pm.shape[1]]
        pr, ps = pm.shape
        # its bound: each input and output byte once, and the product's
        # 2 * 8R * 8S int8 operations a column at the tensor cores' rate
        int8_ops = 2 * 8 * pr * 8 * ps * b
        rows[name] = {**_timed(
            lambda: rs_bitplane.gf_apply_bitplane(pm, x),
            lambda: rs_bitplane.gf_apply_bitplane_reference(pm, x)),
            **_bound_row(ms_of((ps + pr) * b),
                         int8_ops / INT8_OPS_PER_S * 1e3),
            "shape": [pr, ps], "int8_ops": int8_ops,
            "function_bytes": (ps + pr) * b}
    a = torch.zeros((max(8 * r, 24), 8 * s), dtype=torch.int8,
                    device=data.device)  # _int_mm wants more than 16 rows
    a[:8 * r] = torch.from_numpy(gf256.bit_matrix(m).astype(np.int8))
    bits = rs_bitplane.bit_unpack_reference(data).t().contiguous().t()
    mm_ops = 2 * a.shape[0] * a.shape[1] * b
    rows["int_mm"] = {**_timed(lambda: torch._int_mm(a, bits)),
                      **_bound_row(ms_of(a.numel() + bits.numel()
                                         + 4 * a.shape[0] * b),
                                   mm_ops / INT8_OPS_PER_S * 1e3),
                      "shape": [list(a.shape), list(bits.shape)]}
    del bits
    rows["gf_bitslice"] = {**_timed(lambda: rs_cuda.gf_apply(m, data)),
                           **_bound_row(bd["bytes_ms"], bd["alu_ms"])}
    for row in rows.values():
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["share_of_bound_back_to_back"] = (row["bound_ms"]
                                              / row["back_to_back_ms"])
        row["GBps"] = (row.get("function_bytes", (s + r) * b)
                       / row["back_to_back_ms"] / 1e6)
    out = {"phase": "mesh_kernel_timing", "matrix": "parity",
           "bytes_per_shard": b, "kernels": rows,
           "gf_xor_sides": xor_sides(rs_xor, gen, b), "card": power}
    emit(out)
    del data
    torch.cuda.empty_cache()
    return out


def make_raw_volumes(work: str, count: int, sizes: tuple, seed: int,
                     gen, prefix: str) -> list[str]:
    """`count` .dat files of seeded random bytes, sizes uniform in `sizes`
    (bytes, uneven), made on the card; -> their base paths."""
    rng = np.random.default_rng(seed)
    bases = []
    for i in range(count):
        size = int(rng.integers(sizes[0], sizes[1] + 1))
        base = os.path.join(work, f"{prefix}{i}")
        with open(base + ".dat", "wb") as f:
            f.write(random_u8((size,), gen).cpu().numpy().tobytes())
        bases.append(base)
    return bases


def _shard_paths(bases: list[str]) -> list[str]:
    return [b + f".ec{i:02d}" for b in bases for i in range(14)]


def _remove_shards(bases: list[str], ids=range(14)) -> None:
    for b in bases:
        for i in ids:
            os.remove(b + f".ec{i:02d}")


def mesh_file_flows(rs_cuda, rs_xor, rs_bitplane, enc, pbatch, mesh,
                    bases: list[str], label: str, power: str,
                    codec_flows: bool) -> dict:
    """The config-4 flows on `mesh` over `bases`: each volume encoded alone
    with generate_ec_files on `cuda` (the shards to hold against, sha256),
    then batch_generate_ec_files over all of them (byte-identical), then
    one volume's .ec00-.ec03 lost and rebuilt with mesh_rebuild_ec_files
    (byte-identical).  With `codec_flows`, that volume is also encoded on
    `cuda_xor` and rebuilt on `cuda_bitplane` (their direct routes, their
    kernels).  Counts are zeroed just before each flow and read just
    after.  -> the rows and each flow's launches."""
    rows, paths = {}, {}
    dat_bytes = sum(os.path.getsize(b + ".dat") for b in bases)
    os.environ["SEAWEEDFS_TPU_EC_SERVICE"] = "0"  # the direct route
    try:
        t0 = time.perf_counter()
        for b in bases:
            enc.generate_ec_files(b, codec_name="cuda")
        serial_s = time.perf_counter() - t0
    finally:
        del os.environ["SEAWEEDFS_TPU_EC_SERVICE"]
    t0 = time.perf_counter()
    want = dict(zip(_shard_paths(bases), _sha_many(_shard_paths(bases))))
    serial_sha_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _remove_shards(bases)
    remove_s = time.perf_counter() - t0

    def flow(name, fn, nbytes, check_paths, **extra):
        _zero_mesh_launches(rs_cuda, rs_xor, rs_bitplane)
        t0 = time.perf_counter()
        result = fn()
        wall = time.perf_counter() - t0
        launches = _mesh_launches(rs_cuda, rs_xor, rs_bitplane)
        t0 = time.perf_counter()
        got = _sha_many(check_paths)
        sha_s = time.perf_counter() - t0
        bad = [p for p, h in zip(check_paths, got) if h != want[p]]
        if bad:
            raise AssertionError(f"{label} {name}: {len(bad)} shard files "
                                 f"differ, first {bad[0]}")
        row = {"phase": f"mesh_{label}_{name}", "mesh": dict(mesh.shape),
               "volumes": len(bases), "seconds": wall,
               "GBps": nbytes / wall / 1e9, "launches": launches,
               "sha256_equal": len(check_paths), "sha256_s": sha_s,
               **extra, "card": power}
        emit(row)
        rows[name] = row
        paths[name] = launches
        return result

    flow("batch_encode", lambda: pbatch.batch_generate_ec_files(
        bases, mesh=mesh), dat_bytes, _shard_paths(bases),
        serial_cuda_seconds=serial_s,
        serial_cuda_GBps=dat_bytes / serial_s / 1e9,
        serial_sha256_s=serial_sha_s, serial_remove_s=remove_s)
    if paths["batch_encode"]["gf_matmul_batched"] < 1:
        raise AssertionError(f"{label}: the batch encode launched nothing")
    one = max(bases, key=lambda b: os.path.getsize(b + ".dat"))
    shard = os.path.getsize(one + ".ec04")
    lost = [one + f".ec{i:02d}" for i in range(4)]
    _remove_shards([one], range(4))
    got = flow("mesh_rebuild", lambda: pbatch.mesh_rebuild_ec_files(
        one, mesh=mesh), 10 * shard, lost)
    # one distributed_reconstruct per slice, one launch per mesh entry
    slices = -(-shard // enc.DEFAULT_SLICE)
    if got != [0, 1, 2, 3] or paths["mesh_rebuild"]["gf_bitplane_mma"] \
            != slices * mesh.size:
        raise AssertionError(f"{label} mesh rebuild: {got}, "
                             f"{paths['mesh_rebuild']}, {slices} slices")
    if codec_flows:
        _remove_shards([one])
        flow("cuda_xor_encode", lambda: enc.generate_ec_files(
            one, codec_name="cuda_xor"), os.path.getsize(one + ".dat"),
            _shard_paths([one]))
        _remove_shards([one], range(4))
        flow("cuda_bitplane_rebuild", lambda: enc.rebuild_ec_files(
            one, codec_name="cuda_bitplane"), 10 * shard, lost)
        # the codec's rebuild: one gf_apply_bitplane, one launch, a slice
        if not paths["cuda_xor_encode"]["gf_xor"] or (
                paths["cuda_bitplane_rebuild"]["gf_bitplane_mma"]
                != slices):
            raise AssertionError(f"codec flows missed their kernels: "
                                 f"{paths}")
    return {"rows": rows, "launches_by_path": paths}


def mesh_service(rs_cuda, gf256, codec_service, metrics, mesh, label: str,
                 gen, widths=tuple(4 * MIB + 11 * i for i in range(6))
                 ) -> dict:
    """A burst of encode and decode jobs through a device-mode
    CodecService on `mesh` (None: the service's own make_mesh(), every
    card; on a CPU generator the 1x1 mesh of the CPU), each
    result equal to the host `cpu` codec's; one vectored submit per kind
    to the idle service, so the launches are exact: one per batch on a
    1x1 mesh, one per entry holding work and batch on a larger one."""
    from seaweedfs_tpu_torch.ops.codec import get_codec

    cpu = get_codec("cpu")
    plan = rebuild_plan(gf256)
    jobs = [random_u8((10, wd), gen).cpu().numpy() for wd in widths]
    svc = codec_service.CodecService(
        mode="device", mesh=mesh,
        device=None if mesh or gen.device.type == "cuda" else gen.device)
    child = metrics.EC_SERVICE_BATCH_JOBS.labels()
    try:
        out = {}
        for kind in ("parity", "apply"):
            _, n0 = hist_snapshot(child)
            l0 = rs_cuda.gf_apply_batched.launches
            if kind == "parity":
                futs = svc.submit_parity_many(jobs)
                want = [cpu.parity_of(j) for j in jobs]
            else:
                futs = svc.submit_apply_many(plan, jobs)
                want = [np.stack(cpu.apply_rows(plan, list(j))) for j in jobs]
            got = [np.stack([np.asarray(r) for r in f.result(120)])
                   for f in futs]
            launches = rs_cuda.gf_apply_batched.launches - l0
            batches = hist_snapshot(child)[1] - n0
            if any(not np.array_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{label} service {kind}: a job "
                                     "differs from the cpu codec")
            per_batch = 1 if svc.mesh.size == 1 else svc.mesh.size
            if launches != per_batch * batches:
                raise AssertionError(
                    f"{label} service {kind}: {launches} launches for "
                    f"{batches} batches on a {svc.mesh.shape} mesh")
            out[kind] = {"jobs": len(jobs), "batches": batches,
                         "launches": launches}
    finally:
        svc.close()
    row = {"phase": f"mesh_{label}_service", "mesh": dict(svc.mesh.shape),
           **out, "equal_to_cpu": True}
    emit(row)
    return row


def phase_mesh(rs_cuda, rs_xor, rs_bitplane, gf256, gf_network, enc,
               codec_service, metrics, work: str, seed: int, gen,
               power: str, reduced: list[str], widths=MESH_WIDTHS,
               config4=(MESH_VOLUMES, MESH_VOLUME_BYTES),
               virtual_volumes=(VIRTUAL_VOLUMES, VIRTUAL_VOLUME_BYTES),
               burst_widths=None) -> dict:
    """parallel/ on the card: the new kernels against their plain versions
    and timed, BASELINE config 4 on the 1x1 mesh of the card, the same
    flows on a virtual 2x4 mesh of the one card, dryrun_multidevice(8) and
    the codec service on make_mesh() and on the virtual mesh.  Everything
    runs on the generator's device: a CPU generator (the tests' rehearsal)
    runs the same flows on CPU meshes and times nothing."""
    from seaweedfs_tpu_torch.parallel import batch as pbatch
    from seaweedfs_tpu_torch.parallel.dryrun import dryrun_multidevice
    from seaweedfs_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    steps_s = {}

    def step(name: str) -> None:
        steps_s[name] = time.perf_counter() - t_phase - sum(steps_s.values())
    on_card = gen.device.type == "cuda"
    checked = mesh_kernels_vs_plain(rs_cuda, rs_xor, rs_bitplane,
                                    mesh_plans(gf256, seed), gen, widths)
    step("kernels_vs_plain")
    timing = (mesh_kernel_timing(rs_cuda, rs_xor, rs_bitplane, gf256,
                                 gf_network, gen, power) if on_card
              else {"kernels": "not measured: no card"})
    step("timing")
    card = make_mesh() if on_card else make_mesh([gen.device])
    virtual = make_mesh([gen.device] * 8)  # the one device, repeated
    paths = {}
    t0 = time.perf_counter()
    bases = make_raw_volumes(work, config4[0], config4[1], seed, gen, "c4v")
    emit({"phase": "mesh_config4_volumes", "volumes": len(bases),
          "bytes": sum(os.path.getsize(b + ".dat") for b in bases),
          "seconds": time.perf_counter() - t0, "reduced": reduced})
    step("config4_volumes")
    c4 = mesh_file_flows(rs_cuda, rs_xor, rs_bitplane, enc, pbatch, card,
                         bases, "config4", power, codec_flows=True)
    for b in bases:
        for p in [b + ".dat"] + _shard_paths([b]):
            os.remove(p)
    step("config4_flows")
    paths.update({f"config4_{k}": v
                  for k, v in c4["launches_by_path"].items()})
    vbases = make_raw_volumes(work, virtual_volumes[0], virtual_volumes[1],
                              seed + 1, gen, "vv")
    vm = mesh_file_flows(rs_cuda, rs_xor, rs_bitplane, enc, pbatch, virtual,
                         vbases, "virtual2x4", power, codec_flows=False)
    paths.update({f"virtual2x4_{k}": v
                  for k, v in vm["launches_by_path"].items()})
    step("virtual2x4_flows")
    _zero_mesh_launches(rs_cuda, rs_xor, rs_bitplane)
    t0 = time.perf_counter()
    dry = dryrun_multidevice(8, device=None if on_card else gen.device)
    paths["dryrun"] = _mesh_launches(rs_cuda, rs_xor, rs_bitplane)
    emit({"phase": "mesh_dryrun", **dry, "seconds": time.perf_counter() - t0,
          "launches": paths["dryrun"]})
    step("dryrun")
    services = {}
    for label, mesh in (("card", None), ("virtual2x4", virtual)):
        _zero_mesh_launches(rs_cuda, rs_xor, rs_bitplane)
        services[label] = mesh_service(
            rs_cuda, gf256, codec_service, metrics, mesh, label, gen,
            **({} if burst_widths is None else {"widths": burst_widths}))
        paths[f"service_{label}"] = _mesh_launches(rs_cuda, rs_xor,
                                                   rs_bitplane)
    step("services")
    summary = {"phase": "mesh_summary", "wall_s": time.perf_counter()
               - t_phase, "steps_s": steps_s, "launches_by_path": paths,
               "card": power}
    emit(summary)
    return {"checked": checked, "timing": timing, "config4": c4,
            "virtual": vm, "dryrun": dry, "services": services,
            "launches_by_path": paths}


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
    # the volumes of phases 4-4f and 7 are sized so that the whole script
    # ends within its 1200 s on a card whose host runs ~25 % slow
    ap.add_argument("--volume-gib", type=float, default=10.5)
    ap.add_argument("--service-volume-gib", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--store-volume-gib", type=float, default=3.0)
    ap.add_argument("--only-ec-reads", action="store_true",
                    help="phases 1-4b only, no kernels line (a quick check)")
    ap.add_argument("--only-store", action="store_true",
                    help="phases 1-3 and store_lifecycle only, no kernels "
                    "line (a quick check)")
    ap.add_argument("--only-volume-server", action="store_true",
                    help="phases 1-2, volume_server and http_plane only, "
                    "on a volume of --store-volume-gib written for it, no "
                    "kernels line (a quick check)")
    ap.add_argument("--cluster-volume-gib", type=float,
                    default=CLUSTER_VOLUME_BYTES / GIB)
    ap.add_argument("--cluster-codec", default="cuda",
                    help="the volume processes' -ec.codec in the cluster "
                    "phase (cuda, their default, is not passed)")
    ap.add_argument("--only-cluster", action="store_true",
                    help="phases 1-2 and the cluster phase only, no kernels "
                    "line (a quick check)")
    ap.add_argument("--maintenance-volume-gib", type=float,
                    default=MAINT_VOLUME_BYTES / GIB,
                    help="each of the maintenance phase's 8 volumes")
    ap.add_argument("--only-maintenance", action="store_true",
                    help="phases 1-2 and the maintenance phase only, no "
                    "kernels line (a quick check)")
    ap.add_argument("--only-mesh", action="store_true",
                    help="phases 1-2 and the mesh phase only, no kernels "
                    "line (a quick check)")
    ap.add_argument("--tier-volume-gib", type=float,
                    default=TIER_VOLUME_BYTES / GIB,
                    help="each of the tier phase's 2 volumes")
    ap.add_argument("--only-tier", action="store_true",
                    help="phases 1-2 and the tier phase only, no kernels "
                    "line (a quick check)")
    ap.add_argument("--quorum-volume-gib", type=float,
                    default=QUORUM_VOLUME_BYTES / GIB,
                    help="each of the quorum phase's 4 sealed volumes")
    ap.add_argument("--only-quorum", action="store_true",
                    help="phases 1-2 and the quorum phase only, no kernels "
                    "line (a quick check)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from seaweedfs_tpu_torch.ops import (_build, codec_service, gf256,
                                         gf_network, rs_bitplane, rs_cuda,
                                         rs_xor)
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.storage.ec import encoder as enc

    global INT32_OPS_PER_S
    start = time.perf_counter()
    power = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    INT32_OPS_PER_S = int32_ops_per_s()
    t0 = time.perf_counter()
    # one nvcc per source, all started together: the GF kernels' host
    # library and the two kernel libraries of the mesh phase, and the
    # bit-plane and xor kernels' ptxas reports (registers, spills)
    with ThreadPoolExecutor(5) as pool:
        ptxas_bitplane = pool.submit(ptxas_report, _build, "gf_bitplane")
        ptxas_xor = pool.submit(ptxas_report, _build, "gf_xor")
        nvcc_s = dict(zip(("gf_launch", "gf_xor", "gf_bitplane"), pool.map(
            _timed_build, [_build] * 3, ("gf_launch", "gf_xor",
                                         "gf_bitplane"))))
        ptxas_bitplane = ptxas_bitplane.result()
        ptxas_xor = ptxas_xor.result()
    rs_cuda._lib()
    rs_xor.build_kernel()
    rs_bitplane.build_kernel()
    host_lib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rs_cuda.build_kernel()  # the RS(10,4) parity kernel, NVRTC
    parity_kernel_s = time.perf_counter() - t0
    print(power, flush=True)
    emit({"phase": "card_and_build", "nvidia_smi": power, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "int32_ops_per_s": INT32_OPS_PER_S,
          "host_lib_nvcc_s": host_lib_s, "nvcc_s": nvcc_s,
          "parity_kernel_s": parity_kernel_s,
          "nvrtc": _build.nvrtc_path(), "compile_s": compile_seconds(_build),
          "ptxas": [line for log in _build.COMPILE_LOGS.values()
                    for line in log.splitlines() if "Used" in line
                    or "spill" in line],
          "cache": rs_cuda.cache_stats(),
          "ptxas_gf_bitplane": ptxas_bitplane, "ptxas_gf_xor": ptxas_xor})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    err = phase_correctness(rs_cuda, gf256, _build, gen)

    def cluster() -> dict:
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            # the .dat, its 14 shards and the copies before the source's
            # delete (SKILL.md's disk trap)
            size, reduced = volume_size(
                work, int(args.cluster_volume_gib * GIB) // MIB * MIB,
                per_volume=3.5)
            reduced = [f"volume {size} bytes: SeaweedFS's default 30 GB "
                       "volume limit (-volumeSizeLimitMB 30000) cut for the "
                       "machine's disk (.dat + 14 shards + copies ~3.4x) "
                       "and the script's time limit"] + reduced
            return phase_cluster(rs_cuda, gf256, work, size, args.seed,
                                 power, reduced, codec=args.cluster_codec)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    def maintenance() -> dict:
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            # 8 x (.dat, 14 shards, copies in flight)
            size, reduced = volume_size(
                work, int(args.maintenance_volume_gib * GIB) // MIB * MIB,
                count=len(MAINT_NODES) * MAINT_VOLUMES_PER_NODE,
                per_volume=3.5)
            reduced = [f"8 volumes of {size} bytes (-volumeSizeLimitMB "
                       f"{size // MIB}): SeaweedFS's default 30 GB volume "
                       "limit cut for the machine's disk and the script's "
                       "run time"] + reduced
            return phase_maintenance(rs_cuda, gf256, work, size, args.seed,
                                     power, reduced,
                                     codec=args.cluster_codec)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    def mesh() -> dict:
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            reduced = [
                f"{MESH_VOLUMES} volumes of {MESH_VOLUME_BYTES[0] >> 20}-"
                f"{MESH_VOLUME_BYTES[1] >> 20} MiB of seeded bytes (~4 GiB): "
                "BASELINE config 4's 64 volumes, each cut from SeaweedFS's "
                "default 30 GB volume limit for the script's run time"]
            return phase_mesh(rs_cuda, rs_xor, rs_bitplane, gf256,
                              gf_network, enc, codec_service, metrics, work,
                              args.seed, gen, power, reduced)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    def tier() -> dict:
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            # 2 x (.dat, 14 shards, the object at the endpoint, copies)
            size, reduced = volume_size(
                work, int(args.tier_volume_gib * GIB) // MIB * MIB,
                count=len(TIER_NODES), per_volume=3.5)
            reduced = [f"2 volumes of {size} bytes (-volumeSizeLimitMB "
                       f"{size // MIB}): SeaweedFS's default 30 GB volume "
                       "limit cut for the script's run time, as 4g"
                       ] + reduced
            return phase_tier(rs_cuda, gf256, work, size, args.seed, power,
                              reduced, codec=args.cluster_codec)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    def quorum() -> dict:
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            # 4 x (.dat, 14 shards, copies in flight)
            size, reduced = volume_size(
                work, int(args.quorum_volume_gib * GIB) // MIB * MIB,
                count=len(QUORUM_NODES), per_volume=3.5)
            reduced = [f"reduced: from 30000 MB: 4 volumes of {size} bytes "
                       f"(-volumeSizeLimitMB {size // MIB}): SeaweedFS's "
                       "default 30 GB volume limit cut for the script's run "
                       "time, as 4g"] + reduced
            return phase_quorum(rs_cuda, gf256, work, size, args.seed,
                                power, reduced, codec=args.cluster_codec)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    for only, phase in (("only_cluster", cluster),
                        ("only_maintenance", maintenance),
                        ("only_mesh", mesh), ("only_tier", tier),
                        ("only_quorum", quorum)):
        if getattr(args, only):
            phase()
            emit({"phase": "done", "wall_s": time.perf_counter() - start,
                  only: True})
            emit({"ok": True, "device": {
                "platform": "gpu", "kind": kind,
                "count": torch.cuda.device_count()}})
            return 0
    if args.only_volume_server:
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            size, reduced = volume_size(
                work, int(args.store_volume_gib * GIB) // MIB * MIB,
                per_volume=2.6)
            make_volume(os.path.join(work, "1"), size, args.seed)
            phase_volume_server(rs_cuda, gf256, enc, metrics, work,
                                args.seed, power, reduced)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        emit({"phase": "done", "wall_s": time.perf_counter() - start,
              "only_volume_server": True})
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0
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
            reduced = [f"volume {size} bytes: SeaweedFS's default 30 GB "
                       "volume limit cut for the script's time limit, one "
                       "1 GB-block row kept"] + reduced
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
        reduced = [f"volume {size} bytes: SeaweedFS's default 30 GB volume "
                   "limit cut for the script's time limit, no 1 GB-block "
                   "row (phase 4 runs one)"] + reduced
        stored = phase_store_lifecycle(rs_cuda, gf256, enc, codec_service,
                                       metrics, work, size, args.seed,
                                       reduced)
        # the same volume, now served over gRPC
        served = (None if args.only_store else phase_volume_server(
            rs_cuda, gf256, enc, metrics, work, args.seed, power, reduced))
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
    server_paths = served["launches_by_path"]
    # the earlier phases' volume directories are gone: the cluster phase
    # starts in a fresh one, and the maintenance phase after it
    cluster_paths = cluster()["launches_by_path"]
    maint_paths = maintenance()["launches_by_path"]
    tier_paths = tier()["launches_by_path"]
    quorum_paths = quorum()["launches_by_path"]

    batched_err = phase_batched(rs_cuda, gf256, gen)
    phase_kernel_sweep(rs_cuda, gf256, gen, power)
    batched = time_batched(rs_cuda, gf256, gf_network, gen, power)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        size, reduced = volume_size(
            work, int(args.service_volume_gib * GIB) // MIB * MIB,
            SERVICE_VOLUMES)
        reduced = [f"{SERVICE_VOLUMES} volumes of {size} bytes: cut for the "
                   "script's time limit"] + reduced
        svc = phase_service(rs_cuda, gf256, enc, codec_service, metrics, work,
                            size, args.seed, reduced)
        phase_default_route(rs_cuda, enc, codec_service,
                            os.path.join(work, "1"), size)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    meshed = mesh()
    mesh_paths = meshed["launches_by_path"]
    mesh_err = meshed["checked"]["max_abs_err"]
    mesh_times = meshed["timing"]["kernels"]

    def mesh_launches(kernel: str) -> dict:
        return {p: c[kernel] for p, c in mesh_paths.items() if c[kernel]}

    def mesh_kernel(name: str, source: str, replaces: str, launches: dict,
                    err: int, times: dict, **extra) -> dict:
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches, "max_abs_err": err,
                **{k: times[k] for k in (
                    "ms", "back_to_back_ms", "plain_ms", "bound_ms",
                    "bound_by")}, "library_ms": None, **extra}

    source = "seaweedfs_tpu_torch/ops/csrc/gf_bitslice.cu"
    emit({"kernels": [{
        "name": "gf_matmul", "route": "cuda", "source": source,
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:44",
        "launches": e2e["encode_launches"] + e2e["rebuild_launches"]
        + reads["read_launches"] + reads["rebuild_launches"]
        + sum(store_paths["gf_matmul"].values())
        + sum(server_paths["gf_matmul"].values())
        + sum(cluster_paths["gf_matmul"].values())
        + sum(maint_paths["gf_matmul"].values())
        + sum(tier_paths["gf_matmul"].values())
        + sum(quorum_paths["gf_matmul"].values()),
        "launches_by_path": {
            "encode": e2e["encode_launches"],
            "rebuild": e2e["rebuild_launches"],
            "ec_reads": reads["read_launches"],
            "remote_rebuild": reads["rebuild_launches"],
            **store_paths["gf_matmul"], **server_paths["gf_matmul"],
            **cluster_paths["gf_matmul"], **maint_paths["gf_matmul"],
            **tier_paths["gf_matmul"], **quorum_paths["gf_matmul"]},
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
        + sum(store_paths["gf_matmul_batched"].values())
        + sum(server_paths["gf_matmul_batched"].values())
        + sum(cluster_paths["gf_matmul_batched"].values())
        + sum(maint_paths["gf_matmul_batched"].values())
        + sum(tier_paths["gf_matmul_batched"].values())
        + sum(quorum_paths["gf_matmul_batched"].values())
        + sum(mesh_launches("gf_matmul_batched").values()),
        "launches_by_path": {
            "service_encode": svc["encode_launches"],
            "service_rebuild": svc["rebuild_launches"],
            "remote_rebuild": reads["rebuild_batched_launches"],
            **store_paths["gf_matmul_batched"],
            **server_paths["gf_matmul_batched"],
            **cluster_paths["gf_matmul_batched"],
            **maint_paths["gf_matmul_batched"],
            **tier_paths["gf_matmul_batched"],
            **quorum_paths["gf_matmul_batched"],
            **mesh_launches("gf_matmul_batched")},
        "max_abs_err": batched_err, "ms": batched["ms"],
        "back_to_back_ms": batched["back_to_back_ms"],
        "plain_ms": batched["plain_ms"], "bound_ms": batched["bound_ms"],
        "bound_by": batched["bound_by"], "alu_ms": batched["alu_ms"],
        "scrub_shape": {k: scrub_kernel[k] for k in (
            "entries", "bytes_per_shard", "ms", "back_to_back_ms",
            "plain_ms", "bound_ms", "bound_by", "alu_ms")},
        "library_ms": None},
        mesh_kernel("gf_xor", "seaweedfs_tpu_torch/ops/csrc/gf_xor.cu",
                    "seaweedfs_tpu/ops/rs_jax.py:70", mesh_launches("gf_xor"),
                    mesh_err["gf_xor"], mesh_times["gf_xor"],
                    decode_plan={f: mesh_times["gf_xor_decode"][f] for f in (
                        "shape", "ms", "back_to_back_ms", "plain_ms",
                        "bound_ms", "bound_by")}),
        mesh_kernel("gf_bitplane_mma",
                    "seaweedfs_tpu_torch/ops/csrc/gf_bitplane.cu",
                    "seaweedfs_tpu/ops/rs_jax.py:81, "
                    "seaweedfs_tpu/parallel/mesh.py:156",
                    mesh_launches("gf_bitplane_mma"),
                    mesh_err["gf_bitplane_mma"],
                    mesh_times["gf_bitplane_mma"],
                    # no PyTorch call computes the GF(2^8) product: the
                    # yardstick is torch._int_mm of its bit-plane product
                    # alone (int32 sums, no unpack, no pack)
                    library_ms=mesh_times["int_mm"]["ms"],
                    library_call="torch._int_mm, the (32, 80) x (80, 16 Mi)"
                    " int8 bit-plane product alone",
                    mesh_rebuild_plans={
                        k: {f: mesh_times[k][f] for f in (
                            "shape", "ms", "back_to_back_ms", "plain_ms",
                            "bound_ms", "bound_by")}
                        for k in ("gf_bitplane_mma_decode",
                                  "gf_bitplane_mma_partial")})]})
    emit({"phase": "done", "wall_s": time.perf_counter() - start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
