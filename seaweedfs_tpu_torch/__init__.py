"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu.

The JAX package `seaweedfs_tpu` stays the reference; this package imports
none of it and keeps its own copies of what it needs.  Its entry points run
on the card (device "cuda") unless the caller asks for the CPU.

Ported (the volume store and the full EC lifecycle of a volume: needle
writes, `ec.encode`, reads from the EC volume, `ec.rebuild`, the scrub of
EC parity and `ec.decode`):
  * ops/gf256.py — GF(2^8) tables, RS generator matrix, decode-plan LRU.
  * ops/csrc/gf_bitslice.cu + ops/gf_network.py + ops/rs_cuda.py — the
    hand-written CUDA GF(2^8) matrix-apply kernel for sm_90a, a bit-sliced
    XOR network generated and compiled for each matrix at its first use,
    with a batch axis: `gf_apply` replaces the Pallas kernel
    seaweedfs_tpu/ops/rs_pallas.py::_kernel_body, `gf_apply_batched` /
    `gf_sweep` replace the sweep kernel of bench.py:104; each has its
    plain PyTorch version and a launch counter; ops/_build.py compiles the
    kernels with NVRTC and the host library ops/csrc/gf_launch.cu with
    nvcc, and caches both under _build/.
  * ops/rs_torch.py — ReedSolomonTorch, the port of rs_jax.ReedSolomonTPU,
    with its ec.device_put / compute / get spans and the reference's impl
    switch: bitslice (rs_cuda), xor and bitplane.
  * ops/csrc/gf_xor.cu + ops/rs_xor.py — the XOR network of the doubling
    chain (the port of rs_jax.make_apply_xor), coefficients as a kernel
    argument, one and batched entries.
  * ops/csrc/gf_bitplane.cu + ops/rs_bitplane.py — the bit-plane route as
    one kernel on the int8 tensor cores, gf_bitplane_mma (the port of
    rs_jax.make_apply_mxu and of parallel/mesh.py's _bit_unpack /
    _bit_pack around its psum).
  * parallel/ — Mesh and make_mesh over torch devices, batch_encode_sharded,
    batch_apply_sharded, distributed_reconstruct (packed partials XORed
    over dp), train_step; batch.py's batch_generate_ec_files and
    mesh_rebuild_ec_files; dryrun.py's dryrun_multidevice.
  * native/ — the port's copy of the C++ native library (CRC32-C, the
    GF(2^8) SIMD host codec), built with g++ at first use into _build/;
    ops/crc32c.py and ops/rs_cpu.py (the `cpu` codec) run on it.
  * ops/codec.py — get_codec("cuda" | "cuda_xor" | "cuda_bitplane" | "cpu"
    | "torch_cpu" | "auto"),
    effective_codec, available_codecs, InstrumentedCodec and
    DEVICE_CODEC_NAMES.
  * ops/device_probe.py — the killable round-trip probe with a deadline.
  * ops/codec_service.py — the batched, double-buffered codec service:
    device mode stacks concurrent jobs into one batched kernel launch on a
    1x1 mesh, or dispatches each batch per entry of a larger mesh; host
    mode runs the cpu codec.
  * stats/metrics.py — the registry and the families of the service, the
    codec, the rebuild, the EC read path and the executors.
  * telemetry/trace.py — spans and the ring the codec and read path use.
  * util/chunk_cache.py (IntervalCache), util/executors.py
    (MeteredThreadPoolExecutor).
  * storage/types.py, idx.py, needle_map.py, needle.py, super_block.py,
    ttl.py, replica_placement.py, vif.py — the on-disk formats, with
    4-byte or (`types.set_offset_size(5)`, process-wide) 5-byte offsets.
  * storage/ec/encoder.py — write_ec_files / generate_ec_files and
    rebuild_ec_files from local and remote (`remote_fetch`) sources,
    through the codec service (the default on a card) or the direct
    pinned, stream-overlapped pipeline, or on the host codec's zero-copy
    mmap route; write_sorted_file_from_idx.
  * storage/ec/locate.py, volume.py — EcVolume: needle reads with
    degraded reads decoded on the volume's codec, single-flight, the
    interval cache, .ecj deletes, remote fetches on a shared pool.
  * storage/store.py — Store: disk locations, the volume lifecycle, needle
    writes/reads/deletes with the hot-needle cache, compaction, disk
    health, and generate/rebuild/mount/unmount/delete of EC shards and
    ec_shards_to_volume, on the `cuda` codec by default (no switch to the
    host); disk_location.py, volume.py (write path, index, torn-tail
    repair, tier_to_remote / tier_to_local), backend.py (DiskFile,
    RemoteBackendFile, the backend registry), backend_s3.py (the S3
    remote tier, signed by s3api/auth.py), disk_health.py, group_commit.py,
    vacuum.py, disk_needle_map.py, and idx.py's IndexWriter.
  * storage/ec/decoder.py, shard_bits.py — `ec.decode` back to a volume.
  * storage/scrub.py — the Scrubber: token bucket, quarantine, volume and
    EC scans with cursors, confirms, index repair (tools/offline.py's
    fix_index); EC parity verified on the store's codec (a batched launch
    per interval through the service on a card).
  * util/glog.py, util/faultpoint.py, util/chunk_cache.py (NeedleCache).
  * pb/ — master.proto, volume_server.proto and volume_info.proto messages
    in a private DescriptorPool (pb.POOL), the reference's package names
    and wire bytes; pb/rpc.py — the master and volume-server services,
    generic handlers (UNIMPLEMENTED for missing methods), serve, stubs
    over the port's own channel cache.  util/failsafe.py (retries,
    deadlines, breakers), telemetry/middleware.py (record_op),
    storage/file_id.py, topology/placement.py (EC source locality, order,
    rack groups), wdclient/location_cache.py.
  * storage/ec/partial.py — partial-sum repair: serve_partial (partials on
    the host codec), PartialRepairClient, MassPartialSession,
    BatchedPartialClient; EcVolume's partial degraded read and
    rebuild_ec_files(partial=...); the store's heartbeat
    (collect_heartbeat, drain_deltas) and partial_client_factory; the
    scrubber's shared background budget.
  * volume/server.py, volume/grpc_handlers.py — the volume server's gRPC
    side on the `cuda` codec by default: the EC, admin, copy, tail,
    vacuum, scrub, tier-move and status rpcs and the master heartbeat;
    volume/http_handlers.py, volume/tcp_handlers.py over util/httpd.py —
    its HTTP and TCP planes.
  * master/ — the master: assign and growth, lookups, location pub/sub,
    the liveness sweep, vacuum, the maintenance loop, the scrub-finding
    repair pass, admin tokens and the HTTP API (server.py,
    grpc_handlers.py, sequence.py); the raft quorum (raft.py: volume ids
    and the maintenance journal through the log, fencing and warm-up on
    a change of leader), the flight recorder (flight.py) and the
    federated /cluster/metrics, /cluster/traces, /cluster/hot and
    /cluster/status (observability.py);
    topology/ (topology.py, volume_layout.py, placement.py); operation/
    (assign, upload, delete).
  * maintenance/ — the master's maintenance plane: the lifecycle
    controller (policies, a crash-safe job journal, seal and ec_encode on
    the volume servers' codec, vacuum, rebalance, ttl_expire) and
    dead-node mass repair (batched rebuilds on the survivors), both built
    by every master; the tier stage after a `keep_source` encode.
  * telemetry/ — spans, middleware and hot keys; the metrics federation
    and trace stitching (federation.py, stitch.py), the SLO engine
    (slo.py, /cluster/alerts) and the canary prober (canary.py, whose
    ec_degraded probe decodes on a `cuda` volume server's card).
  * shell/ — the admin shell: CommandEnv, the maintenance script, the
    ec.* and volume.* commands, cluster.status, cluster.alerts,
    cluster.hot and cluster.debug; util/config.py (the TOML tier),
    util/grace.py (profiling hooks).
  * cli.py, __main__.py — `python -m seaweedfs_tpu_torch master | volume |
    server | shell | version`; `-ec.codec` defaults to `cuda`.

Checks: `JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py` holds
every module against the reference on the CPU (no card, nvcc or triton;
g++ for native/); `python3 chip_smoke.py` runs the whole path on a card,
and `python3 chip_smoke.py --only-ec-reads --volume-gib 0.5` the EC read
phase alone at a quick-check size (`--only-store --store-volume-gib 0.5`
the store's lifecycle, `--only-volume-server --store-volume-gib 0.5` the
volume server's, `--only-cluster --cluster-volume-gib 0.5` a master and
three volume processes driven by the shell, `--only-maintenance
--maintenance-volume-gib 0.25` a master encoding and repairing four
volume processes on its own, `--only-quorum --quorum-volume-gib 0.25`
three masters in a raft quorum that fails over mid-encode, with the
canary, the SLO engine and the flight recorder).  Every protobuf message of the port lives in pb.POOL,
never in protobuf's default pool, where the reference registers the same
file names: a process importing both packages would fail.

Not ported yet: the geo registry (the master's `peer_clusters`,
/cluster/geo); the shell's fs.*, filer.ring and cluster.geo commands; gRPC
TLS; the filer, the gateways (s3api/ holds only SigV4 signing, which the
S3 remote tier uses) and the CLI's other subcommands; spans and stage
metrics inside the encode pipeline.
util/jaxenv.py works around a JAX-only hang and has no counterpart here.
"""
