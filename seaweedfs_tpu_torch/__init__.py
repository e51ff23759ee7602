"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu.

The JAX package `seaweedfs_tpu` stays the reference; this package imports
none of it and keeps its own copies of what it needs.  Its entry points run
on the card (device "cuda") unless the caller asks for the CPU.

Ported (erasure coding of a sealed volume, `ec.encode` + `ec.rebuild`, and
needle reads from the EC volume):
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
    with its ec.device_put / compute / get spans.
  * native/ — the port's copy of the C++ native library (CRC32-C, the
    GF(2^8) SIMD host codec), built with g++ at first use into _build/;
    ops/crc32c.py and ops/rs_cpu.py (the `cpu` codec) run on it.
  * ops/codec.py — get_codec("cuda" | "cpu" | "torch_cpu" | "auto"),
    effective_codec, available_codecs, InstrumentedCodec and
    DEVICE_CODEC_NAMES.
  * ops/device_probe.py — the killable round-trip probe with a deadline.
  * ops/codec_service.py — the batched, double-buffered codec service:
    device mode stacks concurrent jobs into one batched kernel launch;
    host mode runs the cpu codec.
  * stats/metrics.py — the registry and the families of the service, the
    codec, the rebuild, the EC read path and the executors.
  * telemetry/trace.py — spans and the ring the codec and read path use.
  * util/chunk_cache.py (IntervalCache), util/executors.py
    (MeteredThreadPoolExecutor).
  * storage/types.py, idx.py, needle_map.py, needle.py, super_block.py,
    ttl.py, replica_placement.py, vif.py — the on-disk formats.
  * storage/ec/encoder.py — write_ec_files / generate_ec_files and
    rebuild_ec_files from local and remote (`remote_fetch`) sources,
    through the codec service (the default on a card) or the direct
    pinned, stream-overlapped pipeline; write_sorted_file_from_idx.
  * storage/ec/locate.py, volume.py — EcVolume: needle reads with
    degraded reads decoded on the volume's codec, single-flight, the
    interval cache, .ecj deletes, remote fetches on a shared pool.

Checks: `JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py` holds
every module against the reference on the CPU (no card, nvcc or triton;
g++ for native/); `python3 chip_smoke.py` runs the whole path on a card,
and `python3 chip_smoke.py --only-ec-reads --volume-gib 0.5` the EC read
phase alone at a quick-check size.  storage/vif.py reads and writes the
.vif without generated protobuf code on purpose: a second
`volume_info.proto` in protobuf's default descriptor pool collides with
the reference's when the tests import both packages into one process.

Not ported yet: the partial-sum protocol (storage/ec/partial.py, and
EcVolume.partial_client); decoder.py; scrub.py; parallel/ (multi-GPU);
the servers and the CLI; the cuda_xor / cuda_bitplane impls; spans and
stage metrics inside the encode pipeline; 5-byte offsets.
util/jaxenv.py works around a JAX-only hang and has no counterpart here.
"""
