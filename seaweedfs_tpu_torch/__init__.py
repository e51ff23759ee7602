"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu.

The JAX package `seaweedfs_tpu` stays the reference; this package imports
none of it and keeps its own copies of what it needs.  Its entry points run
on the card (device "cuda") unless the caller asks for the CPU.

Ported (erasure coding of a sealed volume, `ec.encode` + `ec.rebuild`):
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
  * ops/rs_torch.py — ReedSolomonTorch, the port of rs_jax.ReedSolomonTPU.
  * ops/codec.py — get_codec("cuda") / get_codec("torch_cpu") and
    DEVICE_CODEC_NAMES.
  * ops/device_probe.py — the killable round-trip probe with a deadline.
  * ops/codec_service.py — the batched, double-buffered codec service:
    device mode stacks concurrent jobs into one batched kernel launch;
    host mode runs the torch_cpu codec.  stats/metrics.py holds the
    registry and the service's metric families.
  * storage/types.py, idx.py, needle_map.py — the .idx -> .ecx path.
  * storage/ec/encoder.py — write_ec_files / generate_ec_files and
    rebuild_ec_files from local shards, through the codec service (the
    default on a card) or the direct pinned, stream-overlapped pipeline;
    write_sorted_file_from_idx.

Not ported yet: the codec's `auto` choice, effective_codec and
InstrumentedCodec; the C++ SIMD host codec (seaweedfs_tpu/native/); spans;
remote and partial-sum rebuild; degraded reads (storage/ec/volume.py);
partial.py and scrub.py; parallel/ (multi-GPU); the servers and the CLI;
5-byte offsets.  util/jaxenv.py works around a JAX-only hang and has no
counterpart here.
"""
