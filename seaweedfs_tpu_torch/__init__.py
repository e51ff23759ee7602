"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu.

The JAX package `seaweedfs_tpu` stays the reference; this package imports
none of it and keeps its own copies of what it needs.  Its entry points run
on the card (device "cuda") unless the caller asks for the CPU.

Ported (erasure coding of a sealed volume, `ec.encode` + `ec.rebuild`):
  * ops/gf256.py — GF(2^8) tables, RS generator matrix, decode-plan LRU.
  * ops/csrc/gf_matmul.cu + ops/rs_cuda.py — the hand-written CUDA
    GF(2^8) matrix-apply kernel for sm_90a that replaces the Pallas kernel
    seaweedfs_tpu/ops/rs_pallas.py::_kernel_body, with its plain PyTorch
    version and a launch counter; ops/_build.py builds it with nvcc.
  * ops/rs_torch.py — ReedSolomonTorch, the port of rs_jax.ReedSolomonTPU.
  * ops/codec.py — get_codec("cuda") / get_codec("torch_cpu").
  * storage/types.py, idx.py, needle_map.py — the .idx -> .ecx path.
  * storage/ec/encoder.py — write_ec_files / generate_ec_files (pinned,
    stream-overlapped device pipeline), write_sorted_file_from_idx and
    rebuild_ec_files from local shards.

Not ported yet: the codec's `auto` choice, device probe and metrics/spans;
remote and partial-sum rebuild; degraded reads (storage/ec/volume.py);
partial.py, scrub.py and the codec service; parallel/ (multi-GPU); the
servers and the CLI; 5-byte offsets.  util/jaxenv.py works around a
JAX-only hang and has no counterpart here.
"""
