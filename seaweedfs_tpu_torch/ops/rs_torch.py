"""Reed-Solomon codec on a torch device — the port of ops/rs_jax.py's
ReedSolomonTPU.

The GF(2^8) matrix apply is one of three hand-written CUDA kernels for
tensors on the card, or its plain PyTorch version for tensors on the CPU,
chosen by `impl` as rs_jax.py::_impl_fn (:111) chooses among its programs:
``bitslice`` (rs_cuda.gf_apply, the bit-sliced network built per matrix:
the port of the Pallas kernel and the default), ``xor`` (rs_xor.gf_apply_xor,
the doubling chain's XOR network: the port of make_apply_xor) and
``bitplane`` (rs_bitplane.gf_apply_bitplane, bit-planes through an int8
matrix product: the port of make_apply_mxu).
The numpy-level API (encode / reconstruct / reconstruct_data / verify over
lists of equal-length uint8 arrays) matches the reference codecs, and
`encode_device` / `apply_rows_device` take tensors already on the device,
for the streaming file pipeline.  Inside an active trace, `parity_of` and
the reconstructs record the spans ``ec.device_put``, ``ec.device_compute``
and ``ec.device_get`` as rs_jax.py:192-233 does, so a slow degraded read is
attributable to the upload, the kernel or the readback.
"""

from __future__ import annotations

import numpy as np
import torch

from ..telemetry import trace
from . import gf256
from .rs_bitplane import gf_apply_bitplane
from .rs_cuda import coefficients, gf_apply
from .rs_xor import gf_apply_xor

# impl -> the name of its GF apply in this module, (R, S) matrix x (S, B)
# tensor -> (R, B) tensor, looked up at each call
IMPLS = {"bitslice": "gf_apply", "xor": "gf_apply_xor",
         "bitplane": "gf_apply_bitplane"}
# impl -> the suffix of its codec's name (ops/codec.py): cuda, cuda_xor, ...
_IMPL_SUFFIX = {"bitslice": "", "xor": "_xor", "bitplane": "_bitplane"}


def matrix_from_numpy(matrix: np.ndarray) -> np.ndarray:
    """A GF matrix from the JAX package (rs_matrix, decode_plan_for, as
    numpy) in this port's coefficient form: a read-only C-contiguous uint8
    (R, S) array, validated for the kernel's limits."""
    m = coefficients(matrix).copy()
    m.setflags(write=False)
    return m


def resolve_device(device) -> torch.device:
    """The torch device a codec runs on; raises when CUDA is asked for and
    this process has no usable card — there is no silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; ask for device='cpu' explicitly to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def apply_matrix(matrix: np.ndarray, data: torch.Tensor,
                 impl: str = "bitslice") -> torch.Tensor:
    """GF matmul: (R, S) matrix x (S, B) tensor -> (R, B), on `impl`."""
    return globals()[_impl_name(impl)](matrix, data)


def _impl_name(impl: str) -> str:
    name = IMPLS.get(impl)
    if name is None:
        raise ValueError(f"unknown codec impl {impl!r}; known: "
                         f"{', '.join(IMPLS)}")
    return name


class ReedSolomonTorch:
    """RS(data, parity) codec running the GF matmul on `device` through
    the kernel `impl` names (IMPLS)."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 4,
                 device="cuda", impl: str = "bitslice"):
        _impl_name(impl)  # an unknown impl raises here
        self.device = resolve_device(device)
        self.gf_impl = impl
        # the label of its spans: the codec's name
        self.impl = ("cuda" if self.device.type == "cuda"
                     else "torch_cpu") + _IMPL_SUFFIX[impl]
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.matrix = gf256.rs_matrix(data_shards, self.total_shards)
        self.parity_matrix = gf256.rs_parity_matrix(data_shards, parity_shards)

    # -- device-resident ----------------------------------------------------

    def encode_device(self, data: torch.Tensor) -> torch.Tensor:
        """(data_shards, B) uint8 on the device -> (parity_shards, B)."""
        return apply_matrix(self.parity_matrix, data, self.gf_impl)

    def apply_rows_device(self, rows: np.ndarray,
                          inputs: torch.Tensor) -> torch.Tensor:
        """Arbitrary GF matrix application (decode plans, rebuild)."""
        return apply_matrix(rows, inputs, self.gf_impl)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        with trace.child_span("ec.device_put", impl=self.impl,
                              bytes=int(arr.nbytes)):
            return torch.from_numpy(arr).to(self.device)

    def _run(self, rows: np.ndarray, inputs: torch.Tensor) -> np.ndarray:
        """rows x inputs on the device, back as numpy, each hop spanned; the
        compute span waits for the card so the kernel's time lands in it."""
        with trace.child_span("ec.device_compute", impl=self.impl):
            out = self.apply_rows_device(rows, inputs)
            if out.device.type == "cuda":
                torch.cuda.current_stream(out.device).synchronize()
        with trace.child_span("ec.device_get", impl=self.impl):
            return out.cpu().numpy()

    def apply_rows(self, rows: np.ndarray, inputs) -> list[np.ndarray]:
        """rows (R, S) x S numpy input rows -> R numpy rows, on the device
        (the same shapes as rs_cpu's)."""
        return list(self._run(rows, self._to_device(np.stack(inputs))))

    def parity_of(self, data: np.ndarray) -> np.ndarray:
        """(data_shards, B) numpy -> (parity_shards, B) numpy."""
        if data.shape[0] != self.data_shards:
            raise ValueError(
                f"expected {self.data_shards} data rows, got {data.shape[0]}")
        return self._run(self.parity_matrix, self._to_device(data))

    # -- numpy convenience (same shapes as rs_cpu) --------------------------

    def encode(self, shards: list[np.ndarray]) -> None:
        parity = self.parity_of(np.stack(shards[: self.data_shards]))
        for i in range(self.parity_shards):
            shards[self.data_shards + i][:] = parity[i]

    def _reconstruct(self, shards, data_only: bool):
        if len(shards) != self.total_shards:
            raise ValueError(f"expected {self.total_shards} shard slots")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) == self.total_shards:
            return list(shards)
        if len(present) < self.data_shards:
            raise ValueError("too few shards to reconstruct")
        out = list(shards)
        missing_data = [i for i in range(self.data_shards) if shards[i] is None]
        if missing_data:
            inputs = self._to_device(
                np.stack([shards[i] for i in present[: self.data_shards]]))
            rows = gf256.decode_plan_for(
                self.matrix, self.data_shards, present, tuple(missing_data))
            rec = self._run(rows, inputs)
            for i, r in zip(missing_data, rec):
                out[i] = r
        if not data_only:
            missing_parity = [i for i in range(self.data_shards,
                                               self.total_shards)
                              if shards[i] is None]
            if missing_parity:
                data = self._to_device(np.stack(
                    [np.asarray(out[i]) for i in range(self.data_shards)]))
                rows = self.matrix[np.asarray(missing_parity)]
                par = self._run(rows, data)
                for i, p in zip(missing_parity, par):
                    out[i] = p
        return out

    def reconstruct(self, shards):
        return self._reconstruct(shards, data_only=False)

    def reconstruct_data(self, shards):
        return self._reconstruct(shards, data_only=True)

    def verify(self, shards: list[np.ndarray]) -> bool:
        parity = self.parity_of(np.stack(shards[: self.data_shards]))
        return all(np.array_equal(parity[i], shards[self.data_shards + i])
                   for i in range(self.parity_shards))
