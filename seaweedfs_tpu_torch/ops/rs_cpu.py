"""Host Reed-Solomon codec on the native SIMD library — the port's copy of
seaweedfs_tpu/ops/rs_cpu.py, registered as the ``cpu`` codec.

The API mirrors klauspost/reedsolomon's (the reference's
ec_encoder.go): ``encode`` fills parity from data, ``reconstruct`` fills
every missing shard (None entries), ``reconstruct_data`` only the missing
data shards, ``reconstruct_one`` one shard.  Shards are equal-length 1-D
uint8 numpy arrays.  Every GF product runs through `sw_gf_apply` of
native/seaweed_native.cc (GFNI + AVX-512, SSSE3 or scalar, whichever the
host has): per-needle degraded reads use this codec, where a launch on the
card would dominate the latency.
"""

from __future__ import annotations

import numpy as np

from ..native import lib as native
from . import gf256


class ReedSolomon:
    """RS(data, parity) systematic codec over GF(2^8), on the host."""

    def __init__(self, data_shards: int = 10, parity_shards: int = 4):
        if data_shards <= 0 or parity_shards < 0:
            raise ValueError("bad shard counts")
        if data_shards + parity_shards > 256:
            raise ValueError("too many shards for GF(2^8)")
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.matrix = gf256.rs_matrix(data_shards, self.total_shards)
        self.parity_matrix = np.ascontiguousarray(self.matrix[data_shards:])

    # -- core matmul ------------------------------------------------------

    @staticmethod
    def _apply(rows: np.ndarray, inputs) -> list[np.ndarray]:
        """outputs[i] = XOR_j rows[i, j] * inputs[j] on the native kernel."""
        if len(inputs) > 1 and any(len(x) != len(inputs[0])
                                   for x in inputs[1:]):
            raise ValueError("input shards must be the same length")
        return native.gf_apply_arrays(rows, list(inputs))

    # -- public API -------------------------------------------------------

    def apply_rows(self, rows: np.ndarray, inputs) -> list[np.ndarray]:
        """An arbitrary GF matrix over equal-length byte rows (decode
        plans, rebuild)."""
        return self._apply(rows, inputs)

    def parity_into(self, inputs, outs) -> None:
        """Parity from equal-length contiguous 1-D rows into preallocated
        outputs."""
        if len(inputs) != self.data_shards:
            raise ValueError(
                f"expected {self.data_shards} input rows, got {len(inputs)}")
        if len(outs) != self.parity_shards:
            raise ValueError(
                f"expected {self.parity_shards} output rows, got {len(outs)}")
        n = len(inputs[0])
        if any(len(o) != n for o in outs):
            raise ValueError("output rows must match input length")
        native.gf_apply_arrays(self.parity_matrix, list(inputs), out=list(outs))

    def parity_of(self, data: np.ndarray) -> np.ndarray:
        """(data_shards, B) -> (parity_shards, B)."""
        if data.shape[0] != self.data_shards:
            raise ValueError(
                f"expected {self.data_shards} data rows, got {data.shape[0]}")
        out = np.empty((self.parity_shards, data.shape[1]), np.uint8)
        native.gf_apply_arrays(self.parity_matrix, list(data), out=list(out))
        return out

    def encode(self, shards: list[np.ndarray]) -> None:
        """Fill shards[data:] (parity) in place from shards[:data]."""
        self._check(shards)
        parity = self._apply(self.parity_matrix, shards[: self.data_shards])
        for i, p in enumerate(parity):
            shards[self.data_shards + i][:] = p

    def verify(self, shards: list[np.ndarray]) -> bool:
        parity = self._apply(self.parity_matrix, shards[: self.data_shards])
        return all(np.array_equal(p, shards[self.data_shards + i])
                   for i, p in enumerate(parity))

    def reconstruct(self, shards):
        return self._reconstruct(shards, data_only=False)

    def reconstruct_data(self, shards):
        return self._reconstruct(shards, data_only=True)

    def reconstruct_one(self, shards, shard_id: int) -> np.ndarray:
        """Decode ONLY `shard_id` from >= data_shards present shards: the
        per-needle degraded read needs one interval, and decoding every
        lost row would multiply its GF work."""
        if shards[shard_id] is not None:
            return np.asarray(shards[shard_id], dtype=np.uint8)
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < self.data_shards:
            raise ValueError("too few shards to reconstruct")
        sub = [np.asarray(shards[i], dtype=np.uint8)
               for i in present[: self.data_shards]]
        row = gf256.decode_plan_for(
            self.matrix, self.data_shards, present, (shard_id,))
        return self._apply(row, sub)[0]

    def _reconstruct(self, shards, data_only: bool):
        if len(shards) != self.total_shards:
            raise ValueError(f"expected {self.total_shards} shard slots")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) == self.total_shards:
            return list(shards)
        if len(present) < self.data_shards:
            raise ValueError("too few shards to reconstruct")
        size = len(shards[present[0]])
        sub = [np.asarray(shards[i], dtype=np.uint8)
               for i in present[: self.data_shards]]
        out = list(shards)
        missing_data = [i for i in range(self.data_shards) if shards[i] is None]
        if missing_data:
            rows = gf256.decode_plan_for(
                self.matrix, self.data_shards, present, tuple(missing_data))
            for i, r in zip(missing_data, self._apply(rows, sub)):
                out[i] = r
        if not data_only:
            missing_parity = [i for i in range(self.data_shards,
                                               self.total_shards)
                              if shards[i] is None]
            if missing_parity:
                data = [np.asarray(out[i], dtype=np.uint8)
                        for i in range(self.data_shards)]
                rows = self.matrix[np.asarray(missing_parity)]
                for i, p in zip(missing_parity, self._apply(rows, data)):
                    out[i] = p
        for s in out:
            if s is not None and len(s) != size:
                raise ValueError("shard size mismatch")
        return out

    def _check(self, shards) -> None:
        if len(shards) != self.total_shards:
            raise ValueError(f"expected {self.total_shards} shards")
        size = len(shards[0])
        for s in shards:
            if len(s) != size:
                raise ValueError("shards must be equal length")
