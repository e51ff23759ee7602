"""Codec registry — the port's counterpart of ops/codec.py::get_codec.

Names: ``cuda`` is the RS codec on the card, through the hand-written
kernel; ``torch_cpu`` is the same codec on the host, through the kernel's
plain PyTorch version, for tests and hosts without a card.  ``cuda`` raises
when no card is usable: nothing falls back silently.
"""

from __future__ import annotations

from .rs_torch import ReedSolomonTorch

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS

_DEVICES = {"cuda": "cuda", "torch_cpu": "cpu"}
# every name get_codec resolves to a codec on the card — the single source
# of truth shared with ops.codec_service's mode and routing logic
DEVICE_CODEC_NAMES = frozenset({"cuda"})


def get_codec(name: str = "cuda", data_shards: int = DATA_SHARDS,
              parity_shards: int = PARITY_SHARDS) -> ReedSolomonTorch:
    """Return a codec with encode/reconstruct/reconstruct_data/verify."""
    if name not in _DEVICES:
        raise ValueError(
            f"unknown ec codec {name!r}; known: {', '.join(_DEVICES)}")
    return ReedSolomonTorch(data_shards, parity_shards, device=_DEVICES[name])
