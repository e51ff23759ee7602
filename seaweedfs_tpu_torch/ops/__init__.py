"""The EC codecs and their kernels.

`get_codec` and the shard counts come from ops/codec.py, which imports
torch; they load at their first use, so a process that only needs the
host-side helpers here (crc32c for a needle, gf256's tables) — the CLI's
offline and client tools — starts without importing torch.
"""

from . import gf256  # noqa: F401

_FROM_CODEC = ("DATA_SHARDS", "PARITY_SHARDS", "TOTAL_SHARDS", "get_codec")


def __getattr__(name: str):
    if name in _FROM_CODEC:
        from . import codec

        return getattr(codec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
