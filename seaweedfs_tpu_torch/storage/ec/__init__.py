from .constants import (  # noqa: F401
    DATA_SHARDS,
    LARGE_BLOCK_SIZE,
    PARITY_SHARDS,
    SMALL_BLOCK_SIZE,
    TOTAL_SHARDS,
    to_ext,
)
