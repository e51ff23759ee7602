"""EC geometry constants (reference: ec_encoder.go:17-23)."""

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS
LARGE_BLOCK_SIZE = 1024 * 1024 * 1024  # 1GB rows first
SMALL_BLOCK_SIZE = 1024 * 1024  # then 1MB rows to cap tail padding


def to_ext(shard_id: int) -> str:
    return f".ec{shard_id:02d}"
