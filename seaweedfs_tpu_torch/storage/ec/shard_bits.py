"""ShardBits: bitmask of which of the 14 shards a server holds — the port's
copy of seaweedfs_tpu/storage/ec/shard_bits.py.

Reference: ec_volume_info.go:65-117 (uint32 bitmask used in master
bookkeeping and balance planning).
"""

from __future__ import annotations


class ShardBits(int):
    def add(self, shard_id: int) -> "ShardBits":
        return ShardBits(self | (1 << shard_id))

    def remove(self, shard_id: int) -> "ShardBits":
        return ShardBits(self & ~(1 << shard_id))

    def has(self, shard_id: int) -> bool:
        return bool(self & (1 << shard_id))

    def shard_ids(self) -> list[int]:
        return [i for i in range(32) if self.has(i)]

    def count(self) -> int:
        return bin(self).count("1")

    def plus(self, other: "ShardBits | int") -> "ShardBits":
        return ShardBits(self | other)

    def minus(self, other: "ShardBits | int") -> "ShardBits":
        return ShardBits(self & ~other)
