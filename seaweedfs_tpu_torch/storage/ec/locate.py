"""Striped-layout interval math: map logical `.dat` ranges to shard ranges —
the port's copy of seaweedfs_tpu/storage/ec/locate.py.

The volume is striped row-major across the 10 data shards: rows of 1GB
blocks while they fit, then rows of 1MB blocks (so the tail only rounds up
to 10x1MB, not 10x1GB).  Reference: ec_locate.go:15-87 and the row scheme in
ec_encoder.go:194-231.
"""

from __future__ import annotations

from dataclasses import dataclass

from .constants import DATA_SHARDS


@dataclass(frozen=True)
class Interval:
    block_index: int
    inner_block_offset: int
    size: int
    is_large_block: bool
    large_block_rows_count: int

    def to_shard_id_and_offset(
        self, large_block_size: int, small_block_size: int
    ) -> tuple[int, int]:
        off = self.inner_block_offset
        row_index = self.block_index // DATA_SHARDS
        if self.is_large_block:
            off += row_index * large_block_size
        else:
            off += (
                self.large_block_rows_count * large_block_size
                + row_index * small_block_size
            )
        return self.block_index % DATA_SHARDS, off


def _locate_offset(
    large: int, small: int, dat_size: int, offset: int
) -> tuple[int, bool, int]:
    large_row_size = large * DATA_SHARDS
    n_large_rows = dat_size // large_row_size
    if offset < n_large_rows * large_row_size:
        return offset // large, True, offset % large
    offset -= n_large_rows * large_row_size
    return offset // small, False, offset % small


def locate_data(
    large: int, small: int, dat_size: int, offset: int, size: int
) -> list[Interval]:
    """Split a logical (offset, size) range into per-block intervals."""
    block_index, is_large, inner = _locate_offset(large, small, dat_size, offset)
    # +DataShards*small so shard size alone determines the large-row count
    n_large_rows = (dat_size + DATA_SHARDS * small) // (large * DATA_SHARDS)

    intervals: list[Interval] = []
    while size > 0:
        remaining = (large if is_large else small) - inner
        take = min(size, remaining)
        intervals.append(Interval(block_index, inner, take, is_large, n_large_rows))
        if take == size:
            return intervals
        size -= take
        block_index += 1
        if is_large and block_index == n_large_rows * DATA_SHARDS:
            is_large = False
            block_index = 0
        inner = 0
    return intervals


def shard_file_size(dat_size: int, large: int, small: int) -> int:
    """Size of each .ecNN file for a given .dat size (zero-padded tail)."""
    if dat_size <= 0:
        return 0
    large_rows = (dat_size - 1) // (large * DATA_SHARDS) if dat_size > large * DATA_SHARDS else 0
    rest = dat_size - large_rows * large * DATA_SHARDS
    small_rows = -(-rest // (small * DATA_SHARDS))  # ceil
    return large_rows * large + small_rows * small
