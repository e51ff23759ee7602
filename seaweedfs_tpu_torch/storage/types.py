"""Scalar storage types and on-disk constants — the port's copy of the part
of seaweedfs_tpu/storage/types.py that the `.idx` -> `.ecx` path reads.

Byte-compatible with SeaweedFS (all integers big-endian):
  * needle id: uint64 (weed/storage/types/needle_id_type.go)
  * offset: 4 bytes storing actual_offset/8 -> 32GB max volume
    (weed/storage/types/offset_4bytes.go).  The 5-byte variant of the
    reference is not ported yet.
  * size: int32 with tombstone -1 (weed/storage/types/needle_types.go)
  * .idx / .ecx entry: 8 + 4 + 4 = 16 bytes
"""

from __future__ import annotations

NEEDLE_ID_SIZE = 8
OFFSET_SIZE = 4
SIZE_SIZE = 4
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16
NEEDLE_PADDING_SIZE = 8
TOMBSTONE_FILE_SIZE = -1


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE
