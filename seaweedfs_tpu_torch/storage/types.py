"""Scalar storage types and on-disk constants — the port's copy of
seaweedfs_tpu/storage/types.py.

Byte-compatible with SeaweedFS (all integers big-endian):
  * needle id: uint64 (weed/storage/types/needle_id_type.go)
  * offset: 4 bytes storing actual_offset/8 -> 32GB max volume
    (weed/storage/types/offset_4bytes.go).  The reference's 5-byte variant
    (`set_offset_size(5)`, 8TB volumes) is not ported yet.
  * size: int32 with tombstone -1 (weed/storage/types/needle_types.go)
  * .idx / .ecx entry: 8 + 4 + 4 = 16 bytes
"""

from __future__ import annotations

import struct

NEEDLE_ID_SIZE = 8
OFFSET_SIZE = 4
SIZE_SIZE = 4
COOKIE_SIZE = 4
TIMESTAMP_SIZE = 8
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16
NEEDLE_PADDING_SIZE = 8
NEEDLE_CHECKSUM_SIZE = 4
TOMBSTONE_FILE_SIZE = -1

_U64 = struct.Struct(">Q")
_U32 = struct.Struct(">I")
_ENTRY = struct.Struct(">QIi")


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def offset_to_bytes(actual_offset: int) -> bytes:
    """Store the actual byte offset / 8 in 4 big-endian bytes."""
    if actual_offset % NEEDLE_PADDING_SIZE:
        raise ValueError(f"offset {actual_offset} not 8-byte aligned")
    return _U32.pack(actual_offset // NEEDLE_PADDING_SIZE)


def bytes_to_offset(b: bytes) -> int:
    """Return the *actual* byte offset (stored value * 8)."""
    return _U32.unpack(b[:4])[0] * NEEDLE_PADDING_SIZE


def size_to_bytes(size: int) -> bytes:
    return _U32.pack(size & 0xFFFFFFFF)


def bytes_to_size(b: bytes) -> int:
    v = _U32.unpack(b[:4])[0]
    return v - (1 << 32) if v & 0x80000000 else v


def needle_id_to_bytes(nid: int) -> bytes:
    return _U64.pack(nid)


def bytes_to_needle_id(b: bytes) -> int:
    return _U64.unpack(b[:8])[0]


def pack_index_entry(key: int, actual_offset: int, size: int) -> bytes:
    return (needle_id_to_bytes(key) + offset_to_bytes(actual_offset)
            + size_to_bytes(size))


def unpack_index_entry(b: bytes) -> tuple[int, int, int]:
    """-> (needle_id, actual_offset, size)"""
    key, stored, size = _ENTRY.unpack_from(b)
    return key, stored * NEEDLE_PADDING_SIZE, size
