"""Scalar storage types and on-disk constants — the port's copy of
seaweedfs_tpu/storage/types.py.

Byte-compatible with SeaweedFS (all integers big-endian):
  * needle id: uint64 (weed/storage/types/needle_id_type.go)
  * offset: 4 bytes storing actual_offset/8 -> 32GB max volume
    (weed/storage/types/offset_4bytes.go); `set_offset_size(5)` switches
    the process to the 5-byte variant (offset_5bytes.go: 4 big-endian
    lower bytes + 1 high byte appended, 17-byte index entries, 8TB
    volumes) — the runtime analogue of SeaweedFS's `5BytesOffset` build
    tag, so consumers must read these constants via module attribute
    access (`t.OFFSET_SIZE`), never `from ... import`.
  * size: int32 with tombstone -1 (weed/storage/types/needle_types.go)
  * .idx / .ecx entry: 8 + OFFSET_SIZE + 4 bytes (NeedleMapEntrySize)
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
MAX_POSSIBLE_VOLUME_SIZE = 4 * 1024 * 1024 * 1024 * 8  # 32GB

_U64 = struct.Struct(">Q")
_U32 = struct.Struct(">I")
_ENTRY = struct.Struct(">QIi")


def set_offset_size(n: int) -> None:
    """Switch the process between 4-byte (32GB volumes) and 5-byte (8TB
    volumes) offsets.  Must run before any volume/index is opened; the
    two widths are NOT file-compatible (same constraint as rebuilding
    SeaweedFS with the 5BytesOffset tag)."""
    global OFFSET_SIZE, NEEDLE_MAP_ENTRY_SIZE, MAX_POSSIBLE_VOLUME_SIZE
    if n not in (4, 5):
        raise ValueError("offset size must be 4 or 5")
    OFFSET_SIZE = n
    NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE
    MAX_POSSIBLE_VOLUME_SIZE = (4 << 30) * 8 * (256 if n == 5 else 1)


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def offset_to_bytes(actual_offset: int) -> bytes:
    """Store the actual byte offset / 8 in OFFSET_SIZE bytes (5-byte
    layout: 4 big-endian lower bytes then the high byte, as
    offset_5bytes.go's OffsetToBytes)."""
    if actual_offset % NEEDLE_PADDING_SIZE:
        raise ValueError(f"offset {actual_offset} not 8-byte aligned")
    stored = actual_offset // NEEDLE_PADDING_SIZE
    if OFFSET_SIZE == 4:
        return _U32.pack(stored)
    return _U32.pack(stored & 0xFFFFFFFF) + bytes([(stored >> 32) & 0xFF])


def bytes_to_offset(b: bytes) -> int:
    """Return the *actual* byte offset (stored value * 8)."""
    stored = _U32.unpack(b[:4])[0]
    if OFFSET_SIZE == 5:
        stored |= b[4] << 32
    return stored * NEEDLE_PADDING_SIZE


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
    if OFFSET_SIZE == 4:
        key, stored, size = _ENTRY.unpack_from(b)
        return key, stored * NEEDLE_PADDING_SIZE, size
    return (bytes_to_needle_id(b[0:8]), bytes_to_offset(b[8:8 + OFFSET_SIZE]),
            bytes_to_size(b[8 + OFFSET_SIZE:12 + OFFSET_SIZE]))
