"""Volume superblock: the 8-byte `.dat` header — the port's copy of
seaweedfs_tpu/storage/super_block.py.

Layout (reference: weed/storage/super_block/super_block.go:16-23):
  byte 0   version (1..3)
  byte 1   replica placement byte
  byte 2-3 TTL
  byte 4-5 compaction revision (big-endian)
  byte 6-7 extra size (protobuf blob follows when nonzero)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .replica_placement import ReplicaPlacement
from .ttl import TTL

SUPER_BLOCK_SIZE = 8

VERSION1 = 1
VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3


@dataclass
class SuperBlock:
    version: int = CURRENT_VERSION
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: TTL = field(default_factory=TTL)
    compaction_revision: int = 0
    extra: bytes = b""

    def block_size(self) -> int:
        if self.version in (VERSION2, VERSION3):
            return SUPER_BLOCK_SIZE + len(self.extra)
        return SUPER_BLOCK_SIZE

    def to_bytes(self) -> bytes:
        hdr = bytearray(SUPER_BLOCK_SIZE)
        hdr[0] = self.version
        hdr[1] = self.replica_placement.to_byte()
        hdr[2:4] = self.ttl.to_bytes()
        struct.pack_into(">H", hdr, 4, self.compaction_revision)
        if self.extra:
            if len(self.extra) > 256 * 256 - 2:
                raise ValueError("super block extra too large")
            struct.pack_into(">H", hdr, 6, len(self.extra))
            return bytes(hdr) + self.extra
        return bytes(hdr)

    @classmethod
    def from_bytes(cls, b: bytes) -> "SuperBlock":
        if len(b) < SUPER_BLOCK_SIZE:
            raise ValueError("super block truncated")
        version = b[0]
        rp = ReplicaPlacement.from_byte(b[1])
        ttl = TTL.from_bytes(b[2:4])
        rev = struct.unpack_from(">H", b, 4)[0]
        extra_size = struct.unpack_from(">H", b, 6)[0]
        extra = bytes(b[SUPER_BLOCK_SIZE : SUPER_BLOCK_SIZE + extra_size]) if extra_size else b""
        return cls(version, rp, ttl, rev, extra)
