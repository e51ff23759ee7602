"""Needle records: the append-only blob format inside `.dat` volume files —
the port's copy of seaweedfs_tpu/storage/needle.py.

Byte-compatible with the reference (weed/storage/needle/needle_read_write.go):

  header (16B): cookie(4) id(8) size(4), all big-endian
  v2/v3 body (present when size > 0):
      data_size(4) data flags(1)
      [name_size(1) name]    if FLAG_HAS_NAME
      [mime_size(1) mime]    if FLAG_HAS_MIME
      [last_modified(5)]     if FLAG_HAS_LAST_MODIFIED  (low 5 bytes of be64)
      [ttl(2)]               if FLAG_HAS_TTL
      [pairs_size(2) pairs]  if FLAG_HAS_PAIRS
  tail: checksum(4, masked crc32c of data) + [append_at_ns(8) in v3]
        + padding to the next 8-byte boundary (padding length is 1..8: a
        record whose tail lands exactly on a boundary still gets 8 bytes).

Deviation (documented): the reference fills padding with stale bytes from a
reused scratch buffer (needle_read_write.go:49,116-120); we write zeros.
Record lengths and all parsed fields are identical, and the reader accepts
either.  The CRC32-C is the port's native one (ops/crc32c.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..ops import crc32c
from . import types as t
from .super_block import VERSION1, VERSION2, VERSION3
from .ttl import TTL

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES = 5
TTL_BYTES = 2


class CorruptNeedleError(ValueError):
    """CRC mismatch parsing a needle: the bytes on disk are rotten.

    A ValueError subclass so every existing `except ValueError` parse
    guard keeps working, while the read path and the scrubber can tell
    silent corruption apart from a garbled/short read and route it into
    quarantine + repair instead of a dead-end 500."""


def padding_length(needle_size: int, version: int) -> int:
    """1..8 bytes; the reference adds a full 8 when already aligned."""
    if version == VERSION3:
        used = t.NEEDLE_HEADER_SIZE + needle_size + t.NEEDLE_CHECKSUM_SIZE + t.TIMESTAMP_SIZE
    else:
        used = t.NEEDLE_HEADER_SIZE + needle_size + t.NEEDLE_CHECKSUM_SIZE
    return t.NEEDLE_PADDING_SIZE - (used % t.NEEDLE_PADDING_SIZE)


def body_length(needle_size: int, version: int) -> int:
    pad = padding_length(needle_size, version)
    if version == VERSION3:
        return needle_size + t.NEEDLE_CHECKSUM_SIZE + t.TIMESTAMP_SIZE + pad
    return needle_size + t.NEEDLE_CHECKSUM_SIZE + pad


def actual_size(needle_size: int, version: int) -> int:
    return t.NEEDLE_HEADER_SIZE + body_length(needle_size, version)


@dataclass
class Needle:
    cookie: int = 0
    id: int = 0
    size: int = 0  # the stored Size field (body payload length)
    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    last_modified: int = 0
    ttl: TTL | None = None
    pairs: bytes = b""
    checksum: int = 0  # unmasked crc32c of data
    append_at_ns: int = 0

    # -- flag helpers -----------------------------------------------------

    def has(self, flag: int) -> bool:
        return bool(self.flags & flag)

    def set(self, flag: int) -> None:
        self.flags |= flag

    @property
    def is_chunk_manifest(self) -> bool:
        return self.has(FLAG_IS_CHUNK_MANIFEST)

    # -- serialization ----------------------------------------------------

    def _computed_size(self) -> int:
        if not self.data:
            return 0
        size = 4 + len(self.data) + 1
        if self.has(FLAG_HAS_NAME):
            size += 1 + min(len(self.name), 255)
        if self.has(FLAG_HAS_MIME):
            size += 1 + len(self.mime)
        if self.has(FLAG_HAS_LAST_MODIFIED):
            size += LAST_MODIFIED_BYTES
        if self.has(FLAG_HAS_TTL):
            size += TTL_BYTES
        if self.has(FLAG_HAS_PAIRS):
            size += 2 + len(self.pairs)
        return size

    def to_bytes(self, version: int = VERSION3) -> bytes:
        """Serialize; also updates self.size/self.checksum."""
        self.checksum = crc32c.checksum(self.data)
        if version == VERSION1:
            self.size = len(self.data)
            out = bytearray()
            out += struct.pack(">I", self.cookie)
            out += t.needle_id_to_bytes(self.id)
            out += t.size_to_bytes(self.size)
            out += self.data
            out += struct.pack(">I", crc32c.mask(self.checksum))
            out += b"\0" * padding_length(self.size, version)
            return bytes(out)
        if version not in (VERSION2, VERSION3):
            raise ValueError(f"unsupported needle version {version}")

        self.size = self._computed_size()
        out = bytearray()
        out += struct.pack(">I", self.cookie)
        out += t.needle_id_to_bytes(self.id)
        out += t.size_to_bytes(self.size)
        if self.data:
            out += struct.pack(">I", len(self.data))
            out += self.data
            out += bytes([self.flags])
            if self.has(FLAG_HAS_NAME):
                name = self.name[:255]
                out += bytes([len(name)])
                out += name
            if self.has(FLAG_HAS_MIME):
                out += bytes([len(self.mime)])
                out += self.mime
            if self.has(FLAG_HAS_LAST_MODIFIED):
                out += struct.pack(">Q", self.last_modified)[8 - LAST_MODIFIED_BYTES :]
            if self.has(FLAG_HAS_TTL):
                out += (self.ttl or TTL()).to_bytes()
            if self.has(FLAG_HAS_PAIRS):
                out += struct.pack(">H", len(self.pairs))
                out += self.pairs
        out += struct.pack(">I", crc32c.mask(self.checksum))
        if version == VERSION3:
            out += struct.pack(">Q", self.append_at_ns)
        out += b"\0" * padding_length(self.size, version)
        return bytes(out)

    # -- parsing ----------------------------------------------------------

    @classmethod
    def parse_header(cls, b: bytes) -> "Needle":
        n = cls()
        n.cookie = struct.unpack(">I", b[0:4])[0]
        n.id = t.bytes_to_needle_id(b[4:12])
        n.size = t.bytes_to_size(b[12:16])
        return n

    def parse_body_v2(self, b: bytes) -> None:
        """Parse the size-long body region (v2/v3 field layout)."""
        idx, end = 0, len(b)
        if idx < end:
            data_size = struct.unpack(">I", b[idx : idx + 4])[0]
            idx += 4
            if idx + data_size > end:
                raise ValueError("needle data out of range")
            self.data = b[idx : idx + data_size]
            idx += data_size
            self.flags = b[idx]
            idx += 1
        if idx < end and self.has(FLAG_HAS_NAME):
            ln = b[idx]
            idx += 1
            self.name = b[idx : idx + ln]
            idx += ln
        if idx < end and self.has(FLAG_HAS_MIME):
            ln = b[idx]
            idx += 1
            self.mime = b[idx : idx + ln]
            idx += ln
        if idx < end and self.has(FLAG_HAS_LAST_MODIFIED):
            self.last_modified = int.from_bytes(b[idx : idx + LAST_MODIFIED_BYTES], "big")
            idx += LAST_MODIFIED_BYTES
        if idx < end and self.has(FLAG_HAS_TTL):
            self.ttl = TTL.from_bytes(b[idx : idx + TTL_BYTES])
            idx += TTL_BYTES
        if idx < end and self.has(FLAG_HAS_PAIRS):
            ln = struct.unpack(">H", b[idx : idx + 2])[0]
            idx += 2
            self.pairs = b[idx : idx + ln]
            idx += ln

    @classmethod
    def from_bytes(cls, blob: bytes, version: int = VERSION3, verify: bool = True) -> "Needle":
        """Parse a full record (header + body) as laid out on disk."""
        n = cls.parse_header(blob)
        size = n.size
        if size < 0:
            raise ValueError("cannot parse tombstoned record")
        if version == VERSION1:
            n.data = blob[t.NEEDLE_HEADER_SIZE : t.NEEDLE_HEADER_SIZE + size]
        else:
            n.parse_body_v2(blob[t.NEEDLE_HEADER_SIZE : t.NEEDLE_HEADER_SIZE + size])
        if size > 0:
            stored = struct.unpack(
                ">I",
                blob[t.NEEDLE_HEADER_SIZE + size : t.NEEDLE_HEADER_SIZE + size + 4],
            )[0]
            n.checksum = crc32c.checksum(n.data)
            if verify and stored != crc32c.mask(n.checksum):
                raise CorruptNeedleError("CRC error: data on disk corrupted")
        if version == VERSION3:
            ts_off = t.NEEDLE_HEADER_SIZE + size + t.NEEDLE_CHECKSUM_SIZE
            n.append_at_ns = struct.unpack(">Q", blob[ts_off : ts_off + 8])[0]
        return n

    def disk_size(self, version: int = VERSION3) -> int:
        return actual_size(self.size, version)
