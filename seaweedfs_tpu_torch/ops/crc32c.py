"""CRC32-C (Castagnoli) with the reference's masked finalisation — the port's
copy of seaweedfs_tpu/ops/crc32c.py.

Needle checksums (weed/storage/needle/crc.go, klauspost/crc32) are stored
*masked*: ``Value() = rotr(crc, 15) + 0xa282ead8`` (crc.go:25), and the port
must write and check the identical 4 bytes.  `update` runs the native
library's hardware CRC32-C (native/); `reference_update`, a numpy
slicing-by-8 table version, is the plain version the tests hold it against
(far too slow to check real volumes).
"""

from __future__ import annotations

import functools

import numpy as np

from ..native import lib as _native

_CASTAGNOLI = 0x82F63B78  # reflected polynomial


def update(crc: int, data) -> int:
    """crc32c update (unmasked), as crc32.Update over the Castagnoli table."""
    return _native.crc32c_update(crc, data)


def checksum(data) -> int:
    """Unmasked crc32c of a buffer (NewCRC(b) in the reference)."""
    return update(0, data)


def mask(crc: int) -> int:
    """The stored on-disk value: rotr(crc, 15) + 0xa282ead8 (mod 2^32)."""
    rot = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
    return (rot + 0xA282EAD8) & 0xFFFFFFFF


def unmask(masked: int) -> int:
    """Inverse of mask(): the raw crc from the stored value."""
    rot = (masked - 0xA282EAD8) & 0xFFFFFFFF
    return ((rot << 15) | (rot >> 17)) & 0xFFFFFFFF


def value(data) -> int:
    """Masked checksum as written into needle records."""
    return mask(checksum(data))


@functools.cache
def _tables() -> np.ndarray:
    """Slicing-by-8 tables, shape (8, 256) uint32."""
    t = np.zeros((8, 256), dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CASTAGNOLI if crc & 1 else 0)
        t[0, i] = crc
    for k in range(1, 8):
        for i in range(256):
            t[k, i] = (int(t[k - 1, i]) >> 8) ^ int(t[0, int(t[k - 1, i]) & 0xFF])
    return t


def reference_update(crc: int, data) -> int:
    """The plain version of `update`: numpy slicing-by-8 tables."""
    t = _tables()
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    crc = crc ^ 0xFFFFFFFF
    n = len(buf) - (len(buf) % 8)
    i = 0
    t0, t1, t2, t3, t4, t5, t6, t7 = (t[k] for k in range(8))
    while i < n:
        b = buf[i: i + 8]
        low = crc ^ (int(b[0]) | int(b[1]) << 8 | int(b[2]) << 16
                     | int(b[3]) << 24)
        crc = (int(t7[low & 0xFF]) ^ int(t6[(low >> 8) & 0xFF])
               ^ int(t5[(low >> 16) & 0xFF]) ^ int(t4[(low >> 24) & 0xFF])
               ^ int(t3[int(b[4])]) ^ int(t2[int(b[5])])
               ^ int(t1[int(b[6])]) ^ int(t0[int(b[7])]))
        i += 8
    while i < len(buf):
        crc = (crc >> 8) ^ int(t0[(crc ^ int(buf[i])) & 0xFF])
        i += 1
    return (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
