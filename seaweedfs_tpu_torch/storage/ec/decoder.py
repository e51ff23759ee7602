"""EC decode-to-volume: shards -> `.dat`, `.ecx`+`.ecj` -> `.idx` — the
port's copy of seaweedfs_tpu/storage/ec/decoder.py.

Reference: ec_decoder.go.  Used by the `ec.decode` admin flow
(VolumeEcShardsToVolume) to turn an EC volume back into a normal one.

Note: for `.dat` sizes that are an exact multiple of 10GB the reference's
WriteDatFile (ec_decoder.go:173, `>=` loop) disagrees with its own encoder
(ec_encoder.go:214, `>` loop) about the row layout; we invert the encoder
faithfully (strict `>`), so such volumes round-trip correctly here.
"""

from __future__ import annotations

import os

from .. import types as t
from ..needle import actual_size
from ..super_block import SuperBlock
from .constants import DATA_SHARDS, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, to_ext


def iterate_ecx_file(base_name: str):
    """Yield (key, actual_offset, size) entries from the sorted .ecx."""
    with open(base_name + ".ecx", "rb") as f:
        while True:
            buf = f.read(t.NEEDLE_MAP_ENTRY_SIZE)
            if len(buf) != t.NEEDLE_MAP_ENTRY_SIZE:
                return
            yield t.unpack_index_entry(buf)


def iterate_ecj_file(base_name: str):
    """Yield deleted needle ids from the .ecj journal (8-byte entries)."""
    path = base_name + ".ecj"
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        while True:
            buf = f.read(t.NEEDLE_ID_SIZE)
            if len(buf) != t.NEEDLE_ID_SIZE:
                return
            yield t.bytes_to_needle_id(buf)


def write_idx_file_from_ec_index(base_name: str) -> None:
    """.idx = copy of .ecx + a tombstone entry per .ecj key (ec_decoder.go:18-43)."""
    with open(base_name + ".idx", "wb") as idx_f:
        with open(base_name + ".ecx", "rb") as ecx_f:
            while True:
                chunk = ecx_f.read(1 << 20)
                if not chunk:
                    break
                idx_f.write(chunk)
        for key in iterate_ecj_file(base_name):
            idx_f.write(t.pack_index_entry(key, 0, t.TOMBSTONE_FILE_SIZE))


def read_ec_volume_version(base_name: str) -> int:
    """Volume version from the superblock at the start of .ec00."""
    with open(base_name + to_ext(0), "rb") as f:
        sb = SuperBlock.from_bytes(f.read(64))
    return sb.version


def find_dat_file_size(data_base_name: str, index_base_name: str) -> int:
    """Max (offset + record size) over live .ecx entries (ec_decoder.go:48-70)."""
    version = read_ec_volume_version(data_base_name)
    dat_size = 0
    for _key, offset, size in iterate_ecx_file(index_base_name):
        if t.size_is_deleted(size):
            continue
        stop = offset + actual_size(size, version)
        dat_size = max(dat_size, stop)
    return dat_size


# readinto block for the shard->dat stream: 8MB quarters the syscall
# count vs the old 1MB read()+write() pairs and the reused buffer drops
# the per-chunk bytes allocation entirely
_COPY_BLOCK = 8 << 20


def write_dat_file(base_name: str, dat_file_size: int) -> None:
    """Assemble .dat from .ec00–.ec09 by walking the stripe layout."""
    ins = [open(base_name + to_ext(i), "rb") for i in range(DATA_SHARDS)]
    buf = memoryview(bytearray(min(max(dat_file_size, 1), _COPY_BLOCK)))
    try:
        with open(base_name + ".dat", "wb") as out:
            remaining = dat_file_size
            # mirror the encoder's strict-greater large-row loop
            while remaining > DATA_SHARDS * LARGE_BLOCK_SIZE:
                for f in ins:
                    _copy(f, out, LARGE_BLOCK_SIZE, buf)
                remaining -= DATA_SHARDS * LARGE_BLOCK_SIZE
            while remaining > 0:
                for f in ins:
                    to_read = min(remaining, SMALL_BLOCK_SIZE)
                    if to_read <= 0:
                        break
                    _copy(f, out, to_read, buf)
                    remaining -= to_read
    finally:
        for f in ins:
            f.close()


def _copy(src, dst, n: int, buf: memoryview | None = None) -> None:
    """Stream n bytes src->dst through a reused buffer (readinto: no
    per-chunk bytes object, bigger blocks, fewer syscalls)."""
    if buf is None:
        buf = memoryview(bytearray(min(n, _COPY_BLOCK)))
    while n > 0:
        want = min(n, len(buf))
        got = src.readinto(buf[:want])
        if not got:
            raise IOError("unexpected EOF in shard file")
        dst.write(buf[:got])
        n -= got
