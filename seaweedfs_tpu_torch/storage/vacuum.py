"""Volume compaction (vacuum): reclaim space from deleted needles — the
port's copy of seaweedfs_tpu/storage/vacuum.py.

Reference behavior (weed/storage/volume_vacuum.go): copy live needles into
shadow files `.cpd`/`.cpx`, then commit by renaming over the originals and
reloading.  The reference's compaction runs concurrently with writes and
replays the raced tail via makeupDiff; here compaction copies under the
volume lock up to the snapshot offset, then commit re-checks for appends
past the snapshot and replays them from the old `.dat` before renaming —
the same recovery obligation, expressed as a replay loop instead of idx
diffing.
"""

from __future__ import annotations

import os
import struct

from ..stats.metrics import SCRUB_ERRORS
from ..util import glog
from . import types as t
from .needle import CorruptNeedleError, Needle, actual_size
from .volume import Volume


def compact(volume: Volume, on_corrupt=None) -> tuple[str, int]:
    """Write .cpd/.cpx shadow files with live needles; returns (base, snapshot).

    Holds the volume lock only long enough to snapshot the end offset; the
    copy itself reads from the immutable prefix of the append-only .dat.
    `on_corrupt(needle_id)` fires for every needle skipped as rotten so
    the caller can queue a repair (Store.compact_volume wires the
    scrubber) — after commit the needle is gone from the local index and
    only a replica re-copy restores it.
    """
    base = volume.file_name()
    with volume._lock:
        volume.sync()
        snapshot_end = volume.content_size
        live = {v.key: v for v in volume.needle_map.items_ascending()}
        version = volume.version
        sb = volume.super_block

    cpd = base + ".cpd"
    cpx = base + ".cpx"
    sb_bytes = bytearray(sb.to_bytes())
    sb_bytes[4:6] = int(sb.compaction_revision + 1).to_bytes(2, "big")
    with open(base + ".dat", "rb") as src, open(cpd, "wb") as dat_out, open(
        cpx, "wb"
    ) as idx_out:
        dat_out.write(bytes(sb_bytes))
        offset = len(sb_bytes)
        for key in sorted(live, key=lambda k: live[k].offset):
            nv = live[key]
            if nv.size <= 0 or nv.offset >= snapshot_end:
                continue
            src.seek(nv.offset)
            blob = src.read(actual_size(nv.size, version))
            # verify while copying: a silently-rotten needle must not be
            # laundered into the compacted volume as fresh-looking bytes
            # (seaweedfs_scrub_errors_total{kind="vacuum"}); the skipped
            # needle heals from a replica via the scrub/repair plane
            try:
                n = Needle.from_bytes(blob, version)
                if n.id != key:
                    raise CorruptNeedleError(
                        f"record at {nv.offset} carries id {n.id:x}")
            except (CorruptNeedleError, ValueError, IndexError,
                    struct.error) as e:
                SCRUB_ERRORS.labels("vacuum").inc()
                glog.warning(
                    "vacuum: skipping corrupt needle %x in volume %d: %s",
                    key, volume.volume_id, e)
                if on_corrupt is not None:
                    on_corrupt(key)
                continue
            dat_out.write(blob)
            idx_out.write(t.pack_index_entry(key, offset, nv.size))
            offset += len(blob)
    return base, snapshot_end


def commit_compact(volume: Volume, snapshot_end: int) -> None:
    """Swap in the shadow files, replaying any appends that raced the copy."""
    base = volume.file_name()
    cpd = base + ".cpd"
    cpx = base + ".cpx"
    with volume._lock:
        volume.sync()
        current_end = volume.content_size
        if current_end > snapshot_end:
            _replay_tail(volume, base, cpd, cpx, snapshot_end, current_end)
        directory, collection, vid = (
            volume.directory,
            volume.collection,
            volume.volume_id,
        )
        # location-scoped attributes survive the in-place re-init: the
        # disk's health machine and tier must keep feeding the same
        # state after a compaction swaps the files underneath
        health, disk_type = volume.health, volume.disk_type
        volume.close()
        os.replace(cpd, base + ".dat")
        os.replace(cpx, base + ".idx")
        # reopen in place: swap internals from a freshly loaded volume
        volume.__init__(directory, collection, vid)
        volume.health = health
        volume.disk_type = disk_type


def _replay_tail(volume: Volume, base: str, cpd: str, cpx: str,
                 snapshot_end: int, current_end: int) -> None:
    """Append records written after the snapshot to the shadow files.

    Mirrors makeupDiff (volume_vacuum.go:179): walk the raced tail of the
    old .dat and apply each record (write or tombstone) to .cpd/.cpx.
    """
    version = volume.version
    with open(base + ".dat", "rb") as src, open(cpd, "r+b") as dat_out, open(
        cpx, "ab"
    ) as idx_out:
        dat_out.seek(0, os.SEEK_END)
        pos = snapshot_end
        while pos < current_end:
            src.seek(pos)
            hdr = src.read(t.NEEDLE_HEADER_SIZE)
            if len(hdr) < t.NEEDLE_HEADER_SIZE:
                break
            n = Needle.parse_header(hdr)
            size = max(n.size, 0)
            rec_len = actual_size(size, version)
            src.seek(pos)
            blob = src.read(rec_len)
            live = volume.needle_map.get(n.id)
            if n.size > 0 and live is not None and live.offset == pos:
                out_off = dat_out.tell()
                dat_out.write(blob)
                idx_out.write(t.pack_index_entry(n.id, out_off, n.size))
            elif n.size == 0 or (live is None):
                # tombstone or superseded record
                idx_out.write(
                    t.pack_index_entry(n.id, 0, t.TOMBSTONE_FILE_SIZE)
                )
            pos += rec_len


def vacuum_volume(volume: Volume) -> None:
    """Full check-compact-commit cycle for one volume."""
    _base, snapshot = compact(volume)
    commit_compact(volume, snapshot)
