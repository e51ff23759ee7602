"""Volume: one `.dat` needle log + `.idx` index + in-memory needle map —
the port's copy of seaweedfs_tpu/storage/volume.py.

Reference behavior (weed/storage/volume.go, volume_write.go, volume_read.go,
volume_checking.go): append-only writes under a lock, tombstone deletes (an
empty needle marks deletion in the log, the index records size -1), CRC
verification on read, and load-time integrity checking that truncates torn
tail appends.

The `.dat` bytes flow through a BackendStorageFile (backend.py — the seam
from weed/storage/backend/backend.go:15): local volumes use DiskFile; a
volume whose `.vif` records a remote tier placement opens the registered
backend's remote file instead (volume_tier.go LoadRemoteFile), and fails
to load while no backend of that name is registered.  `tier_to_remote` /
`tier_to_local` move the `.dat` to and from a tier (volume_grpc_tier.go).
"""

from __future__ import annotations

import itertools
import os
import struct
import threading
import time

from . import types as t
from ..ops import crc32c
from ..util import faultpoint, glog
from .backend import DiskFile, get_backend
from .disk_health import DiskFullError, classify_write_error
from .group_commit import GroupCommitter, Pending
from .idx import IndexWriter, append_index_tombstone, walk_index_file
from .needle import Needle, actual_size, body_length
from .needle_map import NeedleMap
from .super_block import SuperBlock
from .vif import load_volume_info, save_volume_info

# chaos point inside the (unlocked) disk-read section of the needle read
# path: lets tests prove two GETs on one volume overlap
FP_DISK_READ = faultpoint.register("volume.disk.read")

# global mutation-sequence source: values never repeat, even across a
# vacuum's in-place re-__init__, so a cached sequence observed before
# a swap can never collide with one issued after it
_MUTATION_SEQ = itertools.count(1)

# process-wide index kind (needle_map.go:13-19 NeedleMapKind): "memory"
# (compact in-RAM map) or "disk" (sorted-file map with bounded RAM);
# selected by the volume server's -index flag before volumes load
DEFAULT_NEEDLE_MAP_KIND = "memory"


def set_needle_map_kind(kind: str) -> None:
    global DEFAULT_NEEDLE_MAP_KIND
    if kind not in ("memory", "disk"):
        raise ValueError("index kind must be memory or disk")
    DEFAULT_NEEDLE_MAP_KIND = kind


def durability_mode() -> str:
    """Per-mutation durability (group_commit.py): "none" (page cache
    only, today's default), "sync" (one fsync pair per mutation), or
    "batch" (group-commit barrier — one fsync acks many mutations)."""
    mode = os.environ.get("SEAWEEDFS_TPU_DURABILITY", "none").strip().lower()
    return mode if mode in ("none", "sync", "batch") else "none"


class NeedleExtent:
    """A needle's payload located on disk for zero-copy serving: a
    dup'd .dat fd the caller OWNS (close() exactly once) plus the byte
    range os.sendfile should ship, and the metadata-only Needle (no
    data) for headers/cookie checks."""

    __slots__ = ("fd", "data_offset", "data_len", "needle", "_closed")

    def __init__(self, fd: int, data_offset: int, data_len: int,
                 needle: Needle):
        self.fd = fd
        self.data_offset = data_offset
        self.data_len = data_len
        self.needle = needle
        self._closed = False

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                os.close(self.fd)
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Volume:
    def __init__(self, directory: str, collection: str, volume_id: int,
                 super_block: SuperBlock | None = None):
        self.directory = directory
        self.collection = collection
        self.volume_id = volume_id
        self.disk_type = ""  # normalized; "" == hdd (set by DiskLocation)
        self.read_only = False
        # why the volume is read-only: "" (operator/seal), or "full"
        # (disk-fault plane: flips back writable when space returns)
        self.read_only_reason = ""
        # the DiskLocation's DiskHealth (set by DiskLocation); write
        # errors feed its state machine
        self.health = None
        self._tier_in_progress = False
        self._ec_encode_in_progress = False
        self._lock = threading.RLock()
        # bumped on every append/delete (and fresh on vacuum re-init):
        # the needle cache's compare-before-put token (store.py)
        self.write_seq = next(_MUTATION_SEQ)
        base = self.file_name()
        self.volume_info = load_volume_info(base + ".vif")
        remote = self._remote_dat_file()
        if remote is not None:
            # .dat lives on a remote tier: serve reads through it, stay
            # read-only until tier.download brings the bytes back
            self._dat = remote
            self.read_only = True
            self.super_block = SuperBlock.from_bytes(
                self._dat.read_at(0, 64)
            )
        else:
            is_new = not os.path.exists(base + ".dat")
            self.super_block = super_block or SuperBlock()
            self._dat = DiskFile(base + ".dat")
            if is_new:
                self._dat.write_at(0, self.super_block.to_bytes())
            else:
                self.super_block = SuperBlock.from_bytes(
                    self._dat.read_at(0, 64)
                )
        self.version = self.super_block.version
        # quiet-window bookkeeping for ec.encode -quietFor: seed from the
        # .dat mtime at load so a restart doesn't reset the quiet clock
        try:
            self.last_modified_second = int(
                os.path.getmtime(base + ".dat"))
        except OSError:
            self.last_modified_second = int(time.time())
        kind = DEFAULT_NEEDLE_MAP_KIND
        if kind == "disk":
            from .disk_needle_map import DiskNeedleMap

            self.needle_map = (
                DiskNeedleMap.load_from_idx(base + ".idx")
                if os.path.exists(base + ".idx")
                else DiskNeedleMap(base + ".sdx")
            )
        else:
            self.needle_map = (
                NeedleMap.load_from_idx(base + ".idx")
                if os.path.exists(base + ".idx")
                else NeedleMap()
            )
        self.check_and_fix_integrity()
        self._idx = IndexWriter(base + ".idx")
        self.durability = durability_mode()
        self._group = (GroupCommitter(self)
                       if self.durability == "batch" and not self.is_remote
                       else None)
        # (needle_id, offset) pairs whose payload CRC has been verified
        # for zero-copy serving: sendfile ships bytes the CPU never
        # sees, so the first extent serve of a needle pays one userspace
        # read + crc32c and later serves skip it.  Keyed by offset so an
        # overwrite (new offset) re-verifies; bounded, cleared on
        # overflow (worst case = re-verify, never serve rotten bytes).
        self._extent_verified: set[tuple[int, int]] = set()

    def _remote_dat_file(self):
        """The backend's remote file when the .vif maps the .dat to a
        registered tier; None for plain local volumes."""
        if self.volume_info is None:
            return None
        for rf in self.volume_info.files:
            if rf.extension and rf.extension != ".dat":
                continue
            backend = get_backend(f"{rf.backend_type}.{rf.backend_id}")
            if backend is None:
                raise IOError(
                    f"volume {self.volume_id}: .dat is on unconfigured "
                    f"backend {rf.backend_type}.{rf.backend_id}"
                )
            return backend.remote_file(rf.key, rf.file_size)
        return None

    @property
    def is_remote(self) -> bool:
        return self._dat.is_remote

    # -- naming -----------------------------------------------------------

    def file_name(self) -> str:
        name = f"{self.volume_id}"
        if self.collection:
            name = f"{self.collection}_{name}"
        return os.path.join(self.directory, name)

    # -- write path -------------------------------------------------------

    def _check_writable(self, for_delete: bool = False) -> None:
        if not self.read_only:
            return
        if self.read_only_reason == "full":
            if for_delete:
                # deletes FREE space and a tombstone is ~40 bytes: they
                # run against the reserved watermark headroom (the disk
                # flipped full while min-free bytes remained), otherwise
                # a full disk could never be drained back to healthy
                return
            raise DiskFullError(
                28, f"volume {self.volume_id} is full (read-only-full)")
        raise PermissionError(f"volume {self.volume_id} is read-only")

    def _fail_write(self, e: OSError, start: int,
                    idx_pos: int | None = None) -> OSError:
        """Roll a failed mutation back to a consistent pre-write state:
        truncate the .dat to `start` (dropping any torn blob bytes the
        failed write landed) and the .idx to `idx_pos`; feed the error
        into the disk health machine; flip read-only-full on ENOSPC.
        Returns the typed error to raise (DiskFullError/DiskFailingError).
        No in-memory index entry exists for the unacked bytes — callers
        only publish to the needle map after every durable write
        succeeded."""
        typed = classify_write_error(e, self._dat.name)
        try:
            self._dat.truncate(start)
        except OSError as e2:  # rollback itself failed: disk is dying
            glog.warning("volume %d: rollback truncate to %d failed: %s "
                         "(load-time healer will truncate on remount)",
                         self.volume_id, start, e2)
        if idx_pos is not None:
            try:
                self._idx.truncate(idx_pos)
            except OSError:
                pass  # a torn trailing idx entry is dropped by the loader
        if self.health is not None:
            self.health.record_write_error(typed)
        if isinstance(typed, DiskFullError):
            # read-only-full: reads keep serving, writers get the typed
            # 409 and re-assign; mark_writable/space recovery clears it
            self.read_only = True
            self.read_only_reason = "full"
        return typed

    def _publish_append(self, needle_id: int, offset: int,
                        size: int) -> None:
        """Make an append visible: needle-map entry + write_seq bump +
        health credit.  Callers hold the volume lock.  In batch mode the
        flush barrier calls this AFTER its fsync — no reader can observe
        a needle whose bytes aren't durable yet."""
        old = self.needle_map.get(needle_id)
        if old is None or old.offset < offset:
            self.needle_map.put(needle_id, offset, size)
        if self.health is not None:
            self.health.record_write_ok()
        self.write_seq = next(_MUTATION_SEQ)

    def _publish_delete(self, needle_id: int) -> None:
        self.needle_map.delete(needle_id)
        if self.health is not None:
            self.health.record_write_ok()
        self.write_seq = next(_MUTATION_SEQ)

    def _sync_now(self, start: int, idx_pos: int | None) -> None:
        """Strict per-mutation durability ("sync" mode): one fsync pair
        before the publish/ack, rolled back like any failed write."""
        try:
            self._dat.sync()
            self._idx.flush()
        except OSError as e:
            raise self._fail_write(e, start, idx_pos) from e

    def append_needle(self, n: Needle) -> tuple[int, int]:
        """Append; returns (actual_offset, stored_size).

        Crash/fault discipline: the needle map and .idx are only updated
        after the .dat blob landed in full; any OSError rolls the .dat
        back to its pre-append size and surfaces as a typed
        DiskFullError/DiskFailingError — a mid-blob ENOSPC can never
        leave a published index entry pointing at a torn tail.

        Durability modes (group_commit.py): "none" acks from the page
        cache; "sync" fsyncs per append; "batch" parks on the volume's
        flush barrier OUTSIDE the lock — concurrent writers keep
        appending while this one waits, and one fsync acks them all."""
        group = self._group
        with self._lock:
            self._check_writable()
            start = self._dat.file_size()
            offset = start
            pad = -offset % t.NEEDLE_PADDING_SIZE  # heal torn tail
            if offset + pad >= t.MAX_POSSIBLE_VOLUME_SIZE:
                raise IOError("volume size limit exceeded")
            try:
                if pad:
                    self._dat.write_at(offset, b"\0" * pad)
                    offset += pad
                if not n.append_at_ns:
                    n.append_at_ns = time.time_ns()
                self.last_modified_second = int(time.time())
                blob = n.to_bytes(self.version)
                wrote = self._dat.write_at(offset, blob)
                if wrote != len(blob):
                    raise OSError(
                        5, f"short write: {wrote}/{len(blob)} bytes")
            except OSError as e:
                raise self._fail_write(e, start) from e
            idx_pos = None
            old = self.needle_map.get(n.id)
            if old is None or old.offset < offset:
                idx_pos = self._idx.tell()
                try:
                    self._idx.put(n.id, offset, n.size)
                except OSError as e:
                    # the blob is durable but unindexed: roll BOTH back —
                    # an acked write must be remount-provable via the .idx
                    raise self._fail_write(e, start, idx_pos) from e
            if group is None:
                if self.durability == "sync":
                    self._sync_now(start, idx_pos)
                self._publish_append(n.id, offset, n.size)
                return offset, n.size
            pending = Pending(
                lambda: self._publish_append(n.id, offset, n.size),
                start, idx_pos)
        group.park(pending)  # outside the lock: the barrier batches
        return offset, n.size

    def delete_needle(self, needle_id: int,
                      at_ns: int | None = None) -> int:
        """Append a tombstone marker needle; returns freed byte count.

        `at_ns` preserves the ORIGIN's tombstone timestamp when the
        delete is replayed from another server (tail receivers, backup
        mirrors) — a locally-stamped tombstone would poison tail
        watermarks under clock skew."""
        group = self._group
        with self._lock:
            self._check_writable(for_delete=True)
            existing = self.needle_map.get(needle_id)
            if existing is None:
                return 0
            marker = Needle(id=needle_id, cookie=0, data=b"")
            start = self._dat.file_size()
            offset = start
            # tombstones grow the log too: the offset cap append_needle
            # enforces guards index addressability (offsets store /8 in
            # 32 bits), so a full-size volume must not creep past it
            # via deletes either
            if offset >= t.MAX_POSSIBLE_VOLUME_SIZE:
                raise IOError("volume size limit exceeded")
            marker.append_at_ns = at_ns or time.time_ns()
            blob = marker.to_bytes(self.version)
            try:
                wrote = self._dat.write_at(offset, blob)
                if wrote != len(blob):
                    raise OSError(
                        5, f"short write: {wrote}/{len(blob)} bytes")
            except OSError as e:
                raise self._fail_write(e, start) from e
            idx_pos = self._idx.tell()
            try:
                self._idx.delete(needle_id, offset)
            except OSError as e:
                raise self._fail_write(e, start, idx_pos) from e
            self.last_modified_second = int(time.time())
            freed = max(existing.size, 0)
            if group is None:
                if self.durability == "sync":
                    self._sync_now(start, idx_pos)
                self._publish_delete(needle_id)
                return freed
            pending = Pending(
                lambda: self._publish_delete(needle_id), start, idx_pos)
        group.park(pending)  # tombstones ride the same barrier: the
        # batch rollback may truncate anything above its start, so every
        # mutation on a batch-mode volume must be IN the batch
        return freed

    # -- read path --------------------------------------------------------

    def read_needle(self, needle_id: int, expected_cookie: int | None = None) -> Needle:
        """Lock-split read: the lock covers only the needle-map lookup and
        the .dat handle snapshot; the disk read itself runs outside it via
        a positioned pread, so concurrent GETs on one volume overlap
        instead of serializing behind each other's I/O.

        Safety: the .dat is append-only, so an offset published in the
        needle map always names fully-written bytes in the snapshotted
        handle; the only racer that can hurt is a handle SWAP (vacuum
        commit / tier move), which closes the old fd — that read fails
        with OSError/ValueError (or short-reads) and retries under the
        lock against the fresh handle and a fresh map entry."""
        with self._lock:
            nv = self.needle_map.get(needle_id)
            if nv is None or t.size_is_deleted(nv.size):
                raise KeyError(f"needle {needle_id:x} not found")
            dat = self._dat
            version = self.version
        faultpoint.inject(FP_DISK_READ, ctx=str(self.volume_id))
        n = None
        try:
            blob = dat.pread(nv.offset, actual_size(nv.size, version))
            parsed = Needle.from_bytes(blob, version)
            if parsed.size == nv.size:
                n = parsed
        except (OSError, ValueError, struct.error):
            pass
        if n is None:
            # racing handle swap: a closed fd errors/short-reads, and a
            # REUSED fd number can even hand back `want` bytes of the
            # wrong file — any inconsistency (error, short read, parse
            # failure, size mismatch) re-resolves everything under the
            # lock, where the locked path's own errors are authoritative
            with self._lock:
                nv = self.needle_map.get(needle_id)
                if nv is None or t.size_is_deleted(nv.size):
                    raise KeyError(f"needle {needle_id:x} not found")
                version = self.version
                blob = self._dat.read_at(
                    nv.offset, actual_size(nv.size, version)
                )
            n = Needle.from_bytes(blob, version)
            if n.size != nv.size:
                raise IOError("size mismatch reading needle")
        if expected_cookie is not None and n.cookie != expected_cookie:
            raise PermissionError("cookie mismatch")
        return n

    def needle_extent(self, needle_id: int) -> "NeedleExtent | None":
        """Zero-copy serving descriptor: the needle's METADATA (header,
        flags, name/mime, stored checksum) parsed from two small preads,
        plus a dup'd fd + (offset, length) naming the payload bytes in
        the .dat — os.sendfile streams them disk→socket without ever
        entering userspace.  The dup (taken under the lock) pins the
        open file description, so a racing vacuum handle swap can
        neither close it mid-send nor recycle the fd number onto another
        file; the dup'd fd reads the OLD append-only .dat, whose bytes
        for this needle are immutable.

        Returns None when the volume can't serve an extent (remote tier,
        v1 layout, empty payload, parse anomaly) — callers fall back to
        the ordinary read path.  Raises KeyError like read_needle when
        the needle doesn't exist."""
        with self._lock:
            nv = self.needle_map.get(needle_id)
            if nv is None or t.size_is_deleted(nv.size):
                raise KeyError(f"needle {needle_id:x} not found")
            dat = self._dat
            version = self.version
            if dat.is_remote or version not in (2, 3) or nv.size <= 0:
                return None
            try:
                fd = os.dup(dat.fileno())
            except (OSError, ValueError, AttributeError):
                return None
        try:
            head = os.pread(fd, t.NEEDLE_HEADER_SIZE + 4, nv.offset)
            if len(head) != t.NEEDLE_HEADER_SIZE + 4:
                raise ValueError("short header read")
            n = Needle.parse_header(head)
            if n.id != needle_id or n.size != nv.size:
                raise ValueError("stale extent header")
            data_size = struct.unpack(
                ">I", head[t.NEEDLE_HEADER_SIZE:])[0]
            meta_len = nv.size - 4 - data_size
            if meta_len < 1:  # at least the flags byte
                raise ValueError("needle data out of range")
            tail_len = meta_len + t.NEEDLE_CHECKSUM_SIZE
            if version == 3:
                tail_len += t.TIMESTAMP_SIZE
            tail = os.pread(
                fd, tail_len,
                nv.offset + t.NEEDLE_HEADER_SIZE + 4 + data_size)
            if len(tail) != tail_len:
                raise ValueError("short meta read")
            # a zero-length fake data field turns the tail into a valid
            # v2 body, so the standard field walk parses flags/name/mime
            n.parse_body_v2(struct.pack(">I", 0) + tail[:meta_len])
            stored = struct.unpack(
                ">I", tail[meta_len:meta_len + 4])[0]
            n.checksum = crc32c.unmask(stored)
            if version == 3:
                n.append_at_ns = struct.unpack(
                    ">Q", tail[meta_len + 4:meta_len + 12])[0]
            # first serve of this (needle, offset) pays one userspace
            # read to verify the payload CRC — sendfile would otherwise
            # ship rotten bytes as a 200 that the ordinary read path
            # turns into CorruptNeedleError + quarantine.  The read also
            # warms the page cache for the sendfile that follows.
            vkey = (needle_id, nv.offset)
            if vkey not in self._extent_verified:
                data = os.pread(
                    fd, data_size, nv.offset + t.NEEDLE_HEADER_SIZE + 4)
                if (len(data) != data_size
                        or crc32c.checksum(data) != n.checksum):
                    raise ValueError("extent payload CRC mismatch")
                if len(self._extent_verified) >= 65536:
                    self._extent_verified.clear()
                self._extent_verified.add(vkey)
            return NeedleExtent(
                fd, nv.offset + t.NEEDLE_HEADER_SIZE + 4, data_size, n)
        except (OSError, ValueError, struct.error):
            os.close(fd)
            return None

    # -- remote tier ------------------------------------------------------

    def tier_to_remote(self, backend_name: str, keep_local: bool = False,
                       progress=None) -> int:
        """Upload the .dat to a remote tier, record it in the .vif, and
        reopen through the remote file (volume.tier.upload;
        volume_grpc_tier.go).  Returns bytes uploaded.

        The order is upload, .vif, reopen, then remove the local .dat, so
        a crash at any point leaves the volume readable from one side.
        The upload runs OUTSIDE the volume lock: the volume is read-only
        and the .dat append-only, so the bytes are immutable while they
        move and reads keep being served (a throttled lifecycle tier job
        paces the upload through the progress callback)."""
        backend = get_backend(backend_name)
        if backend is None:
            raise IOError(f"backend {backend_name} not configured")
        with self._lock:
            if self.is_remote:
                raise IOError(f"volume {self.volume_id} is already remote")
            if self._tier_in_progress:
                raise IOError(
                    f"volume {self.volume_id}: tier move already running")
            self._tier_in_progress = True
            self.read_only = True  # no appends while the bytes move
            self._dat.sync()
            base = self.file_name()
            key = f"{os.path.basename(base)}.dat"
            size = self._dat.file_size()
        try:
            backend.upload_file(base + ".dat", key, progress=progress)
            with self._lock:
                save_volume_info(
                    base + ".vif", self.version,
                    replication=str(self.super_block.replica_placement or ""),
                    dat_file_size=size,
                    remote_files=[{
                        "backend_type": backend.backend_type,
                        "backend_id": backend.backend_id,
                        "key": key,
                        "file_size": size,
                        "modified_time": int(time.time()),
                        "extension": ".dat",
                    }])
                self.volume_info = load_volume_info(base + ".vif")
                self._dat.close()
                self._dat = backend.remote_file(key, size)
                if not keep_local:
                    os.remove(base + ".dat")
                return size
        finally:
            with self._lock:
                self._tier_in_progress = False

    def tier_to_local(self, progress=None) -> int:
        """Download the .dat back from its remote tier and reopen locally
        (volume.tier.download).  Returns bytes downloaded."""
        with self._lock:
            if not self.is_remote:
                return 0
            remote = self._dat
            base = self.file_name()
            got = remote.backend.download_file(remote.key, base + ".dat",
                                               progress=progress)
            remote.backend.delete_file(remote.key)
            save_volume_info(
                base + ".vif", self.version,
                replication=str(self.super_block.replica_placement or ""),
                dat_file_size=got)
            self.volume_info = load_volume_info(base + ".vif")
            self._dat = DiskFile(base + ".dat")
            self.read_only = False
            return got

    # -- stats / lifecycle ------------------------------------------------

    def flush(self) -> None:
        """Fence buffered appends so other handles see consistent
        .dat/.idx files (bulk copy streams them by path)."""
        with self._lock:
            self._dat.sync()
            self._idx.flush()

    @property
    def content_size(self) -> int:
        # under the lock: tier transitions swap self._dat and a heartbeat
        # thread polling sizes must not see the half-closed handle
        with self._lock:
            return self._dat.file_size()

    def garbage_level(self) -> float:
        size = self.content_size
        return self.needle_map.deleted_bytes / size if size else 0.0

    def file_count(self) -> int:
        return len(self.needle_map)

    def sync(self) -> None:
        with self._lock:
            self._dat.sync()
            self._idx.flush()

    def close(self) -> None:
        with self._lock:
            self._dat.close()
            self._idx.close()
            if hasattr(self.needle_map, "close"):
                self.needle_map.close()

    # -- integrity --------------------------------------------------------

    def check_and_fix_integrity(self) -> None:
        """Verify the last index entry matches the .dat; truncate torn tails.

        Reference: CheckAndFixVolumeDataIntegrity (volume_checking.go:17) —
        the last entry's record must lie fully inside the file and carry the
        expected needle id; otherwise the torn tail is truncated away.
        Remote-tier volumes skip the fix (their bytes are immutable).
        """
        file_size = self._dat.file_size()
        last = None
        for v in self.needle_map.items_ascending():
            if last is None or v.offset > last.offset:
                last = v
        if last is None:
            return
        end = last.offset + actual_size(max(last.size, 0), self.version)
        if end > file_size:
            if self.is_remote:
                raise IOError(
                    f"volume {self.volume_id}: remote .dat shorter than index"
                )
            if self._repad_torn_tail(last, file_size, end):
                return
            # torn append: drop the entry and truncate to the previous
            # record.  The drop must ALSO reach the on-disk .idx (as a
            # tombstone): the stale entry would otherwise resurface on
            # the next load and claim whatever new record gets appended
            # at the reclaimed offset — truncating an acked write
            self.needle_map.delete(last.key)
            append_index_tombstone(self.file_name() + ".idx", last.key)
            self._dat.truncate(last.offset)
            return
        hdr = self._dat.read_at(last.offset, t.NEEDLE_HEADER_SIZE)
        if len(hdr) == t.NEEDLE_HEADER_SIZE:
            n = Needle.parse_header(hdr)
            if n.id != last.key:
                self.needle_map.delete(last.key)
                append_index_tombstone(
                    self.file_name() + ".idx", last.key)

    def _repad_torn_tail(self, last, file_size: int, end: int) -> bool:
        """Tear-at-padding-boundary heal: when ONLY trailing padding
        bytes of the last record are missing (every real byte — header,
        body, checksum, v3 timestamp — is present and CRC-clean), the
        acked needle is intact; dropping it would turn a cosmetic tear
        into acked-write loss.  Re-pad the file to the aligned end
        instead.  -> True when healed."""
        from .needle import padding_length

        have = file_size - last.offset
        size = max(last.size, 0)
        unpadded = (actual_size(size, self.version)
                    - padding_length(size, self.version))
        if have < unpadded:
            return False  # real bytes missing: a genuine torn append
        try:
            blob = self._dat.read_at(last.offset, have)
            n = Needle.from_bytes(blob, self.version)
        except (ValueError, struct.error, OSError):
            return False
        if n.id != last.key or n.size != last.size:
            return False
        self._dat.write_at(file_size, b"\0" * (end - file_size))
        glog.info("volume %d: re-padded torn tail (%d pad bytes) for "
                  "needle %x", self.volume_id, end - file_size, last.key)
        return True
