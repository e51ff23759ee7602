"""Store: the per-volume-server aggregate over disk locations — the port's
copy of seaweedfs_tpu/storage/store.py.

Routes needle operations by volume id, manages EC volumes/shards, and keeps
the incremental (delta) volume and EC registrations a volume server sends
its master.  Reference: weed/storage/store.go + store_ec.go.

Differences from the reference, on purpose:
  * the codec defaults to ``cuda``, and a ``cuda`` store works only on the
    card: `generate_ec_shards` and `rebuild_ec_shards` build the codec
    they were asked for and raise without one (the reference asks
    `effective_codec`, logs "codec unreachable" and goes on, and its
    codec then switches itself to the host).  ``auto`` is resolved once,
    when the store is made, and the choice is logged;
  * the delta lists hold the port's own small records, with the field
    names of master.proto's VolumeShortInformationMessage and
    VolumeEcShardInformationMessage: a generated master_pb2 in this
    package would register `master.proto` a second time in protobuf's
    default pool, next to the reference's.  The heartbeat itself
    (`collect_heartbeat`, `drain_deltas`) belongs to the volume-server
    slice, which gives the port's messages a private DescriptorPool;
  * no partial-sum repair client (storage/ec/partial.py is not ported).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

from ..ops.codec import resolve_codec_name
from ..util import glog
from .disk_location import DiskLocation
from .ec import constants as ecc
from .ec.encoder import (
    rebuild_ec_files,
    write_ec_files,
    write_sorted_file_from_idx,
)
from .ec.decoder import (
    find_dat_file_size,
    write_dat_file,
    write_idx_file_from_ec_index,
)
from .ec.shard_bits import ShardBits
from .ec.volume import EcVolume
from .needle import CorruptNeedleError, Needle
from ..util.chunk_cache import NeedleCache
from .disk_health import DiskFailingError, DiskFullError
from .replica_placement import ReplicaPlacement
from .super_block import CURRENT_VERSION, SuperBlock
from .ttl import TTL
from .vacuum import commit_compact, compact
from .vif import save_volume_info


@dataclass
class VolumeShortInformationMessage:
    """A volume registered or removed since the last heartbeat."""

    id: int
    collection: str = ""
    replica_placement: int = 0
    version: int = 0
    ttl: int = 0
    disk_type: str = ""

    @classmethod
    def of(cls, v) -> "VolumeShortInformationMessage":
        return cls(
            id=v.volume_id,
            collection=v.collection,
            replica_placement=v.super_block.replica_placement.to_byte(),
            version=v.version,
            ttl=v.super_block.ttl.to_uint32(),
            disk_type=getattr(v, "disk_type", ""),
        )


@dataclass
class VolumeEcShardInformationMessage:
    """EC shards mounted or unmounted since the last heartbeat."""

    id: int
    collection: str = ""
    ec_index_bits: int = 0
    disk_type: str = ""
    shard_size: int = 0


class Store:
    def __init__(
        self,
        directories: list[str],
        ip: str = "localhost",
        port: int = 8080,
        public_url: str = "",
        data_center: str = "",
        rack: str = "",
        codec_name: str = "cuda",
        max_volume_counts: dict[str, int] | None = None,
        disk_types: list[str] | None = None,
        needle_cache_mb: int | None = None,  # None = env / 32MB default
    ):
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.data_center = data_center
        self.rack = rack
        if codec_name == "auto":
            codec_name = resolve_codec_name("auto")
            glog.info("store: codec auto resolved to %s", codec_name)
        self.codec_name = codec_name
        disk_types = disk_types or []
        self.locations = [
            DiskLocation(
                d, codec_name=codec_name,
                disk_type=disk_types[i] if i < len(disk_types) else "",
            )
            for i, d in enumerate(directories)
        ]
        if max_volume_counts is None:
            max_volume_counts = {}
            for loc in self.locations:
                max_volume_counts[loc.disk_type] = (
                    max_volume_counts.get(loc.disk_type, 0)
                    + loc.max_volume_count)
        self.max_volume_counts = max_volume_counts
        self._lock = threading.RLock()
        # delta channels to the master (drained into heartbeats)
        self.new_volumes: list[VolumeShortInformationMessage] = []
        self.deleted_volumes: list[VolumeShortInformationMessage] = []
        self.new_ec_shards: list[VolumeEcShardInformationMessage] = []
        self.deleted_ec_shards: list[VolumeEcShardInformationMessage] = []
        self.volume_size_limit = 30 * 1024 * 1024 * 1024
        # vid -> FetchFn factory, injected by the volume server so EcVolumes
        # can read remote shards (store_ec.go's readRemoteEcShardInterval)
        self.ec_fetcher_factory = None
        # self-healing integrity plane (storage/scrub.py): the volume
        # server installs its Scrubber here; the read path feeds CRC
        # failures into its quarantine + confirm queue
        self.scrubber = None
        # disk-fault plane: fired after a classified write fault (or a
        # watermark state change) so the volume server can push a full
        # heartbeat NOW instead of on the next pulse — the master must
        # stop assigning to a full disk within one beat
        self.on_disk_event = None
        # hot-needle cache: repeated small-file GETs skip needle-map
        # lookup, disk read and CRC parse.  Per-store (never process
        # global: two in-process test clusters may reuse volume ids);
        # 0 disables
        if needle_cache_mb is None:
            needle_cache_mb = int(
                os.environ.get("SEAWEEDFS_TPU_NEEDLE_CACHE_MB", "32"))
        self.needle_cache = (
            NeedleCache(needle_cache_mb << 20) if needle_cache_mb > 0
            else None
        )

    # -- lookup -----------------------------------------------------------

    def find_volume(self, vid: int):
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                return v
        return None

    def find_ec_volume(self, vid: int) -> EcVolume | None:
        for loc in self.locations:
            ev = loc.ec_volumes.get(vid)
            if ev is not None:
                return ev
        return None

    def _location_of(self, vid: int) -> DiskLocation | None:
        for loc in self.locations:
            if vid in loc.volumes or vid in loc.ec_volumes:
                return loc
        return None

    def has_free_location(self, disk_type: str = "") -> DiskLocation | None:
        """Freest location, optionally restricted to a disk type
        ('' accepts the default/hdd tier only when requested as such by
        an explicit allocation; None semantics: any type when no volume
        of the requested type exists is NOT applied — the reference
        refuses allocation on a missing tier)."""
        from .disk_location import normalize_disk_type

        want = normalize_disk_type(disk_type)
        best, free = None, 0
        for loc in self.locations:
            if loc.disk_type != want:
                continue
            f = loc.max_volume_count - loc.volume_count()
            if f > free:
                best, free = loc, f
        return best

    # -- volume lifecycle -------------------------------------------------

    def add_volume(self, vid: int, collection: str, replication: str = "000",
                   ttl: str = "", preallocate: int = 0,
                   disk_type: str = "") -> None:
        with self._lock:
            if self.find_volume(vid) is not None:
                raise ValueError(f"volume {vid} already exists")
            loc = self.has_free_location(disk_type)
            if loc is None:
                raise IOError("no free disk location")
            sb = SuperBlock(
                version=CURRENT_VERSION,
                replica_placement=ReplicaPlacement.parse(replication),
                ttl=TTL.parse(ttl),
            )
            v = loc.add_volume(vid, collection, super_block=sb)
            save_volume_info(v.file_name() + ".vif", v.version)
            self.new_volumes.append(VolumeShortInformationMessage.of(v))

    def delete_volume(self, vid: int) -> bool:
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.get(vid)
                if v is not None:
                    info = VolumeShortInformationMessage.of(v)
                    if loc.delete_volume(vid):
                        if self.needle_cache is not None:
                            self.needle_cache.drop_volume(vid)
                        if self.scrubber is not None:
                            self.scrubber.quarantine.drop_volume(vid)
                        self.deleted_volumes.append(info)
                        return True
            return False

    def unmount_volume(self, vid: int) -> bool:
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.get(vid)
                if v is not None:
                    info = VolumeShortInformationMessage.of(v)
                    if loc.unmount_volume(vid):
                        if self.needle_cache is not None:
                            self.needle_cache.drop_volume(vid)
                        if self.scrubber is not None:
                            self.scrubber.forget_volume(vid)
                        self.deleted_volumes.append(info)
                        return True
            return False

    def mount_volume(self, vid: int) -> bool:
        with self._lock:
            for loc in self.locations:
                for fname in os.listdir(loc.directory):
                    if not fname.endswith(".dat"):
                        continue
                    base = fname[:-4]
                    from .disk_location import parse_volume_file_name

                    try:
                        collection, fvid = parse_volume_file_name(base)
                    except ValueError:
                        continue
                    if fvid == vid:
                        v = loc.add_volume(vid, collection)
                        self.new_volumes.append(
                            VolumeShortInformationMessage.of(v))
                        if self.scrubber is not None:
                            # a (re)mount replaced the volume's bytes —
                            # a repair's VolumeCopy lands here; stale
                            # findings/quarantine must not re-deliver
                            self.scrubber.forget_volume(vid)
                        return True
            return False

    def mark_readonly(self, vid: int) -> bool:
        v = self.find_volume(vid)
        if v is None:
            return False
        v.read_only = True
        return True

    def mark_writable(self, vid: int) -> bool:
        v = self.find_volume(vid)
        if v is None:
            return False
        v.read_only = False
        v.read_only_reason = ""
        return True

    # -- disk-fault survival plane ----------------------------------------

    def apply_disk_health(self) -> list:
        """Poll every location's watermark state machine and reconcile
        volume writability with it: a full/failing disk flips its
        volumes read-only-full (reads keep serving); a recovered disk
        flips back exactly the volumes the fault plane froze — an
        operator's or the lifecycle plane's read-only stays.
        -> [DiskHealth snapshot per location], heartbeat-ready."""
        snaps = []
        for loc in self.locations:
            h = loc.health
            state = h.poll()
            writable = state not in ("full", "failing")
            with loc._lock:
                for v in loc.volumes.values():
                    if not writable:
                        if not v.read_only and not v.is_remote:
                            v.read_only = True
                            v.read_only_reason = "full"
                    elif v.read_only and v.read_only_reason == "full":
                        v.read_only = False
                        v.read_only_reason = ""
            snaps.append(h.snapshot())
        return snaps

    def note_write_fault(self, vid: int) -> None:
        """A volume mutation just failed with a typed disk error: the
        volume already flipped read-only-full; re-poll the watermarks
        (the whole location may be full) and wake the heartbeat so the
        master re-routes within one beat, not one pulse."""
        self.apply_disk_health()
        cb = self.on_disk_event
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — never fail the write path
                pass

    # -- needle ops -------------------------------------------------------

    def invalidate_needle(self, vid: int, needle_id: int) -> None:
        """Drop one needle from the hot cache.  Called by every mutation
        that goes through the store, and by handlers that write/delete on
        a Volume directly (tail receivers, EC blob deletes)."""
        if self.needle_cache is not None:
            self.needle_cache.invalidate(vid, needle_id)

    def write_needle(self, vid: int, n: Needle) -> int:
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        try:
            _offset, size = v.append_needle(n)
        except (DiskFullError, DiskFailingError):
            self.note_write_fault(vid)
            raise
        self.invalidate_needle(vid, n.id)
        return size

    def read_needle(self, vid: int, needle_id: int,
                    expected_cookie: int | None = None) -> Needle:
        cache = self.needle_cache
        if cache is not None:
            n = cache.get(vid, needle_id)
            if n is not None:
                if expected_cookie is not None and n.cookie != expected_cookie:
                    raise PermissionError("cookie mismatch")
                return n
        v = self.find_volume(vid)
        if v is not None:
            seq = v.write_seq  # snapshot BEFORE the read
            try:
                n = v.read_needle(needle_id, expected_cookie)
            except CorruptNeedleError:
                # silent corruption on the hot path: quarantine the
                # needle (the scrubber confirms + the master repairs)
                # and let the retryable error reach the caller, whose
                # replica failover rotates to a healthy copy
                if self.scrubber is not None:
                    self.scrubber.suspect_needle(vid, needle_id)
                raise
            if cache is not None:
                # compare-and-put under the volume lock: a racing
                # append/delete bumps write_seq before its own
                # invalidate, so a stale needle can never be published
                # after the invalidation that should have killed it
                with v._lock:
                    if v.write_seq == seq:
                        cache.put(vid, needle_id, n)
            return n
        ev = self.find_ec_volume(vid)
        if ev is not None:
            seq = ev.delete_seq
            n = ev.read_needle(needle_id)
            if cache is not None:
                # same compare-and-put discipline as the volume path,
                # serialized by the journal lock the deleter bumps
                # delete_seq under — without it a preempted reader could
                # publish a tombstoned needle after its invalidation
                with ev._ecj_lock:
                    if ev.delete_seq == seq:
                        cache.put(vid, needle_id, n)
            if expected_cookie is not None and n.cookie != expected_cookie:
                raise PermissionError("cookie mismatch")
            return n
        raise KeyError(f"volume {vid} not found")

    def needle_extent(self, vid: int, needle_id: int):
        """-> (NeedleExtent | None, fallback_reason | None) for the
        zero-copy GET path.  A needle-cache hit declines the extent —
        bytes already in memory beat a disk→socket sendfile; EC and
        remote-tier volumes decline too (their bytes aren't a contiguous
        local .dat range).  Raises KeyError like read_needle when
        neither a volume nor the needle exists."""
        cache = self.needle_cache
        if cache is not None and cache.get(vid, needle_id) is not None:
            return None, "cache"
        v = self.find_volume(vid)
        if v is None:
            if self.find_ec_volume(vid) is not None:
                return None, "ec"
            raise KeyError(f"volume {vid} not found")
        if v.is_remote:
            return None, "remote"
        ext = v.needle_extent(needle_id)
        if ext is None:
            return None, "error"
        return ext, None

    def delete_needle(self, vid: int, needle_id: int) -> int:
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        try:
            freed = v.delete_needle(needle_id)
        except (DiskFullError, DiskFailingError):
            self.note_write_fault(vid)
            raise
        self.invalidate_needle(vid, needle_id)
        return freed

    def delete_ec_needle(self, vid: int, needle_id: int) -> int:
        """Tombstone a needle in a local EC volume (.ecx in place + .ecj).
        Returns the needle's stored size (0 when already gone).
        Reference: store_ec_delete.go DeleteEcShardNeedle local half."""
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise KeyError(f"ec volume {vid} not found")
        try:
            _offset, size = ev.find_needle_from_ecx(needle_id)
        except KeyError:
            return 0
        ev.delete_needle(needle_id)
        self.invalidate_needle(vid, needle_id)
        return max(size, 0)

    # -- vacuum -----------------------------------------------------------

    def check_compact_volume(self, vid: int) -> float:
        v = self.find_volume(vid)
        return v.garbage_level() if v else 0.0

    def compact_volume(self, vid: int) -> int:
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        if (v.is_remote or v._tier_in_progress
                or getattr(v, "_ec_encode_in_progress", False)):
            # compacting would swap the .dat under a remote placement,
            # an in-flight tier upload, or an EC generate — all of
            # which read the files by path
            raise ValueError(
                f"volume {vid} is remote-tiered, tiering or EC-encoding;"
                " not compactable")
        on_corrupt = None
        if self.scrubber is not None:
            # a needle the copy skipped as rotten leaves the compacted
            # index too — only a whole-volume re-copy from a healthy
            # replica brings it back, so the finding must reach the
            # master even though it can't be re-verified in place
            def on_corrupt(needle_id: int) -> None:
                self.scrubber.report_corruption(
                    vid, "replica", needle_id=needle_id,
                    detail="corrupt needle dropped during vacuum")
        _base, snapshot = compact(v, on_corrupt=on_corrupt)
        self._compact_snapshots = getattr(self, "_compact_snapshots", {})
        self._compact_snapshots[vid] = snapshot
        return snapshot

    def commit_compact_volume(self, vid: int) -> None:
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        snapshot = getattr(self, "_compact_snapshots", {}).pop(vid, None)
        if snapshot is None:
            raise ValueError(f"no compaction in progress for {vid}")
        commit_compact(v, snapshot)
        # every offset (and the handle) changed wholesale
        if self.needle_cache is not None:
            self.needle_cache.drop_volume(vid)

    def cleanup_compact_volume(self, vid: int) -> None:
        v = self.find_volume(vid)
        if v is None:
            return
        base = v.file_name()
        for ext in (".cpd", ".cpx"):
            try:
                os.remove(base + ext)
            except FileNotFoundError:
                pass
        getattr(self, "_compact_snapshots", {}).pop(vid, None)

    # -- EC ops -----------------------------------------------------------

    def generate_ec_shards(self, vid: int, collection: str,
                           codec_name: str | None = None) -> None:
        """The VolumeEcShardsGenerate work: .dat -> .ecNN + .ecx + .vif."""
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        base = v.file_name()
        v.sync()
        # the encoder reads .dat/.idx BY PATH: a vacuum commit swapping
        # them mid-generation (possible since the emergency path may
        # force-vacuum read-only volumes) would mix pre- and post-
        # compact offsets into the shards — mutual exclusion both ways
        v._ec_encode_in_progress = True
        try:
            # the codec asked for, or an error: no switch to the host
            write_ec_files(base, codec_name=codec_name or self.codec_name)
            write_sorted_file_from_idx(base)
            save_volume_info(base + ".vif", v.version,
                             dat_file_size=os.path.getsize(base + ".dat"))
        finally:
            v._ec_encode_in_progress = False

    def rebuild_ec_shards(self, vid: int, collection: str,
                          codec_name: str | None = None,
                          shard_size: int | None = None) -> list[int]:
        """Rebuild locally-missing shard files.  A node holding fewer
        than DATA_SHARDS local shards streams the missing SOURCE
        intervals from peers through the same shard-read fetcher the
        degraded-read path uses, instead of failing.  `shard_size`
        overrides the volume's own (the size hint of a master's plan).
        Runs on the codec asked for, or raises."""
        base = self._ec_base(vid, collection)
        remote_fetch = None
        ev = self.find_ec_volume(vid)
        if ev is not None:
            remote_fetch = ev.remote_fetch
            if shard_size is None:
                try:
                    shard_size = ev.shard_size or None
                except (OSError, IOError):
                    shard_size = None
        elif self.ec_fetcher_factory is not None:
            remote_fetch = self.ec_fetcher_factory(vid)
        return rebuild_ec_files(
            base, codec_name=codec_name or self.codec_name,
            remote_fetch=remote_fetch, shard_size=shard_size)

    def _ec_base(self, vid: int, collection: str = "") -> str:
        for loc in self.locations:
            ev = loc.ec_volumes.get(vid)
            if ev is not None:
                return ev.base_name
            base = loc.base_name(vid, collection)
            if os.path.exists(base + ".ecx") or os.path.exists(base + ".ec00"):
                return base
            base = loc.base_name(vid, "")
            if os.path.exists(base + ".ecx") or os.path.exists(base + ".ec00"):
                return base
        raise KeyError(f"ec volume {vid} not found")

    def mount_ec_shards(self, vid: int, collection: str,
                        shard_ids: list[int]) -> None:
        with self._lock:
            ev = self.find_ec_volume(vid)
            if ev is None:
                base = self._ec_base(vid, collection)
                ev = EcVolume(base, vid, codec_name=self.codec_name)
                ev.collection = collection
                if self.ec_fetcher_factory is not None:
                    ev.remote_fetch = self.ec_fetcher_factory(vid)
                if self.scrubber is not None:
                    ev.corruption_hook = self.scrubber.suspect_shard
                # keep only the requested shards mounted
                for sid in list(ev.shards):
                    if sid not in shard_ids:
                        ev.delete_shard(sid)
                self._location_for_base(base).ec_volumes[vid] = ev
            else:
                for sid in shard_ids:
                    ev.add_shard(sid)
            if self.scrubber is not None:
                # a (re)mounted shard's bytes are fresh (repair rebuilds
                # land here): stale findings must not re-deliver
                self.scrubber.forget_shards(vid, shard_ids)
            try:
                shard_size = ev.shard_size
            except (OSError, IOError):
                shard_size = 0
            self.new_ec_shards.append(
                VolumeEcShardInformationMessage(
                    id=vid,
                    collection=collection,
                    ec_index_bits=int(_bits(shard_ids)),
                    shard_size=shard_size,
                )
            )

    def _location_for_base(self, base: str) -> DiskLocation:
        d = os.path.dirname(base)
        for loc in self.locations:
            if loc.directory == d:
                return loc
        return self.locations[0]

    def unmount_ec_shards(self, vid: int, shard_ids: list[int]) -> None:
        with self._lock:
            ev = self.find_ec_volume(vid)
            if ev is None:
                return
            for sid in shard_ids:
                ev.delete_shard(sid)
            self.deleted_ec_shards.append(
                VolumeEcShardInformationMessage(
                    id=vid,
                    collection=getattr(ev, "collection", ""),
                    ec_index_bits=int(_bits(shard_ids)),
                )
            )
            if not ev.shards:
                for loc in self.locations:
                    if loc.ec_volumes.get(vid) is ev:
                        del loc.ec_volumes[vid]
                ev.close()
                if self.needle_cache is not None:
                    self.needle_cache.drop_volume(vid)

    def delete_ec_shards(self, vid: int, collection: str,
                         shard_ids: list[int]) -> None:
        with self._lock:
            self.unmount_ec_shards(vid, shard_ids)
            try:
                base = self._ec_base(vid, collection)
            except KeyError:
                return
            for sid in shard_ids:
                try:
                    os.remove(base + ecc.to_ext(sid))
                except FileNotFoundError:
                    pass
            # if no shards remain on disk, remove the index files too
            if not any(
                os.path.exists(base + ecc.to_ext(i))
                for i in range(ecc.TOTAL_SHARDS)
            ):
                for ext in (".ecx", ".ecj"):
                    try:
                        os.remove(base + ext)
                    except FileNotFoundError:
                        pass

    def ec_shards_to_volume(self, vid: int, collection: str) -> None:
        """Convert a complete local EC volume back to a normal volume."""
        base = self._ec_base(vid, collection)
        dat_size = find_dat_file_size(base, base)
        write_dat_file(base, dat_size)
        write_idx_file_from_ec_index(base)
        ev = self.find_ec_volume(vid)
        if ev is not None:
            self.unmount_ec_shards(vid, list(ev.shards))
        self.mount_volume(vid)

    # -- status -----------------------------------------------------------

    def status(self) -> dict:
        return {
            "volumes": sorted(
                vid for loc in self.locations for vid in loc.volumes
            ),
            "ec_volumes": {
                vid: ev.shard_ids()
                for loc in self.locations
                for vid, ev in loc.ec_volumes.items()
            },
        }

    def close(self) -> None:
        for loc in self.locations:
            for v in loc.volumes.values():
                v.close()
            for ev in loc.ec_volumes.values():
                ev.close()


def _bits(shard_ids) -> ShardBits:
    b = ShardBits(0)
    for sid in shard_ids:
        b = b.add(sid)
    return b
