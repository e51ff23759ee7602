"""EC volume runtime: open shards + sorted index, needle reads with
on-the-fly reconstruction, deletes via the `.ecj` journal — the port of
seaweedfs_tpu/storage/ec/volume.py.

Reference: ec_volume.go (search/locate), ec_shard.go (shard ReadAt),
ec_volume_delete.go (tombstone + journal), store_ec.go (degraded read).
The remote-shard fetch hook lets a volume server plug in its peers' reads; a
standalone EcVolume reconstructs from whatever local shards exist.

The codec defaults to ``cuda``, as the port's encoder does: a lost or
remote interval is decoded on the card by the hand-written kernel
(ReedSolomonTorch.reconstruct, one launch of the loss set's decode plan at
the interval's width).  ``codec_name="cpu"`` decodes on the host SIMD codec,
and with ``SEAWEEDFS_TPU_EC_SERVICE_DEGRADED=1`` concurrent decodes share
the host-mode codec service, which runs the same ``cpu`` codec.  With a
`partial_client` (storage/ec/partial.py, set by a volume server) an
interval with fewer than DATA_SHARDS local siblings is decoded from one
pre-combined partial per rack, its local term on the host SIMD codec as in
the reference; any failure falls back to the gather above.
"""

from __future__ import annotations

import mmap
import os
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np

from ...ops import codec_service, gf256
from ...ops.codec import get_codec
from ...stats.metrics import (
    EC_PARTIAL_FALLBACK,
    EC_PREADV_BATCHES,
    EC_SINGLEFLIGHT,
)
from ...util.chunk_cache import IntervalCache
from .. import idx as idx_mod
from .. import types as t
from ..needle import CorruptNeedleError, Needle, actual_size
from ..super_block import VERSION3
from .constants import (
    DATA_SHARDS,
    LARGE_BLOCK_SIZE,
    SMALL_BLOCK_SIZE,
    TOTAL_SHARDS,
    to_ext,
)
from .locate import Interval, locate_data, shard_file_size


class NotFoundError(KeyError):
    pass


def _ec_odirect_enabled() -> bool:
    return os.environ.get(
        "SEAWEEDFS_TPU_EC_ODIRECT", "0").strip().lower() in (
        "1", "on", "true", "yes")


_DIRECT_ALIGN = 4096  # sector/page alignment O_DIRECT demands


@dataclass
class EcVolumeShard:
    volume_id: int
    shard_id: int
    path: str

    def __post_init__(self):
        self._f = open(self.path, "rb")
        self.size = os.path.getsize(self.path)
        self._dfd: "int | None" = None  # lazily opened O_DIRECT fd

    def read_at(self, offset: int, length: int) -> bytes:
        # positioned read: concurrent degraded reads share this handle, so
        # a seek+read pair would interleave (reference: ReadAt pread
        # discipline, ec_shard.go:93).  Deliberately NOT an mmap: a shard
        # file truncated by a racing re-copy turns a mapped read into
        # SIGBUS and kills the whole volume server (observed in the r05
        # suite); pread of a truncated/deleted-but-open file just short-
        # reads, which callers already handle.
        return os.pread(self._f.fileno(), length, offset)

    def read_many(self, spans: "list[tuple[int, int]]") -> "list[bytes] | None":
        """Scatter ONE contiguous shard-file range into per-span buffers
        with a single preadv(2) — the batched large-sequential read path.
        ``spans`` are (offset, length) pairs that must tile an ascending
        gap-free range.  Returns None on any error or shortfall so the
        caller falls back to the per-interval path, which already
        degrades local -> remote -> reconstruct."""
        if not spans:
            return []
        start = spans[0][0]
        total = sum(length for _, length in spans)
        if _ec_odirect_enabled():
            data = self._read_direct(start, total)
            if data is not None:
                out: list[bytes] = []
                at = 0
                for _, length in spans:
                    out.append(data[at:at + length])
                    at += length
                return out
        bufs = [bytearray(length) for _, length in spans]
        try:
            got = os.preadv(self._f.fileno(), bufs, start)
        except (OSError, ValueError):
            return None
        if got != total:
            return None
        return [bytes(b) for b in bufs]

    def _direct_fd(self) -> int:
        if self._dfd is None:
            try:
                self._dfd = os.open(self.path, os.O_RDONLY | os.O_DIRECT)
            except (OSError, AttributeError):
                self._dfd = -1  # filesystem refused O_DIRECT: remember
        return self._dfd

    def _read_direct(self, start: int, total: int) -> "bytes | None":
        """O_DIRECT read covering [start, start+total): page-cache bypass
        for large sequential EC scans so they do not evict the hot
        small-needle working set.  The kernel demands aligned fd offset,
        length and buffer address — an anonymous mmap is always
        page-aligned.  None -> caller uses the buffered path."""
        fd = self._direct_fd()
        if fd < 0:
            return None
        lo = start - (start % _DIRECT_ALIGN)
        hi = -(-(start + total) // _DIRECT_ALIGN) * _DIRECT_ALIGN
        try:
            buf = mmap.mmap(-1, hi - lo)
        except (OSError, ValueError):
            return None
        try:
            try:
                got = os.preadv(fd, [buf], lo)
            except OSError:
                return None
            # short read is fine only past EOF padding; the needle bytes
            # themselves must be fully covered
            if got < (start - lo) + total:
                return None
            return bytes(buf[start - lo:start - lo + total])
        finally:
            buf.close()

    def close(self) -> None:
        self._f.close()
        if self._dfd is not None and self._dfd >= 0:
            try:
                os.close(self._dfd)
            except OSError:
                pass
            self._dfd = -1


# fetch_fn(shard_id, offset, length) -> bytes | None  (e.g. a gRPC client)
FetchFn = Callable[[int, int, int], "bytes | None"]

_HOST_CODEC = None


def _host_codec():
    """Shared host SIMD codec for the partial-decode local term — the
    volume's own codec may run on the card, and a per-needle degraded
    read must never pay a device dispatch."""
    global _HOST_CODEC
    if _HOST_CODEC is None:
        _HOST_CODEC = get_codec("cpu")
    return _HOST_CODEC


_SF_LEADER = EC_SINGLEFLIGHT.labels("leader")
_SF_COALESCED = EC_SINGLEFLIGHT.labels("coalesced")

# one bounded process-wide executor for degraded-read remote fetches:
# the old per-call ThreadPoolExecutor paid thread spawn+teardown on
# EVERY reconstructed interval (observed as the top non-I/O cost of a
# degraded-read storm) and put no ceiling on total fetch threads
_FETCH_POOL = None
_FETCH_POOL_LOCK = threading.Lock()


def _fetch_pool():
    global _FETCH_POOL
    if _FETCH_POOL is None:
        with _FETCH_POOL_LOCK:
            if _FETCH_POOL is None:
                from ...util.executors import MeteredThreadPoolExecutor

                workers = int(os.environ.get(
                    "SEAWEEDFS_TPU_EC_FETCH_WORKERS", "16"))
                _FETCH_POOL = MeteredThreadPoolExecutor(
                    max_workers=workers, name="ec_fetch",
                    thread_name_prefix="ec-fetch")
    return _FETCH_POOL


class _SingleFlight:
    """One in-flight gather+decode; followers wait on the event.  The
    leader records the invalidation token its gather was captured under
    so followers can reject a result made stale by a racing
    mount/unmount/delete."""

    __slots__ = ("done", "result", "err", "token")

    def __init__(self):
        self.done = threading.Event()
        self.result: bytes | None = None
        self.err: Exception | None = None
        self.token: "tuple[int, int] | None" = None


class EcVolume:
    """An erasure-coded volume: local shards + .ecx index + .ecj journal."""

    def __init__(
        self,
        base_name: str,
        volume_id: int = 0,
        version: int = VERSION3,
        codec_name: str = "cuda",
        large_block_size: int = LARGE_BLOCK_SIZE,
        small_block_size: int = SMALL_BLOCK_SIZE,
        collection: str = "",
    ):
        self.base_name = base_name
        self.volume_id = volume_id
        self.collection = collection
        self.version = version
        self.codec = get_codec(codec_name)
        self.large_block_size = large_block_size
        self.small_block_size = small_block_size
        self.shards: dict[int, EcVolumeShard] = {}
        self._ecx = open(base_name + ".ecx", "r+b")
        self.ecx_size = os.path.getsize(base_name + ".ecx")
        self._ecx_keys_arr = None  # lazy key cache; False = don't cache
        self._ecj_lock = threading.Lock()
        self._ecx_derived_shard_size: int | None = None
        # bumped on every tombstone: the needle cache's compare-before-put
        # token (EC volumes never append, so deletes are the only writers)
        self.delete_seq = 0
        # bumped on every shard mount/unmount: re-copies swap shard file
        # contents wholesale, so reconstructed intervals captured under an
        # older layout must never be served
        self.mount_seq = 0
        self.remote_fetch: FetchFn | None = None
        # partial-sum repair client (storage.ec.partial): degraded reads
        # pull ONE coefficient-weighted partial per rack from the
        # surviving holders instead of every raw sibling interval; any
        # failure falls back to the remote_fetch gather
        self.partial_client = None
        # corruption_hook(volume_id, shard_id): the read path calls it
        # when a needle CRC failure is traced to a local shard interval
        # (the scrubber's quarantine + confirm queue on a volume server)
        self.corruption_hook: "Callable[[int, int], None] | None" = None
        # single-flight state + reconstructed-interval LRU for degraded
        # reads (0 MB disables the cache; single-flight always on)
        self._sf_lock = threading.Lock()
        self._sf_calls: dict[tuple, _SingleFlight] = {}
        cache_mb = int(os.environ.get(
            "SEAWEEDFS_TPU_EC_INTERVAL_CACHE_MB", "32"))
        self._interval_cache = (
            IntervalCache(cache_mb << 20) if cache_mb > 0 else None
        )
        for sid in range(TOTAL_SHARDS):
            p = base_name + to_ext(sid)
            if os.path.exists(p):
                self.shards[sid] = EcVolumeShard(volume_id, sid, p)

    # -- shard management -------------------------------------------------

    def _invalidate_intervals(self) -> None:
        self.mount_seq += 1
        if self._interval_cache is not None:
            self._interval_cache.clear()

    def add_shard(self, shard_id: int) -> bool:
        if shard_id in self.shards:
            return False
        p = self.base_name + to_ext(shard_id)
        self.shards[shard_id] = EcVolumeShard(self.volume_id, shard_id, p)
        self._invalidate_intervals()
        return True

    def delete_shard(self, shard_id: int) -> None:
        sh = self.shards.pop(shard_id, None)
        if sh:
            sh.close()
            self._invalidate_intervals()

    @property
    def shard_size(self) -> int:
        """Size of every shard file.  Prefer a locally mounted shard; with
        none mounted (all shards remote), use the .dat size recorded in the
        .vif at encode time; last resort, bound it from the .ecx
        (reference: ec_decoder.go FindDatFileSize derives the same bound)."""
        if self.shards:
            return next(iter(self.shards.values())).size
        if self._ecx_derived_shard_size is None:
            self._ecx_derived_shard_size = (
                self._shard_size_from_vif() or self._shard_size_from_ecx()
            )
        return self._ecx_derived_shard_size

    def _shard_size_from_vif(self) -> int | None:
        from ..vif import load_volume_info

        info = load_volume_info(self.base_name + ".vif")
        if info is None or not info.dat_file_size:
            return None
        return shard_file_size(
            info.dat_file_size, self.large_block_size, self.small_block_size
        )

    def _shard_size_from_ecx(self) -> int:
        """One bulk read of the .ecx.  Tombstoned entries lose their size
        field, so they still contribute `offset + 1` — the volume must not
        shrink because its tail needle was deleted (the shard files on the
        other holders keep their full extent)."""
        # chunked pread: one call caps at ~2GiB on Linux and need not
        # return everything it was asked for
        parts, at = [], 0
        while at < self.ecx_size:
            part = os.pread(self._ecx.fileno(),
                            min(self.ecx_size - at, 1 << 30), at)
            if not part:
                break
            parts.append(part)
            at += len(part)
        blob = b"".join(parts)
        end = 0
        for _key, offset, size in idx_mod.walk_index_blob(blob):
            if t.size_is_deleted(size):
                end = max(end, offset + 1)
            else:
                end = max(end, offset + actual_size(size, self.version))
        return shard_file_size(end, self.large_block_size, self.small_block_size)

    def shard_ids(self) -> list[int]:
        return sorted(self.shards)

    def close(self) -> None:
        for sh in self.shards.values():
            sh.close()
        self._ecx.close()

    # -- index search (binary search over the sorted .ecx) ----------------

    def find_needle_from_ecx(self, needle_id: int) -> tuple[int, int]:
        """-> (actual_offset, size); raises NotFoundError."""
        entry = self._search_ecx(needle_id)
        if entry is None:
            raise NotFoundError(f"needle {needle_id:x}")
        _pos, offset, size = entry
        return offset, size

    # entries above this stay on the pread path (keys cache = 8B/needle;
    # 4M entries = 32MB — the low-memory property EC volumes exist for)
    _ECX_KEY_CACHE_MAX = 4 << 20

    def _ecx_keys(self):
        """Contiguous big-endian u64 key column of the .ecx, cached.

        Turns the ~log2(n) pread+unpack binary search into one numpy
        searchsorted + one pread — the .ecx search was ~16% of degraded
        read wall time.  Safe to cache: tombstoning rewrites the SIZE
        field in place, never the keys, and the .ecx never grows."""
        arr = self._ecx_keys_arr
        if arr is not None:
            return arr if arr is not False else None
        n = self.ecx_size // t.NEEDLE_MAP_ENTRY_SIZE
        if n == 0 or n > self._ECX_KEY_CACHE_MAX:
            self._ecx_keys_arr = False
            return None
        try:
            mm = np.memmap(self.base_name + ".ecx", dtype=np.uint8,
                           mode="r")
            esz = t.NEEDLE_MAP_ENTRY_SIZE
            mat = mm[: n * esz].reshape(n, esz)
            keys = np.ascontiguousarray(mat[:, :8]).view(">u8").reshape(-1)
            self._ecx_keys_arr = keys
            del mm
        except (OSError, ValueError):
            self._ecx_keys_arr = False
            return None
        return self._ecx_keys_arr

    def _search_ecx(self, needle_id: int) -> tuple[int, int, int] | None:
        """-> (entry_file_pos, actual_offset, size) | None."""
        fd = self._ecx.fileno()
        keys = self._ecx_keys()
        if keys is not None:
            i = int(np.searchsorted(keys, needle_id))
            if i >= len(keys) or int(keys[i]) != needle_id:
                return None
            pos = i * t.NEEDLE_MAP_ENTRY_SIZE
            # one fresh pread for offset/size: tombstones mutate in place
            _key, offset, size = t.unpack_index_entry(
                os.pread(fd, t.NEEDLE_MAP_ENTRY_SIZE, pos))
            return pos, offset, size
        lo, hi = 0, self.ecx_size // t.NEEDLE_MAP_ENTRY_SIZE
        while lo < hi:
            mid = (lo + hi) // 2
            buf = os.pread(fd, t.NEEDLE_MAP_ENTRY_SIZE,
                           mid * t.NEEDLE_MAP_ENTRY_SIZE)
            key, offset, size = t.unpack_index_entry(buf)
            if key == needle_id:
                return mid * t.NEEDLE_MAP_ENTRY_SIZE, offset, size
            if key < needle_id:
                lo = mid + 1
            else:
                hi = mid
        return None

    # -- delete path ------------------------------------------------------

    def delete_needle(self, needle_id: int) -> None:
        """Tombstone the .ecx entry in place and append to the .ecj journal."""
        entry = self._search_ecx(needle_id)
        if entry is None:
            return
        pos, _offset, _size = entry
        self._ecx.flush()  # don't let buffered state shadow the pwrite
        os.pwrite(self._ecx.fileno(), t.size_to_bytes(t.TOMBSTONE_FILE_SIZE),
                  pos + t.NEEDLE_ID_SIZE + t.OFFSET_SIZE)
        with self._ecj_lock:
            # seq bump under the journal lock: the needle cache's
            # compare-and-put (store.py) holds the same lock, so a put
            # can never be published after the invalidation that follows
            # this delete
            self.delete_seq += 1
            with open(self.base_name + ".ecj", "ab") as j:
                j.write(t.needle_id_to_bytes(needle_id))

    # -- read path --------------------------------------------------------

    def locate(self, needle_id: int) -> tuple[int, int, list[Interval]]:
        offset, size = self.find_needle_from_ecx(needle_id)
        if self.shard_size == 0:
            # dat_size=0 would silently produce wrong intervals for
            # remote/degraded reads — fail fast instead
            raise IOError(
                f"ec volume {self.volume_id}: shard size unknown "
                "(no local shard, empty .ecx) — cannot locate intervals"
            )
        dat_size = DATA_SHARDS * self.shard_size
        intervals = locate_data(
            self.large_block_size,
            self.small_block_size,
            dat_size,
            offset,
            actual_size(size, self.version),
        )
        return offset, size, intervals

    def read_needle(self, needle_id: int) -> Needle:
        offset, size, intervals = self.locate(needle_id)
        if t.size_is_deleted(size):
            raise NotFoundError(f"needle {needle_id:x} deleted")
        parts = self._read_intervals(intervals)
        try:
            n = Needle.from_bytes(b"".join(parts), self.version)
        except CorruptNeedleError:
            # a straight shard read handed back rotten bytes (CRC caught
            # it): re-serve each interval by reconstructing it from the
            # OTHER shards, mark the shard whose bytes disagree suspect,
            # and only fail if even the rebuilt needle is corrupt
            n = self._reread_corrupt(intervals, parts)
        if n.id != needle_id:
            raise NotFoundError(
                f"needle id mismatch: want {needle_id:x} got {n.id:x}"
            )
        return n

    def first_live_needle(self) -> "int | None":
        """First non-tombstoned needle id in the .ecx, or None — the
        canary's probe target (any live needle exercises the same
        locate + interval + decode machinery)."""
        esz = t.NEEDLE_MAP_ENTRY_SIZE
        chunk = (1 << 16) // esz * esz
        at = 0
        while at < self.ecx_size:
            blob = os.pread(self._ecx.fileno(),
                            min(chunk, self.ecx_size - at), at)
            if not blob:
                break
            for key, _offset, size in idx_mod.walk_index_blob(blob):
                if not t.size_is_deleted(size):
                    return key
            at += len(blob) - (len(blob) % esz)
            if len(blob) < esz:
                break
        return None

    def canary_read(self, drop_shard: "int | None" = None) -> dict:
        """Degraded-read canary: read one live needle with the FIRST
        locally held interval forced through the reconstruct path (as if
        its shard were lost), all other intervals read normally.  The
        needle CRC check in `Needle.from_bytes` is the byte-identity
        gate — a decode-path regression fails loudly here before a real
        shard loss finds it.  Bypasses the interval cache/single-flight
        (`_gather_and_decode` directly) so every probe pays a real
        gather + decode."""
        nid = self.first_live_needle()
        if nid is None:
            raise NotFoundError(
                f"ec volume {self.volume_id}: no live needle to probe")
        _offset, size, intervals = self.locate(nid)
        if t.size_is_deleted(size):
            raise NotFoundError(f"needle {nid:x} deleted")
        parts: list[bytes] = []
        dropped = None
        for iv in intervals:
            sid, off = iv.to_shard_id_and_offset(
                self.large_block_size, self.small_block_size)
            droppable = (sid in self.shards
                         and (drop_shard is None or sid == drop_shard))
            if droppable and dropped is None:
                parts.append(
                    self._gather_and_decode(sid, off, iv.size)[0])
                dropped = sid
            else:
                parts.append(self._read_interval(iv))
        n = Needle.from_bytes(b"".join(parts), self.version)
        if n.id != nid:
            raise IOError(
                f"canary read id mismatch: want {nid:x} got {n.id:x}")
        return {"needleId": f"{nid:x}", "droppedShard": dropped,
                "bytes": len(bytes(n.data)),
                "reconstructed": dropped is not None}

    def _reread_corrupt(self, intervals, parts) -> Needle:
        """Corruption failover for EC reads: reconstruct every interval
        from sibling shards instead of trusting the local bytes.  The
        interval whose reconstruction differs from what was read names
        the corrupt shard — reported through corruption_hook so the
        scrubber confirms and the master rebuilds it."""
        fixed: list[bytes] = []
        for iv, got in zip(intervals, parts):
            shard_id, off = iv.to_shard_id_and_offset(
                self.large_block_size, self.small_block_size
            )
            try:
                rec = self._reconstruct_interval(shard_id, off, iv.size)
            except (OSError, IOError):
                fixed.append(got)  # not enough siblings: keep what we read
                continue
            if rec != got:
                hook = self.corruption_hook
                if hook is not None:
                    try:
                        hook(self.volume_id, shard_id)
                    except Exception:  # noqa: BLE001 — never fail the read
                        pass
            fixed.append(rec)
        return Needle.from_bytes(b"".join(fixed), self.version)

    def _read_interval(self, iv: Interval) -> bytes:
        shard_id, off = iv.to_shard_id_and_offset(
            self.large_block_size, self.small_block_size
        )
        return self.read_shard_interval(shard_id, off, iv.size)

    def _read_intervals(self, intervals: "list[Interval]") -> list[bytes]:
        """Interval reads with large-sequential batching.

        The stripe layout puts blocks k and k+DATA_SHARDS adjacent in the
        SAME shard file, so a needle spanning many blocks decomposes into
        one gap-free run per shard.  Each locally-held run of >=2 spans
        collapses into a single preadv(2) scatter
        (seaweedfs_ec_preadv_batches_total) instead of a pread per
        interval; any batch shortfall — racing truncate, unmount, missing
        shard — falls back to the per-interval path, which already
        degrades local -> remote -> reconstruct."""
        located = [
            iv.to_shard_id_and_offset(
                self.large_block_size, self.small_block_size)
            for iv in intervals
        ]
        parts: "list[bytes | None]" = [None] * len(intervals)
        by_shard: dict[int, list[int]] = {}
        for k, (sid, _off) in enumerate(located):
            by_shard.setdefault(sid, []).append(k)
        for sid, idxs in by_shard.items():
            sh = self.shards.get(sid)
            if sh is None or len(idxs) < 2:
                continue
            idxs = sorted(idxs, key=lambda k: located[k][1])
            run = [idxs[0]]
            runs = [run]
            for k in idxs[1:]:
                prev = run[-1]
                if located[k][1] == located[prev][1] + intervals[prev].size:
                    run.append(k)
                else:
                    run = [k]
                    runs.append(run)
            for run in runs:
                if len(run) < 2:
                    continue
                spans = [(located[k][1], intervals[k].size) for k in run]
                got = sh.read_many(spans)
                if got is None:
                    continue  # per-interval fallback below
                EC_PREADV_BATCHES.inc()
                for k, blob in zip(run, got):
                    parts[k] = blob
        for k, iv in enumerate(intervals):
            if parts[k] is None:
                parts[k] = self.read_shard_interval(
                    located[k][0], located[k][1], iv.size)
        return parts

    def read_shard_interval(self, shard_id: int, offset: int, length: int) -> bytes:
        # 1. local shard; a short pread means a racing truncate/re-copy
        # and a closed fd means a racing unmount — both fall through to
        # remote/reconstruct instead of failing the needle read
        sh = self.shards.get(shard_id)
        if sh is not None:
            try:
                buf = sh.read_at(offset, length)
            except (OSError, ValueError):
                buf = b""
            if len(buf) == length:
                return buf
        # 2. remote shard via injected fetcher (same length discipline:
        # a peer mid-copy can short-serve too)
        if self.remote_fetch is not None:
            data = self.remote_fetch(shard_id, offset, length)
            if data is not None and len(data) == length:
                return data
        # 3. degraded: reconstruct from any DATA_SHARDS other shards
        return self._reconstruct_interval(shard_id, offset, length)

    def _cache_token(self) -> tuple[int, int]:
        """Invalidation token for reconstructed intervals: any shard
        mount/unmount or needle delete makes older captures unservable."""
        return (self.mount_seq, self.delete_seq)

    def _reconstruct_interval(self, shard_id: int, offset: int, length: int) -> bytes:
        """Reconstruct one lost interval, coalesced and cached.

        Single-flight: N concurrent readers of the SAME lost interval
        trigger ONE gather+decode; the rest wait on the leader's result
        (seaweedfs_ec_singleflight_total{result}).  Results land in a
        bounded interval LRU keyed by the volume's (mount_seq,
        delete_seq) token — compare-before-publish, so a racing shard
        mount/unmount or delete can never publish a stale interval.
        """
        cache = self._interval_cache
        key = (shard_id, offset, length)
        if cache is not None:
            data = cache.get(key, self._cache_token())
            if data is not None:
                return data
        with self._sf_lock:
            call = self._sf_calls.get(key)
            leader = call is None
            if leader:
                call = _SingleFlight()
                self._sf_calls[key] = call
        if not leader:
            _SF_COALESCED.inc()
            # generous bound: a wedged leader (remote fetch hang) must not
            # strand followers forever — they fall back to their own gather
            if call.done.wait(timeout=60.0):
                if call.err is not None:
                    raise call.err
                # same staleness discipline as the cache: a shard swap or
                # delete since the leader's capture voids the hand-off
                if call.token == self._cache_token():
                    return call.result
            return self._gather_and_decode(shard_id, offset, length)[0]
        _SF_LEADER.inc()
        try:
            data, token = self._gather_and_decode(shard_id, offset, length)
            call.result = data
            call.token = token
            if cache is not None:
                # publish under the journal lock: delete_seq bumps happen
                # under the same lock, so a tombstone that raced the
                # gather either changed the token (no publish) or is
                # ordered after this put and clears via the token check
                with self._ecj_lock:
                    if token == self._cache_token():
                        cache.put(key, data, token)
            return data
        except Exception as e:
            call.err = e
            raise
        finally:
            with self._sf_lock:
                self._sf_calls.pop(key, None)
            call.done.set()

    def _gather_and_decode(
        self, shard_id: int, offset: int, length: int
    ) -> tuple[bytes, tuple[int, int]]:
        """Gather >= DATA_SHARDS sibling intervals and decode the missing
        one; returns (bytes, invalidation token captured BEFORE the reads).

        Local shards are read inline (microseconds); the remote fetches go
        out CONCURRENTLY on the shared bounded executor so worst-case
        degraded latency is ~1 RTT, not 10 sequential RTTs (reference:
        store_ec.go:324-378 fans out one goroutine per source shard and
        joins them) — and a degraded-read storm no longer spawns a fresh
        thread pool per interval.
        """
        token = self._cache_token()
        shards: list[np.ndarray | None] = [None] * TOTAL_SHARDS
        have = 0
        # snapshot in one C-level call: mount/unmount rpcs mutate
        # self.shards from other threads
        local_shards = list(self.shards.items())
        local_shards.sort()
        for sid, sh in local_shards:
            if sid == shard_id or have >= DATA_SHARDS:
                continue
            try:
                buf = sh.read_at(offset, length)
            except (OSError, ValueError):  # racing unmount closed the file
                continue
            if len(buf) == length:
                shards[sid] = np.frombuffer(buf, dtype=np.uint8)
                have += 1
        missing = [
            sid
            for sid in range(TOTAL_SHARDS)
            if sid != shard_id and shards[sid] is None
        ]
        if have < DATA_SHARDS and self.partial_client is not None:
            # partial-sum degraded read: remote survivors send their
            # coefficient-weighted rows pre-XOR'd per rack (one 1 x W
            # partial per rack in) instead of 10 raw intervals
            try:
                return self._partial_decode(
                    shard_id, offset, length, shards), token
            except Exception:  # noqa: BLE001 — optimization, never a 5xx
                EC_PARTIAL_FALLBACK.labels("degraded").inc()
        if have < DATA_SHARDS and self.remote_fetch is not None and missing:
            def fetch(sid: int) -> "bytes | None":
                try:
                    return self.remote_fetch(sid, offset, length)
                except Exception:
                    return None

            futs = [(sid, _fetch_pool().submit(fetch, sid))
                    for sid in missing]
            for sid, fut in futs:
                buf = fut.result()
                if buf is not None and len(buf) == length:
                    shards[sid] = np.frombuffer(buf, dtype=np.uint8)
                    have += 1
        if have < DATA_SHARDS:
            raise IOError(
                f"shard {shard_id} interval unreadable: only {have} shards available"
            )
        svc = codec_service.service_for_degraded()
        if svc is not None:
            # degraded-read storms coalesce: concurrent reconstructions
            # against the same survivor set (same decode-plan row) batch
            # into ONE call of the host SIMD codec on the service
            # scheduler.  Same plan cache, same bytes as reconstruct_one.
            present = [i for i, s in enumerate(shards) if s is not None]
            sub = [np.asarray(shards[i], dtype=np.uint8)
                   for i in present[:DATA_SHARDS]]
            row = gf256.decode_plan_for(
                np.asarray(self.codec.matrix), DATA_SHARDS,
                present, (shard_id,))
            return svc.submit_apply(row, sub).result()[0].tobytes(), token
        if hasattr(self.codec, "reconstruct_one"):
            # latency path: decode only the wanted row, not all lost shards
            return np.asarray(
                self.codec.reconstruct_one(shards, shard_id),
                dtype=np.uint8).tobytes(), token
        # a codec on the card: one launch of the loss set's decode plan
        rebuilt = self.codec.reconstruct(shards)
        return np.asarray(rebuilt[shard_id], dtype=np.uint8).tobytes(), token

    def _partial_decode(
        self, shard_id: int, offset: int, length: int, shards: list
    ) -> bytes:
        """Reconstruct one lost interval via the partial-sum protocol:
        the decode-plan row for `shard_id` splits by source locality —
        local shards' columns are applied here on the host codec (a
        per-needle read must never pay a device dispatch), remote columns
        ship to the holders and return as one pre-XOR'd partial per
        rack.  GF linearity makes the bytes identical to the gathered
        decode; any failure raises and the caller falls back to it."""
        client = self.partial_client
        local_rows = {sid: row for sid, row in enumerate(shards)
                      if row is not None}
        holders = {sid: h for sid, h in client.remote_shards().items()
                   if sid != shard_id and sid not in local_rows}
        need = DATA_SHARDS - len(local_rows)
        order = client.order(holders)
        if len(order) < need:
            raise IOError(
                f"shard {shard_id} interval: only "
                f"{len(local_rows) + len(order)} sources for partial decode")
        remote_srcs = order[:need]
        local_srcs = sorted(local_rows)
        sources = local_srcs + remote_srcs
        plan = gf256.decode_plan_for(
            np.asarray(self.codec.matrix), DATA_SHARDS, sources, (shard_id,))
        coef = {s: plan[:, len(local_srcs) + j]
                for j, s in enumerate(remote_srcs)}
        part = client.fetch(coef, 1, offset, length)
        if local_srcs:
            local_plan = np.ascontiguousarray(plan[:, :len(local_srcs)])
            rows_in = [np.asarray(local_rows[s], dtype=np.uint8)
                       for s in local_srcs]
            svc = codec_service.service_for_degraded()
            if svc is not None:
                out = np.asarray(
                    svc.submit_apply(local_plan, rows_in).result(),
                    dtype=np.uint8)
            else:
                out = np.asarray(
                    _host_codec().apply_rows(local_plan, rows_in),
                    dtype=np.uint8)
            part = np.bitwise_xor(part, out.reshape(part.shape))
        return part[0].tobytes()
