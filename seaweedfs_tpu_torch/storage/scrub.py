"""Self-healing integrity plane, volume-server side: the scrub daemon —
the port's copy of seaweedfs_tpu/storage/scrub.py.

Proactive silent-corruption detection for sealed data.  A background
thread walks

  * every volume's needles — each record is re-read from the .dat and its
    CRC verified against the index entry (the load-time torn-tail check
    in volume.py only inspects the LAST record; scrub covers the body),
  * every EC volume's shards — RS(10,4) parity is recomputed over sampled
    intervals on the store's codec (through the shared codec service, one
    batched kernel launch on the card per interval, when the codec is a
    device codec and a card is reachable) and compared byte-for-byte
    against the stored parity shards, with a consistency probe that
    localizes WHICH shard is rotten,
  * each volume's on-disk .idx — and when the index itself fails
    verification, the scrubber's last resort is the offline idx rebuild
    (`tools/offline.fix_index`, the `weed fix` equivalent) + reload.

Everything runs under a token-bucket bytes/s throttle
(SEAWEEDFS_TPU_SCRUB_RATE_MBPS) that additionally backs off while the
executor queue-depth gauges show the serving pools saturated —
arXiv:1709.05365's lesson that background EC I/O must be rate-governed
or it starves foreground reads.  Per-volume cursors persist to a JSON
file in each disk location so a restart resumes instead of rescanning.

Findings are quarantined (bounded per-volume suspect sets the read path
also feeds) and ride the next heartbeat to the master, whose maintenance
repair pass re-copies corrupt replicas / rebuilds corrupt shards.

Not ported yet: the master-pushed cluster background budget
(`set_shared_rate`, `throttle_background`), which arrives with the volume
server's heartbeat.

One difference from the reference, on purpose: its parity check runs on
the host SIMD codec whenever `service_for_codec` answers None, which
includes a device store on a host without a card.  Here the parity runs
on `get_codec(store.codec_name)` then, so a `cuda` store verifies with
the direct kernel or raises.  The localization of a rotten shard keeps
the reference's host `cpu` codec for its decode plans (one plan per
candidate shard), as the reference chose.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time

import numpy as np

from ..ops import codec_service, gf256
from ..ops.codec import get_codec
from ..stats.metrics import (
    EXECUTOR_QUEUE_DEPTH,
    SCRUB_BYTES,
    SCRUB_ERRORS,
    SCRUB_NEEDLES,
    SCRUB_REPAIRS,
)
from ..util import faultpoint, glog
from . import types as t
from .ec.constants import DATA_SHARDS, TOTAL_SHARDS
from .idx import walk_index_file
from .needle import CorruptNeedleError, Needle, actual_size

# chaos points: `scrub.read` fires before every scrubber disk read,
# `scrub.verify` passes the just-read bytes through (so `partial` mode
# models a torn read reaching the verifier)
FP_SCRUB_READ = faultpoint.register("scrub.read")
FP_SCRUB_VERIFY = faultpoint.register("scrub.verify")

RATE_ENV = "SEAWEEDFS_TPU_SCRUB_RATE_MBPS"
INTERVAL_ENV = "SEAWEEDFS_TPU_SCRUB_INTERVAL_S"
EC_INTERVAL_ENV = "SEAWEEDFS_TPU_SCRUB_EC_INTERVAL_KB"
BACKOFF_DEPTH_ENV = "SEAWEEDFS_TPU_SCRUB_BACKOFF_QUEUE_DEPTH"

CURSOR_FILE = "scrub.cursor.json"


class TokenBucket:
    """Bytes/s throttle: consume() blocks until the bucket covers `n`.

    Capacity is one second of rate, so a cold start can burst at most
    1s worth — the measured rate over any window >= a few seconds stays
    within ~2x of the configured rate (the acceptance bound).  A single
    read LARGER than the capacity is granted once the bucket is full and
    charged as debt (tokens go negative), so later reads pay it back —
    the bucket never deadlocks on an oversized needle.
    """

    def __init__(self, rate_bytes_s: float):
        self._lock = threading.Lock()
        self._rate = max(float(rate_bytes_s), 1.0)
        self._tokens = self._rate  # full bucket: first read never stalls
        self._last = time.monotonic()

    def set_rate(self, rate_bytes_s: float) -> None:
        with self._lock:
            self._rate = max(float(rate_bytes_s), 1.0)
            self._tokens = min(self._tokens, self._rate)

    @property
    def rate(self) -> float:
        return self._rate

    def consume(self, n: int, stop: "threading.Event | None" = None) -> float:
        """Block until `n` bytes of budget exist; returns seconds waited."""
        waited = 0.0
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    self._rate, self._tokens + (now - self._last) * self._rate
                )
                self._last = now
                if self._tokens >= n or (
                    n > self._rate and self._tokens >= self._rate
                ):
                    # oversized n: grant at full bucket, go into debt
                    self._tokens -= n
                    return waited
                need = (min(n, self._rate) - self._tokens) / self._rate
            step = min(max(need, 0.01), 0.2)
            if stop is not None and stop.wait(step):
                return waited
            if stop is None:
                time.sleep(step)
            waited += step


class Quarantine:
    """Bounded per-volume suspect sets fed by the read path and the
    scrubber.  A suspect entry means "a CRC failed here at least once";
    the scrubber confirms (-> finding -> repair) or clears (transient)."""

    MAX_PER_VOLUME = 1024

    def __init__(self):
        self._lock = threading.Lock()
        self._needles: dict[int, set[int]] = {}
        self._shards: dict[int, set[int]] = {}

    def _mark(self, table: dict, vid: int, member: int) -> bool:
        with self._lock:
            s = table.setdefault(vid, set())
            if member in s:
                return False
            if len(s) >= self.MAX_PER_VOLUME:
                return False  # bounded: beyond this the volume itself is toast
            s.add(member)
            return True

    def mark_needle(self, vid: int, needle_id: int) -> bool:
        return self._mark(self._needles, vid, needle_id)

    def mark_shard(self, vid: int, shard_id: int) -> bool:
        return self._mark(self._shards, vid, shard_id)

    def clear_needle(self, vid: int, needle_id: int) -> None:
        with self._lock:
            self._needles.get(vid, set()).discard(needle_id)

    def clear_shard(self, vid: int, shard_id: int) -> None:
        with self._lock:
            self._shards.get(vid, set()).discard(shard_id)

    def drop_volume(self, vid: int) -> None:
        with self._lock:
            self._needles.pop(vid, None)
            self._shards.pop(vid, None)

    def is_needle_suspect(self, vid: int, needle_id: int) -> bool:
        with self._lock:
            return needle_id in self._needles.get(vid, ())

    def status(self) -> dict:
        with self._lock:
            return {
                "needles": {str(v): sorted(s) for v, s in
                            self._needles.items() if s},
                "shards": {str(v): sorted(s) for v, s in
                           self._shards.items() if s},
            }


def _saturation() -> float:
    """Max queue depth across every metered SERVING pool — the
    saturation signal background work backs off on.  The lifecycle
    controller's own worker pool is excluded: its queued background
    jobs are not foreground pressure, and counting them would let a
    deep lifecycle backlog stall the very workers draining it."""
    with EXECUTOR_QUEUE_DEPTH._lock:
        items = list(EXECUTOR_QUEUE_DEPTH._children.items())
    return max((c.value for k, c in items if k[0] != "lifecycle"),
               default=0.0)


class Scrubber:
    """Per-store scrub daemon + on-demand scan entry points."""

    def __init__(self, store, rate_mbps: float | None = None,
                 interval_s: float | None = None):
        self.store = store
        if rate_mbps is None:
            rate_mbps = float(os.environ.get(RATE_ENV, "4"))
        if interval_s is None:
            interval_s = float(os.environ.get(INTERVAL_ENV, "300"))
        self.rate_mbps = rate_mbps
        self.interval_s = interval_s
        self.ec_interval = max(
            int(float(os.environ.get(EC_INTERVAL_ENV, "256"))) << 10, 4096)
        self.backoff_depth = float(os.environ.get(BACKOFF_DEPTH_ENV, "8"))
        # rate<=0 disables the DAEMON only; on-demand scans then run
        # unthrottled (a 1-byte/s floor would wedge them instead)
        self._default_rate = (rate_mbps * (1 << 20) if rate_mbps > 0
                              else float(1 << 40))
        self.bucket = TokenBucket(self._default_rate)
        self.quarantine = Quarantine()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # outstanding confirmed findings, keyed (vid, kind, shard,
        # needle): re-delivered on EVERY full heartbeat until the target
        # verifies healthy (or the volume/shard is remounted by a
        # repair) — a beat that dies mid-send loses nothing
        self._outstanding: dict[tuple, dict] = {}
        self._recent: list[dict] = []     # kept for status / the scrub rpc
        self._confirm_q: list[dict] = []  # read-path suspicions to verify
        self._cursors: dict[str, dict] = {}  # directory -> {"volume": {...}}
        self._counts = {
            "passes": 0, "scanned_needles": 0, "scanned_bytes": 0,
            "corrupt_needles": 0, "corrupt_shards": 0, "index_repairs": 0,
            "backoff_seconds": 0.0, "confirms": 0,
        }
        self._last_pass_started = 0.0
        self._last_pass_seconds = 0.0
        # the store's own codec, built at the first parity check that
        # runs without the shared service
        self._parity_codec = None
        self._load_cursors()

    # -- lifecycle --------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.rate_mbps > 0

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="scrub-daemon", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._save_cursors()

    def _loop(self) -> None:
        next_pass = time.monotonic() + self.interval_s
        while not self._stop.is_set():
            self._wake.wait(timeout=1.0)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self._confirm_pending()
                if time.monotonic() >= next_pass:
                    self.scrub_once()
                    next_pass = time.monotonic() + self.interval_s
            except Exception as e:  # the daemon must survive, not go mute
                glog.warning("scrub pass failed: %s", e)
                next_pass = time.monotonic() + self.interval_s

    # -- cursors ----------------------------------------------------------

    def _cursor_path(self, directory: str) -> str:
        return os.path.join(directory, CURSOR_FILE)

    def _load_cursors(self) -> None:
        for loc in self.store.locations:
            try:
                with open(self._cursor_path(loc.directory)) as f:
                    self._cursors[loc.directory] = json.load(f)
            except (OSError, ValueError):
                self._cursors[loc.directory] = {"volume": {}, "ec": {}}

    def _save_cursors(self) -> None:
        for loc in self.store.locations:
            cur = self._cursors.get(loc.directory)
            if cur is None:
                continue
            path = self._cursor_path(loc.directory)
            try:
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(cur, f)
                os.replace(tmp, path)
            except OSError as e:
                glog.warning("scrub cursor save failed for %s: %s",
                             loc.directory, e)

    def _cursor(self, directory: str, kind: str, vid: int) -> int:
        return int(self._cursors.get(directory, {}).get(kind, {})
                   .get(str(vid), 0))

    def _set_cursor(self, directory: str, kind: str, vid: int,
                    value: int) -> None:
        self._cursors.setdefault(
            directory, {"volume": {}, "ec": {}}
        ).setdefault(kind, {})[str(vid)] = int(value)

    # -- findings ---------------------------------------------------------

    MAX_OUTSTANDING = 4096

    def _report(self, vid: int, kind: str, shard_id: int = 0,
                needle_id: int = 0, detail: str = "") -> None:
        key = (vid, kind, shard_id, needle_id)
        with self._lock:
            if key in self._outstanding:
                return
            # bounded: one repair clears a whole volume's entries; a
            # flood beyond this is one rotten disk, not 4096 findings
            if len(self._outstanding) >= self.MAX_OUTSTANDING:
                return
            finding = {
                "volume_id": vid, "kind": kind, "shard_id": shard_id,
                "needle_id": needle_id, "detail": detail,
                "detected_at_ms": int(time.time() * 1000),
            }
            self._outstanding[key] = finding
            self._recent.append(finding)
            del self._recent[:-256]
        glog.warning("scrub finding: vol=%d kind=%s shard=%d needle=%x %s",
                     vid, kind, shard_id, needle_id, detail)

    def report_corruption(self, vid: int, kind: str = "replica",
                          shard_id: int = 0, needle_id: int = 0,
                          detail: str = "") -> None:
        """Public entry for other detectors (vacuum) whose finding can no
        longer be re-verified in place (e.g. the rotten needle was
        dropped from the compacted index): goes straight to the master
        for a whole-volume repair."""
        self._report(vid, kind, shard_id=shard_id, needle_id=needle_id,
                     detail=detail)

    def _clear_reported(self, vid: int, kind: str, shard_id: int = 0,
                        needle_id: int = 0) -> None:
        """A previously-reported target verified healthy (post-repair):
        stop re-delivering it and lift the quarantine."""
        with self._lock:
            self._outstanding.pop((vid, kind, shard_id, needle_id), None)
        if kind == "replica":
            self.quarantine.clear_needle(vid, needle_id)
        elif kind == "ec_shard":
            self.quarantine.clear_shard(vid, shard_id)

    def _absolve_needle(self, vid: int, key: int) -> None:
        """A needle verified healthy on a regular pass: if it was ever
        reported/quarantined (pre-repair), clear that state so a LATER
        re-corruption of the same needle is reported again."""
        with self._lock:
            if (vid, "replica", 0, key) not in self._outstanding:
                if not self.quarantine.is_needle_suspect(vid, key):
                    return
            self._outstanding.pop((vid, "replica", 0, key), None)
        self.quarantine.clear_needle(vid, key)

    def forget_volume(self, vid: int) -> None:
        """A repair (or any remount) replaced the volume's bytes: clear
        its quarantine and stop re-delivering its findings — if rot
        survives, the next pass re-detects and re-reports."""
        with self._lock:
            for k in [k for k in self._outstanding if k[0] == vid]:
                del self._outstanding[k]
        self.quarantine.drop_volume(vid)

    def forget_shards(self, vid: int, shard_ids) -> None:
        """EC shards were (re)mounted — same contract as forget_volume."""
        sids = set(shard_ids)
        with self._lock:
            for k in [k for k in self._outstanding
                      if k[0] == vid and k[1] == "ec_shard" and k[2] in sids]:
                del self._outstanding[k]
        for sid in sids:
            self.quarantine.clear_shard(vid, sid)

    def outstanding_findings(self, limit: int = 256) -> list[dict]:
        """Confirmed findings for the next heartbeat.  NOT drained:
        every full beat re-delivers until the target heals (at-least-
        once; the master keys findings idempotently), so a stream that
        dies mid-send loses nothing."""
        with self._lock:
            return [dict(f) for f in
                    list(self._outstanding.values())[:limit]]

    def recent_findings(self, vid: int | None = None) -> list[dict]:
        with self._lock:
            return [f for f in self._recent
                    if vid is None or f["volume_id"] == vid]

    # -- read-path feed ---------------------------------------------------

    def suspect_needle(self, vid: int, needle_id: int) -> None:
        """Read path saw a CRC failure: quarantine + queue for confirm."""
        if self.quarantine.mark_needle(vid, needle_id):
            SCRUB_ERRORS.labels("read_path").inc()
        with self._lock:
            self._confirm_q.append({"vid": vid, "needle_id": needle_id})
            del self._confirm_q[:-1024]
        self._wake.set()

    def suspect_shard(self, vid: int, shard_id: int) -> None:
        if self.quarantine.mark_shard(vid, shard_id):
            SCRUB_ERRORS.labels("read_path").inc()
        with self._lock:
            self._confirm_q.append({"vid": vid, "shard_id": shard_id})
            del self._confirm_q[:-1024]
        self._wake.set()

    def _confirm_pending(self) -> None:
        with self._lock:
            pending, self._confirm_q = self._confirm_q, []
        # dedupe: a degraded-read storm enqueues the same target many
        # times; one verification answers them all
        seen: set[tuple] = set()
        deduped = []
        for item in pending:
            key = (item["vid"], item.get("needle_id"), item.get("shard_id"))
            if key in seen:
                continue
            seen.add(key)
            deduped.append(item)
        for item in deduped:
            vid = item["vid"]
            self._counts["confirms"] += 1
            if "needle_id" in item:
                v = self.store.find_volume(vid)
                if v is None:
                    continue
                nv = v.needle_map.get(item["needle_id"])
                if nv is None or t.size_is_deleted(nv.size):
                    self.quarantine.clear_needle(vid, item["needle_id"])
                    continue
                self._verify_volume_needle(v, nv)
            else:
                ev = self.store.find_ec_volume(vid)
                if ev is not None and item.get("shard_id") in ev.shards:
                    # a targeted parity sweep of the suspect shard's file
                    self._scrub_ec_volume(ev, loc_dir=None,
                                          only_shard=item["shard_id"])

    # -- scan entry points ------------------------------------------------

    def scrub_once(self, rate_mbps: float | None = None) -> dict:
        """One full pass over every volume and EC volume, resuming from
        the persisted cursors.  Returns a summary dict."""
        if rate_mbps:
            self.bucket.set_rate(rate_mbps * (1 << 20))
        started = time.monotonic()
        self._last_pass_started = time.time()
        summary = {"volumes": 0, "ec_volumes": 0, "corrupt_needles": 0,
                   "corrupt_shards": 0, "scanned_bytes": 0,
                   "index_repairs": 0}
        for loc in self.store.locations:
            for vid in sorted(loc.volumes):
                v = loc.volumes.get(vid)
                if v is None or v.is_remote:
                    continue
                r = self._scrub_volume(v, loc.directory)
                summary["volumes"] += 1
                summary["corrupt_needles"] += r["corrupt_needles"]
                summary["scanned_bytes"] += r["bytes"]
                summary["index_repairs"] += r["index_repairs"]
                if self._stop.is_set():
                    break
            for vid in sorted(loc.ec_volumes):
                ev = loc.ec_volumes.get(vid)
                if ev is None:
                    continue
                r = self._scrub_ec_volume(ev, loc.directory)
                summary["ec_volumes"] += 1
                summary["corrupt_shards"] += r["corrupt_shards"]
                summary["scanned_bytes"] += r["bytes"]
                if self._stop.is_set():
                    break
        self._counts["passes"] += 1
        self._last_pass_seconds = time.monotonic() - started
        summary["seconds"] = self._last_pass_seconds
        if rate_mbps:
            self.bucket.set_rate(self._default_rate)
        self._save_cursors()
        return summary

    def scrub_volume(self, vid: int, rate_mbps: float | None = None) -> dict:
        """On-demand scan of one volume (the `volume.scrub` rpc)."""
        if rate_mbps:
            self.bucket.set_rate(rate_mbps * (1 << 20))
        try:
            v = self.store.find_volume(vid)
            if v is not None:
                loc = self.store._location_of(vid)
                # on-demand = full scan: reset the cursor first
                d = loc.directory if loc else self.store.locations[0].directory
                self._set_cursor(d, "volume", vid, 0)
                return self._scrub_volume(v, d)
            ev = self.store.find_ec_volume(vid)
            if ev is not None:
                loc = self.store._location_of(vid)
                d = loc.directory if loc else self.store.locations[0].directory
                self._set_cursor(d, "ec", vid, 0)
                return self._scrub_ec_volume(ev, d)
            raise KeyError(f"volume {vid} not found")
        finally:
            if rate_mbps:
                self.bucket.set_rate(self._default_rate)

    # -- throttle ---------------------------------------------------------

    def _throttle(self, n: int) -> None:
        # back off while the serving pools are saturated: scrub I/O must
        # never starve foreground reads (the executors' queue-depth
        # gauges are the signal)
        while (_saturation() >= self.backoff_depth
               and not self._stop.is_set()):
            self._counts["backoff_seconds"] += 0.2
            if self._stop.wait(0.2):
                return
        self._counts["backoff_seconds"] += self.bucket.consume(
            n, stop=self._stop)

    # -- volume scan ------------------------------------------------------

    def _scrub_volume(self, v, loc_dir: str | None) -> dict:
        vid = v.volume_id
        result = {"corrupt_needles": 0, "bytes": 0, "scanned": 0,
                  "index_repairs": 0}
        with v._lock:
            entries = sorted(
                v.needle_map.items_ascending(), key=lambda nv: nv.offset)
            dat = v._dat
            version = v.version
            file_size = dat.file_size()
        cursor = self._cursor(loc_dir, "volume", vid) if loc_dir else 0
        index_suspect = 0
        for nv in entries:
            if self._stop.is_set():
                break
            if nv.offset < cursor or t.size_is_deleted(nv.size):
                continue
            rec_len = actual_size(nv.size, version)
            if nv.offset + rec_len > file_size:
                # an entry past EOF survived the load-time tail fix:
                # the index itself is suspect
                index_suspect += 1
                continue
            self._throttle(rec_len)
            ok = self._verify_volume_needle(v, nv)
            result["scanned"] += 1
            result["bytes"] += rec_len
            if ok is False:
                result["corrupt_needles"] += 1
            elif ok is None:
                index_suspect += 1
            if loc_dir:
                self._set_cursor(loc_dir, "volume", vid, nv.offset + rec_len)
        else:
            # full pass completed: wrap the cursor and check the on-disk
            # index against the in-memory map (tombstone rewrites and the
            # append log must agree; disagreement = index rot)
            if loc_dir:
                self._set_cursor(loc_dir, "volume", vid, 0)
            if not self._verify_index(v):
                index_suspect += 1
        if index_suspect:
            SCRUB_ERRORS.labels("index").inc(index_suspect)
            if self._repair_index(v):
                result["index_repairs"] += 1
                self._counts["index_repairs"] += 1
            else:
                self._report(vid, "index",
                             detail=f"{index_suspect} bad index entries")
        else:
            self._clear_reported(vid, "index")
        self._counts["scanned_needles"] += result["scanned"]
        self._counts["scanned_bytes"] += result["bytes"]
        self._counts["corrupt_needles"] += result["corrupt_needles"]
        SCRUB_BYTES.labels("volume").inc(result["bytes"])
        return result

    def _verify_volume_needle(self, v, nv):
        """-> True healthy / False corrupt (reported) / None index-suspect.

        Same lock discipline as Volume.read_needle: lock-free pread off a
        snapshotted handle, any inconsistency re-checked under the lock
        (where a racing vacuum/tier swap resolves) before it counts as
        corruption."""
        vid = v.volume_id
        key = nv.key if hasattr(nv, "key") else nv.id
        with v._lock:
            cur = v.needle_map.get(key)
            if cur is None or cur.offset != nv.offset or cur.size != nv.size:
                return True  # raced a delete/vacuum: nothing to verify
            dat = v._dat
            version = v.version
        try:
            faultpoint.inject(FP_SCRUB_READ, ctx=f"{vid}")
            blob = dat.pread(nv.offset, actual_size(nv.size, version))
            blob = faultpoint.inject(FP_SCRUB_VERIFY, ctx=f"{vid}", data=blob)
            n = Needle.from_bytes(blob, version)
            if n.id != key:
                return self._recheck_volume_needle(v, nv, key)
            if n.size != nv.size:
                return self._recheck_volume_needle(v, nv, key)
        except CorruptNeedleError:
            return self._recheck_volume_needle(v, nv, key)
        except (OSError, ValueError, struct.error, IndexError):
            # handle swap / short read / garbled header: recheck under lock
            return self._recheck_volume_needle(v, nv, key)
        SCRUB_NEEDLES.labels("volume", "ok").inc()
        # healthy (regular pass or confirm): lift any stale report /
        # quarantine left from before a repair
        self._absolve_needle(vid, key)
        return True

    def _recheck_volume_needle(self, v, nv, key):
        """Authoritative verification under the volume lock."""
        vid = v.volume_id
        with v._lock:
            cur = v.needle_map.get(key)
            if cur is None or cur.offset != nv.offset or cur.size != nv.size:
                return True  # superseded while we looked: not corruption
            try:
                blob = v._dat.read_at(
                    nv.offset, actual_size(nv.size, v.version))
                n = Needle.from_bytes(blob, v.version)
            except CorruptNeedleError:
                SCRUB_NEEDLES.labels("volume", "corrupt").inc()
                SCRUB_ERRORS.labels("needle").inc()
                self.quarantine.mark_needle(vid, key)
                self._report(vid, "replica", needle_id=key,
                             detail="needle CRC mismatch")
                return False
            except (OSError, ValueError, struct.error, IndexError) as e:
                SCRUB_NEEDLES.labels("volume", "corrupt").inc()
                SCRUB_ERRORS.labels("needle").inc()
                self.quarantine.mark_needle(vid, key)
                self._report(vid, "replica", needle_id=key,
                             detail=f"unreadable record: {e}")
                return False
        if n.id != key:
            # valid record, wrong id: the INDEX points at the wrong
            # offset — index rot, not data rot
            return None
        if n.size != nv.size:
            return None
        SCRUB_NEEDLES.labels("volume", "ok").inc()
        self._absolve_needle(vid, key)
        return True

    # -- index verification / last-resort rebuild -------------------------

    def _verify_index(self, v) -> bool:
        """Replay the on-disk .idx and compare its final live map to the
        in-memory needle map — they are written in lockstep, so any
        divergence means the .idx on disk is rotten."""
        idx_path = v.file_name() + ".idx"
        with v._lock:
            try:
                v._idx.flush()
            except (OSError, ValueError):
                return False
            if not os.path.exists(idx_path):
                return True  # nothing persisted yet
            try:
                live: dict[int, tuple[int, int]] = {}
                for key, offset, size in walk_index_file(idx_path):
                    if t.size_is_deleted(size) or offset == 0:
                        live.pop(key, None)
                    else:
                        live[key] = (offset, size)
            except (OSError, ValueError, struct.error):
                return False
            mem = {nv.key: (nv.offset, nv.size)
                   for nv in v.needle_map.items_ascending()
                   if not t.size_is_deleted(nv.size)}
        return live == mem

    def _repair_index(self, v) -> bool:
        """Last resort: rebuild the .idx by scanning the .dat (`weed fix`)
        and reload the volume in place, exactly like a vacuum commit."""
        from ..tools.offline import fix_index

        vid = v.volume_id
        try:
            with v._lock:
                directory, collection = v.directory, v.collection
                v.close()
                n = fix_index(directory, vid, collection)
                v.__init__(directory, collection, vid)
            if self.store.needle_cache is not None:
                self.store.needle_cache.drop_volume(vid)
            SCRUB_REPAIRS.labels("index", "ok").inc()
            glog.warning("scrub: rebuilt index for volume %d (%d entries)",
                         vid, n)
            self._clear_reported(vid, "index")
            return True
        except Exception as e:  # noqa: BLE001 — report, keep scrubbing
            SCRUB_REPAIRS.labels("index", "error").inc()
            glog.error("scrub: index rebuild for volume %d failed: %s",
                       vid, e)
            return False

    # -- EC scan ----------------------------------------------------------

    def _parity_rows(self, data: np.ndarray) -> list[np.ndarray]:
        """Recompute RS parity for one (10, W) interval stack on the
        store's codec: through the shared codec service when the codec
        has one (a batched launch on the card), else on the codec itself —
        a `cuda` store without a card raises here, it does not switch to
        the host."""
        svc = codec_service.service_for_codec(self.store.codec_name)
        if svc is not None:
            return list(svc.submit_parity(data).result())
        if self._parity_codec is None:
            self._parity_codec = get_codec(self.store.codec_name)
        return list(self._parity_codec.parity_of(data))

    def _scrub_ec_volume(self, ev, loc_dir: str | None,
                         only_shard: int | None = None) -> dict:
        vid = ev.volume_id
        result = {"corrupt_shards": 0, "bytes": 0, "scanned": 0}
        # decode plans for localizing a rotten shard; parity runs on the
        # store's codec (_parity_rows)
        codec = get_codec("cpu")
        try:
            shard_size = ev.shard_size
        except (OSError, IOError):
            shard_size = 0
        if not shard_size or not ev.shards:
            return result
        cursor = self._cursor(loc_dir, "ec", vid) if loc_dir else 0
        if cursor >= shard_size:
            cursor = 0
        off = cursor
        while off < shard_size and not self._stop.is_set():
            width = min(self.ec_interval, shard_size - off)
            rows = self._gather_ec_interval(ev, off, width)
            if rows is None:
                SCRUB_NEEDLES.labels("ec", "skipped").inc()
                off += width
                continue
            n_read = sum(1 for r in rows.values() if r is not None)
            self._throttle(n_read * width)
            result["bytes"] += n_read * width
            result["scanned"] += 1
            bad = self._verify_ec_interval(ev, codec, rows, off, width)
            for sid in bad:
                result["corrupt_shards"] += 1
                self._counts["corrupt_shards"] += 1
                SCRUB_NEEDLES.labels("ec", "corrupt").inc()
                SCRUB_ERRORS.labels("shard").inc()
                self.quarantine.mark_shard(vid, sid)
                self._report(vid, "ec_shard", shard_id=sid,
                             detail=f"parity mismatch at {off}+{width}")
            if not bad:
                SCRUB_NEEDLES.labels("ec", "ok").inc()
            off += width
            if loc_dir:
                self._set_cursor(loc_dir, "ec", vid,
                                 0 if off >= shard_size else off)
        if (cursor == 0 and off >= shard_size
                and result["corrupt_shards"] == 0
                and not self._stop.is_set()):
            # a COMPLETE clean pass: lift stale shard reports/quarantine
            # left from before a repair so later re-corruption re-reports
            # (for a targeted confirm, only the suspect shard is cleared)
            targets = ([only_shard] if only_shard is not None
                       else list(ev.shards))
            for sid in targets:
                self._clear_reported(vid, "ec_shard", shard_id=sid)
        self._counts["scanned_bytes"] += result["bytes"]
        SCRUB_BYTES.labels("ec").inc(result["bytes"])
        return result

    def _gather_ec_interval(self, ev, off: int, width: int):
        """-> {shard_id: bytes|None} for all 14 shards (local reads +
        remote fetches), or None when fewer than the 10 data shards are
        reachable (cannot verify parity)."""
        rows: dict[int, bytes | None] = {}
        for sid in range(TOTAL_SHARDS):
            buf = None
            sh = ev.shards.get(sid)
            faultpoint.inject(FP_SCRUB_READ, ctx=f"ec{ev.volume_id}")
            if sh is not None:
                try:
                    buf = sh.read_at(off, width)
                except (OSError, ValueError):
                    buf = None
                if buf is not None and len(buf) != width:
                    buf = None
            if buf is None and ev.remote_fetch is not None:
                try:
                    buf = ev.remote_fetch(sid, off, width)
                except Exception:  # noqa: BLE001 — peer death is routine
                    buf = None
                if buf is not None and len(buf) != width:
                    buf = None
            if buf is not None:
                buf = faultpoint.inject(
                    FP_SCRUB_VERIFY, ctx=f"ec{ev.volume_id}", data=buf)
                if len(buf) != width:
                    buf = None
            rows[sid] = buf
        if sum(1 for sid in range(DATA_SHARDS) if rows[sid] is not None) \
                < DATA_SHARDS:
            return None
        return rows

    def _verify_ec_interval(self, ev, codec, rows: dict, off: int,
                            width: int) -> list[int]:
        """Recompute parity; on mismatch, localize the rotten shard(s) by
        substitution: for each candidate, reconstruct it from the OTHER
        shards and test whether the substituted set is self-consistent.
        Returns the locally-present corrupt shard ids."""
        data = np.stack([
            np.frombuffer(rows[sid], dtype=np.uint8)
            for sid in range(DATA_SHARDS)
        ])
        parity = self._parity_rows(data)
        mismatch = False
        for j, prow in enumerate(parity):
            stored = rows.get(DATA_SHARDS + j)
            if stored is None:
                continue
            if not np.array_equal(
                    np.frombuffer(stored, dtype=np.uint8),
                    np.asarray(prow, dtype=np.uint8)):
                mismatch = True
        if not mismatch:
            return []
        present = sorted(sid for sid, b in rows.items() if b is not None)
        local = set(ev.shards)
        corrupt: list[int] = []
        for cand in present:
            if cand not in local:
                continue  # a peer's shard: its own scrubber will find it
            others = [s for s in present if s != cand]
            if len(others) < DATA_SHARDS:
                continue
            plan = gf256.decode_plan_for(
                np.asarray(codec.matrix), DATA_SHARDS, others, (cand,))
            srcs = [np.frombuffer(rows[s], dtype=np.uint8)
                    for s in others[:DATA_SHARDS]]
            rebuilt = np.asarray(
                codec.apply_rows(plan, srcs)[0], dtype=np.uint8)
            if np.array_equal(
                    rebuilt, np.frombuffer(rows[cand], dtype=np.uint8)):
                continue  # substitution changes nothing: cand consistent
            # test consistency of the set with cand replaced
            subst = dict(rows)
            subst[cand] = rebuilt.tobytes()
            d2 = np.stack([
                np.frombuffer(subst[sid], dtype=np.uint8)
                for sid in range(DATA_SHARDS)])
            p2 = self._parity_rows(d2)
            consistent = True
            for j, prow in enumerate(p2):
                stored = subst.get(DATA_SHARDS + j)
                if stored is None:
                    continue
                if not np.array_equal(
                        np.frombuffer(stored, dtype=np.uint8),
                        np.asarray(prow, dtype=np.uint8)):
                    consistent = False
                    break
            if consistent:
                corrupt.append(cand)
        if not corrupt:
            # could not localize (multiple corruptions / too few shards):
            # report the first locally-present mismatching parity shard so
            # SOMETHING rides the heartbeat rather than silence
            for j in range(len(parity)):
                sid = DATA_SHARDS + j
                if rows.get(sid) is not None and sid in local:
                    corrupt.append(sid)
                    break
        return corrupt

    # -- status -----------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            pending = len(self._confirm_q)
            outstanding = len(self._outstanding)
        return {
            "enabled": self.enabled,
            "running": self._thread is not None and self._thread.is_alive(),
            "rateMBps": self.rate_mbps,
            "intervalSeconds": self.interval_s,
            "ecIntervalBytes": self.ec_interval,
            "backoffQueueDepth": self.backoff_depth,
            "counts": dict(self._counts),
            "lastPassStarted": self._last_pass_started,
            "lastPassSeconds": round(self._last_pass_seconds, 3),
            "pendingConfirms": pending,
            "outstandingFindings": outstanding,
            "quarantine": self.quarantine.status(),
            "cursors": {d: c for d, c in self._cursors.items()},
        }
