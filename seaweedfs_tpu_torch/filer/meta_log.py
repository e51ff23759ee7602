"""Filer metadata event log: durable sequenced segments + live tailing.

The port's copy of seaweedfs_tpu/filer/meta_log.py.

Reference: weed/filer/filer_notify.go + weed/util/log_buffer — every
mutation appends an EventNotification with a monotonic ts_ns; subscribers
replay events since a timestamp, then tail live.

This implementation adds a DURABLE layer under the in-memory
ring: when constructed with ``dir=``, every appended/ingested event is
framed (crc32 + length + sequence + ts) and written to fsynced segment
files, so

* sequence numbers are monotonic, persisted, and GAP-DETECTABLE — a
  consumer resuming from a checkpoint either gets a contiguous stream or
  a loud ``MetaLogGap`` (never a silent hole);
* history survives restarts and ring eviction: ``subscribe``/``tail``
  serve old events from disk, then hand off to the live ring;
* retention is bounded (``RETAIN_BYTES``): whole
  oldest segments are dropped, advancing ``first_retained_seq``.

The ts_ns stamp doubles as the HYBRID LOGICAL CLOCK the geo plane's
last-writer-wins resolution compares: ``append`` stamps
``max(wall_clock, last+1)`` and ``observe`` advances the clock past any
remote timestamp applied locally, so causality between clusters is never
inverted by wall-clock skew (replication/geo.py).
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from collections import deque

from ..pb import filer_pb2

from ..util import glog

# record framing on disk: crc32(payload) | payload_len | seq | ts_ns
_REC_HEADER = struct.Struct(">IIQq")

_SEG_PREFIX = "seg-"
_SEG_SUFFIX = ".log"

SEGMENT_BYTES = 4 << 20
RETAIN_BYTES = 64 << 20
# fsync per append keeps the durability claim honest against HOST power
# loss (page-cache writes already survive process SIGKILL); the filer
# server turns it off, as the reference does for filers without geo
# replication
FSYNC = True

# a listener that raises this many times IN A ROW is unsubscribed: a
# permanently broken notification sink must not be re-invoked (and
# re-logged) on every metadata mutation forever
LISTENER_MAX_FAILURES = 8


# -- geo (hybrid-logical-clock) stamps -------------------------------------
# every mutation on a geo-enabled filer stamps the entry's extended map
# with (hlc_ns, origin_cluster_id); the apply side compares stamps for
# last-writer-wins.  Deletes leave a tombstone in the store KV so a
# late-arriving older create cannot resurrect a deleted object.

GEO_HLC_KEY = "geo.hlc"
_HLC = struct.Struct(">qI")
TOMBSTONE_PREFIX = b"GeoT"


def encode_hlc(ts_ns: int, cluster_id: int) -> bytes:
    return _HLC.pack(ts_ns, cluster_id)


def decode_hlc(raw: bytes | None) -> tuple[int, int] | None:
    """-> (ts_ns, cluster_id) or None for a missing/malformed stamp."""
    if not raw or len(raw) != _HLC.size:
        return None
    return _HLC.unpack(raw)


def entry_hlc(entry) -> tuple[int, int] | None:
    """The LWW stamp of an entry: its geo stamp when present, else its
    mtime promoted to ns with cluster id 0 (pre-geo entries still order,
    coarsely, against geo writes)."""
    if entry is None:
        return None
    stamp = decode_hlc(bytes(entry.extended.get(GEO_HLC_KEY, b"")))
    if stamp is not None:
        return stamp
    mtime = entry.attributes.mtime or entry.attributes.crtime
    return (mtime * 1_000_000_000, 0) if mtime else None


def tombstone_key(path: str) -> bytes:
    return TOMBSTONE_PREFIX + path.encode()


class MetaLogGap(Exception):
    """The requested resume point predates the oldest retained event —
    the consumer must bootstrap from a namespace snapshot instead."""

    def __init__(self, requested_seq: int, first_retained_seq: int):
        super().__init__(
            f"meta log gap: events after seq {requested_seq} requested, "
            f"but retention starts at seq {first_retained_seq}")
        self.requested_seq = requested_seq
        self.first_retained_seq = first_retained_seq


class _Segment:
    __slots__ = ("path", "first_seq", "size", "max_ts")

    def __init__(self, path: str, first_seq: int, size: int):
        self.path = path
        self.first_seq = first_seq
        self.size = size
        # newest ts_ns in the segment, cached by the first full scan of
        # a SEALED segment (immutable thereafter) so later ts-filtered
        # cold reads skip the whole file without I/O
        self.max_ts: int | None = None


def _seg_path(directory: str, first_seq: int) -> str:
    return os.path.join(directory,
                        f"{_SEG_PREFIX}{first_seq:016x}{_SEG_SUFFIX}")


def _fsync_dir(directory: str) -> None:
    """Make a just-created file's directory entry durable (Linux: fsync
    on the dir fd); best-effort on platforms that refuse dir fds."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _iter_segment(path: str):
    """Yield (seq, ts_ns, payload) from one segment; a torn tail (short
    header/payload, crc mismatch) ends iteration cleanly — later records
    cannot exist past a torn write in an append-only file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(_REC_HEADER.size)
            if len(header) < _REC_HEADER.size:
                return
            crc, length, seq, ts_ns = _REC_HEADER.unpack(header)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return
            yield seq, ts_ns, payload


class MetaLogBuffer:
    def __init__(self, capacity: int = 1 << 16, dir: str | None = None,
                 segment_bytes: int = SEGMENT_BYTES,
                 retain_bytes: int = RETAIN_BYTES,
                 fsync: bool | None = None):
        # (arrival_seq, event): the cursor protocol tracks ARRIVAL order,
        # not ts_ns — an aggregated peer event can arrive late with an
        # older timestamp and must still reach live subscribers exactly
        # once (ts_ns stays the cross-filer resume key in since_ns)
        self._events: deque = deque(maxlen=capacity)
        self._cond = threading.Condition()
        self._last_ts = 0
        self._seq = 0
        self._listeners: list = []
        self._listener_failures: dict = {}  # id(fn) -> consecutive count
        # events before this instant (process start) or evicted from the
        # bounded deque are gone UNLESS the durable layer retains them;
        # subscribers asking for older history than either can serve
        # must bootstrap from a store snapshot instead
        self._created_ts = time.time_ns()
        self._evicted_ts = 0
        # -- durable layer -------------------------------------------------
        self._dir = dir
        self._segment_bytes = segment_bytes
        self._retain_bytes = retain_bytes
        self._fsync = FSYNC if fsync is None else fsync
        self._segments: list[_Segment] = []
        self._fh = None  # open handle on the newest segment
        self.first_retained_seq = 1  # seq of the oldest durable record
        # incarnation id: checkpoints taken against one log must never
        # be interpreted against another (a wiped/repointed dir restarts
        # seq at 1 — a consumer resuming by bare seq would silently skip
        # the new incarnation's first N events once last_seq catches up)
        self.log_id = f"mem-{os.urandom(8).hex()}"
        if dir:
            os.makedirs(dir, exist_ok=True)
            id_path = os.path.join(dir, "log.id")
            try:
                with open(id_path, encoding="ascii") as f:
                    self.log_id = f.read().strip()
            except FileNotFoundError:
                self.log_id = os.urandom(8).hex()
                with open(id_path, "w", encoding="ascii") as f:
                    f.write(self.log_id)
                    f.flush()
                    os.fsync(f.fileno())
                _fsync_dir(dir)
            self._recover()

    # -- durable layer -----------------------------------------------------

    def _recover(self) -> None:
        """Rebuild segment metadata, resume seq/ts, truncate a torn tail."""
        names = sorted(n for n in os.listdir(self._dir)
                       if n.startswith(_SEG_PREFIX)
                       and n.endswith(_SEG_SUFFIX))
        for name in names:
            path = os.path.join(self._dir, name)
            first_seq = int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)], 16)
            self._segments.append(
                _Segment(path, first_seq, os.path.getsize(path)))
        if not self._segments:
            return
        self.first_retained_seq = self._segments[0].first_seq
        # walk the LAST segment to find the true end (and the torn tail)
        last = self._segments[-1]
        good_end = 0
        for seq, ts_ns, payload in _iter_segment(last.path):
            self._seq = seq
            self._last_ts = max(self._last_ts, ts_ns)
            good_end += _REC_HEADER.size + len(payload)
        # the clock must resume past the max ts EVER issued, which is
        # not necessarily in the newest segment: aggregator-ingested
        # peer events with OLDER stamps can fill whole segments after a
        # local append with a newer one, and a regressed clock issues
        # stamps that lose LWW remotely to the very entries they
        # overwrote locally.  Retention bounds this walk; the per-seg
        # max doubles as the sealed segments' ts-skip cache, so fresh
        # near-head subscribers don't re-read the whole retained log
        for seg in self._segments[:-1]:
            seg_max = 0
            for _seq, ts_ns, _payload in _iter_segment(seg.path):
                seg_max = max(seg_max, ts_ns)
            if seg_max:
                seg.max_ts = seg_max
            self._last_ts = max(self._last_ts, seg_max)
        if good_end < last.size:
            glog.warning("meta log: truncating torn tail of %s "
                         "(%d -> %d bytes)", last.path, last.size, good_end)
            with open(last.path, "r+b") as f:
                f.truncate(good_end)
            last.size = good_end
        if self._seq == 0:
            # newest segment entirely torn (or empty): its name carries
            # the first seq it would have held
            self._seq = last.first_seq - 1
        if self._seq:
            glog.info("meta log: recovered %d segment(s), seq=%d",
                      len(self._segments), self._seq)

    def _persist_locked(self, seq: int, resp) -> None:
        if not self._dir:
            return
        payload = resp.SerializeToString()
        if self._fh is None or (
                self._segments
                and self._segments[-1].size >= self._segment_bytes):
            self._roll_locked(seq)
        rec = _REC_HEADER.pack(zlib.crc32(payload), len(payload), seq,
                               resp.ts_ns) + payload
        self._fh.write(rec)
        self._fh.flush()
        if self._fsync:
            os.fsync(self._fh.fileno())
        self._segments[-1].size += len(rec)

    def _roll_locked(self, first_seq: int) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        path = _seg_path(self._dir, first_seq)
        self._fh = open(path, "ab")
        if self._fsync:
            # the DIRECTORY entry must be durable too: per-record fsync
            # is useless if power loss drops the whole segment file —
            # recovery would then reissue seqs under the SAME log id and
            # remote (src, log, seq) watermarks would swallow the fresh
            # post-restart events as duplicates
            _fsync_dir(self._dir)
        if not self._segments or self._segments[-1].path != path:
            self._segments.append(
                _Segment(path, first_seq, os.path.getsize(path)))
        self._enforce_retention_locked()

    def _enforce_retention_locked(self) -> None:
        total = sum(s.size for s in self._segments)
        while len(self._segments) > 1 and total > self._retain_bytes:
            victim = self._segments.pop(0)
            total -= victim.size
            try:
                os.remove(victim.path)
            except OSError:
                pass
            self.first_retained_seq = self._segments[0].first_seq

    def close(self) -> None:
        with self._cond:
            if self._fh is not None:
                self._fh.flush()
                if self._fsync:
                    os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None

    def durable(self) -> bool:
        return self._dir is not None

    def last_seq(self) -> int:
        with self._cond:
            return self._seq

    def history_start_ns(self) -> int:
        """Oldest timestamp this log can still replay faithfully."""
        if self._dir and self._segments:
            try:
                for _seq, ts_ns, _payload in _iter_segment(
                        self._segments[0].path):
                    return ts_ns
            except FileNotFoundError:  # retention raced us
                pass
        return max(self._created_ts, self._evicted_ts)

    # -- hybrid logical clock ----------------------------------------------

    def next_ts(self) -> int:
        """Advance and return the HLC: callers stamping entries BEFORE the
        store write (geo LWW) pass the result back into ``append(ts=)``
        so the event and the stored stamp agree."""
        with self._cond:
            ts = time.time_ns()
            if ts <= self._last_ts:
                ts = self._last_ts + 1
            self._last_ts = ts
            return ts

    def observe(self, ts_ns: int) -> None:
        """Fold a REMOTE timestamp into the clock: after applying a
        remote event stamped ts, every later local write must stamp
        strictly greater — the hybrid-logical-clock merge rule."""
        with self._cond:
            self._last_ts = max(self._last_ts, ts_ns)

    # -- append / ingest ----------------------------------------------------

    def append(self, directory: str,
               old_entry: filer_pb2.Entry | None,
               new_entry: filer_pb2.Entry | None,
               delete_chunks: bool = False,
               new_parent_path: str = "",
               signatures: list[int] | None = None,
               ts: int | None = None) -> int:
        event = filer_pb2.EventNotification(
            delete_chunks=delete_chunks,
            new_parent_path=new_parent_path,
            signatures=signatures or [],
        )
        if old_entry is not None:
            event.old_entry.CopyFrom(old_entry)
        if new_entry is not None:
            event.new_entry.CopyFrom(new_entry)
        with self._cond:
            if ts is None:
                ts = time.time_ns()
                if ts <= self._last_ts:  # keep ts strictly monotonic
                    ts = self._last_ts + 1
            elif ts < self._last_ts:
                # the caller reserved this stamp via next_ts() BEFORE
                # taking this lock, and a later reservation appended
                # first: log at a monotonic ts anyway — a ts-resumed
                # subscriber must never see the log regress (it would
                # silently skip this event on resubscribe).  The stored
                # ENTRY keeps the reserved stamp; LWW compares entry
                # stamps, never the event ts (geo ships re-derive from
                # the entry/tombstone).
                ts = self._last_ts + 1
            self._last_ts = max(self._last_ts, ts)
            resp = filer_pb2.SubscribeMetadataResponse(
                directory=directory, ts_ns=ts
            )
            resp.event_notification.CopyFrom(event)
            self._seq += 1
            self._persist_locked(self._seq, resp)
            if len(self._events) == self._events.maxlen:
                self._evicted_ts = max(self._evicted_ts,
                                       self._events[0][1].ts_ns)
            self._events.append((self._seq, resp))
            self._cond.notify_all()
            self._notify_listeners_locked(resp)
        return ts

    def ingest(self, resp: filer_pb2.SubscribeMetadataResponse) -> None:
        """Insert an event from another filer AS-IS (aggregation path):
        the original ts_ns is the cross-cluster ordering key, so it must
        not be re-stamped."""
        with self._cond:
            self._seq += 1
            self._persist_locked(self._seq, resp)
            self._events.append((self._seq, resp))
            self._last_ts = max(self._last_ts, resp.ts_ns)
            self._cond.notify_all()
            self._notify_listeners_locked(resp)

    # -- listeners ----------------------------------------------------------

    def _notify_listeners_locked(self, resp) -> None:
        from ..stats.metrics import META_LISTENER_ERRORS

        dead = []
        for fn in self._listeners:
            try:
                fn(resp)
            except Exception as e:  # a dead notification sink must
                # not kill the write path, but must be visible
                META_LISTENER_ERRORS.labels("error").inc()
                fails = self._listener_failures.get(id(fn), 0) + 1
                self._listener_failures[id(fn)] = fails
                if fails >= LISTENER_MAX_FAILURES:
                    dead.append(fn)
                    glog.error(
                        "meta listener failed %d times in a row; "
                        "unsubscribing it: %s", fails, e)
                else:
                    glog.warning("meta listener failed: %s", e)
            else:
                self._listener_failures.pop(id(fn), None)
        for fn in dead:
            META_LISTENER_ERRORS.labels("evicted").inc()
            self._listeners.remove(fn)
            self._listener_failures.pop(id(fn), None)

    def add_listener(self, fn) -> None:
        """Synchronous callback per event (notification sinks)."""
        with self._cond:
            self._listeners.append(fn)

    def listener_count(self) -> int:
        with self._cond:
            return len(self._listeners)

    # -- reading ------------------------------------------------------------

    def _read_persisted(self, after_seq: int, before_seq: int,
                        min_ts: int = 0):
        """Yield (seq, resp) with after_seq < seq < before_seq from the
        durable segments.  Caller must have verified after_seq+1 >=
        first_retained_seq (else the stream would silently gap).
        ``min_ts`` drops records with ts_ns <= min_ts BEFORE protobuf
        decode (the frame header carries ts) — a subscriber resuming
        near the head must not pay a full-log deserialization."""
        if not self._dir:
            return
        with self._cond:
            segments = list(self._segments)
        for i, seg in enumerate(segments):
            nxt = (segments[i + 1].first_seq
                   if i + 1 < len(segments) else 1 << 62)
            if nxt <= after_seq + 1:
                continue
            if seg.max_ts is not None and seg.max_ts <= min_ts:
                continue  # whole segment predates the subscription
            sealed = i + 1 < len(segments)
            seen_max = 0
            try:
                for seq, ts, payload in _iter_segment(seg.path):
                    seen_max = max(seen_max, ts)
                    if seq >= before_seq:
                        return
                    if seq <= after_seq or ts <= min_ts:
                        continue
                    resp = \
                        filer_pb2.SubscribeMetadataResponse.FromString(
                            payload)
                    yield seq, resp
            except FileNotFoundError:
                # retention deleted this segment mid-read: surface the
                # documented loud-gap protocol, not a raw IO error
                raise MetaLogGap(after_seq, self.first_retained_seq) \
                    from None
            if sealed and seen_max:
                seg.max_ts = seen_max

    def tail(self, after_seq: int,
             stop_event: threading.Event | None = None,
             poll_interval: float = 0.2):
        """Yield (seq, event) for every event with seq > after_seq —
        persisted history first, then the live ring — until stopped.

        Raises ``MetaLogGap`` when retention already dropped events the
        caller has not seen: the consumer must resync from a snapshot
        rather than silently skip mutations."""
        cursor = after_seq
        while stop_event is None or not stop_event.is_set():
            with self._cond:
                if cursor + 1 < self.first_retained_seq and self._dir:
                    raise MetaLogGap(cursor, self.first_retained_seq)
                mem_first = (self._events[0][0] if self._events
                             else self._seq + 1)
                need_cold = cursor + 1 < mem_first
                batch = ([] if need_cold else
                         [(seq, ev) for seq, ev in self._events
                          if seq > cursor])
                if not need_cold and not batch:
                    self._cond.wait(timeout=poll_interval)
            if need_cold:
                # ring already evicted part of the range: serve the cold
                # span from disk, then re-check the ring
                served = False
                for seq, ev in self._read_persisted(cursor, mem_first):
                    served = True
                    cursor = seq
                    yield seq, ev
                if not served:
                    # memory-only log that evicted (or an impossible hole
                    # in the durable layer): an undetectable gap would be
                    # silent corruption downstream — fail loud
                    raise MetaLogGap(cursor, mem_first)
                continue
            for seq, ev in batch:
                cursor = seq
                yield seq, ev

    def subscribe(self, since_ns: int, path_prefix: str = "",
                  stop_event: threading.Event | None = None,
                  poll_interval: float = 0.2):
        """Yield events with ts_ns > since_ns, then tail until stopped.

        The live cursor advances over arrival sequence numbers, so an
        aggregated event ingested late with an older ts_ns is neither
        skipped nor double-delivered.  With a durable layer, history the
        ring evicted (or that predates this process) is served from the
        segment files first."""
        cursor = 0  # arrival seq of the last yielded event
        while stop_event is None or not stop_event.is_set():
            batch = []
            with self._cond:
                mem_first = (self._events[0][0] if self._events
                             else self._seq + 1)
                # the ring moved past the cursor (initial attach, or
                # eviction while a slow consumer drained): serve the
                # cold span from the durable segments first
                need_cold = self._dir is not None and \
                    cursor + 1 < mem_first
                if not need_cold:
                    for seq, ev in self._events:
                        if seq > cursor and ev.ts_ns > since_ns:
                            batch.append((seq, ev))
                    if not batch:
                        self._cond.wait(timeout=poll_interval)
            if need_cold:
                try:
                    for seq, ev in self._read_persisted(
                            cursor, mem_first, min_ts=since_ns):
                        cursor = seq
                        if not path_prefix or _matches_prefix(
                                ev, path_prefix):
                            yield ev
                except MetaLogGap:
                    # retention outran this consumer: subscribe keeps
                    # the ts-protocol's lossy-bootstrap contract (the
                    # caller resumes from a store snapshot); the
                    # seq-exact tail() is the loud-gap surface
                    pass
                # everything below mem_first was scanned (matched,
                # ts-filtered at the frame header, or dropped by
                # retention): resume from the ring
                cursor = max(cursor, mem_first - 1)
                continue
            for seq, ev in batch:
                cursor = seq
                if path_prefix and not _matches_prefix(ev, path_prefix):
                    continue
                yield ev


def _matches_prefix(ev, prefix: str) -> bool:
    """An event is relevant when any affected full path lives under the
    prefix (directory + entry name, old or new)."""
    base = ev.directory.rstrip("/")
    n = ev.event_notification
    for entry in (n.old_entry, n.new_entry):
        if entry.name:
            full = f"{base}/{entry.name}"
            if full.startswith(prefix) or prefix.startswith(full + "/"):
                return True
    if n.new_parent_path and n.new_parent_path.startswith(prefix):
        return True
    return False
