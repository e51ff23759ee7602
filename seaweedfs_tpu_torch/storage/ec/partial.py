"""Partial-sum EC repair protocol (VolumeEcShardPartialApply) — the port of
seaweedfs_tpu/storage/ec/partial.py.

Rebuild and degraded reads otherwise stream DATA_SHARDS full shard
intervals across the network to one rebuilder, and the wire becomes the
bottleneck (Rashmi et al., arXiv:1309.0186, measure repair traffic
dominating cross-rack bandwidth; product-matrix regenerating codes,
arXiv:1412.3022, formalize the bandwidth floor).  This module moves the
decode-plan matmul to the data: each SOURCE multiplies its local shard
intervals by its columns of the shared decode plan and streams the GF(2^8)
partial sum; partials XOR-combine at a rack-level aggregator so exactly one
(rows x width) block crosses each rack boundary, and the rebuilder's
network-in drops from sources x width to racks x rows x width.

A source computes its partial on the host, as the reference does:
`compute_partial` goes through the host-mode codec service (the native
SIMD `cpu` codec), never the card, whatever the server's codec.  The
rebuilder applies the local sources' columns on its own codec (the card
for a `cuda` rebuild, storage/ec/encoder.py) and XORs the partials in.

GF linearity makes byte-identity structural: the XOR of the sources'
coefficient-weighted rows IS the decode-plan matmul over the gathered
rows, term for term — same plan cache, same bytes.

Any failure (a source dying mid-stream, a stale location, a missing
holder) raises :class:`PartialUnavailable` and the caller degrades to
the full-shard fetch path — the protocol is an optimization, never a new
way to fail a repair.

Three layers live here so the real gRPC path and the in-process test
network share one implementation:

* ``serve_partial``   — source-side core (the gRPC handler's body);
* ``PartialRepairClient`` — rebuilder-side planning + fan-out + XOR;
* ``local_source_network`` — an in-process fleet of sources for unit
  tests.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from ...ops import codec_service
from ...pb import volume_server_pb2 as vs
from ...stats.metrics import (
    EC_PARTIAL_BYTES,
    EC_PARTIAL_JOBS,
    EC_REBUILD_BYTES,
)
from ...topology.placement import (
    best_ec_holder,
    ec_source_locality,
    group_partial_sources,
    order_ec_sources,
)
from ...util import faultpoint
from .constants import to_ext

# fires on every source serve of a partial-sum request, BEFORE the local
# shard reads, ctx = the serving node's address — chaos tests kill one
# source mid-protocol here and assert the rebuilder's clean fallback
FP_PARTIAL_APPLY = faultpoint.register("ec.partial.apply")

# fires once per VOLUME JOB inside a cross-volume batch serve, ctx =
# "<node address> vol=<vid>" — chaos kills one source mid-batch and
# asserts exactly that volume degrades per-volume while the rest of the
# batch completes on the aggregated path
FP_BATCH_SOURCE = faultpoint.register("repair.batch.source")

PARTIAL_CHUNK = 1024 * 1024

# concurrent volume jobs served per batch rpc (short-lived threads: the
# serve side must never borrow the rebuilder's fan-out pool, or an
# in-process source fleet could deadlock a full pool against itself)
BATCH_SERVE_WORKERS = int(os.environ.get(
    "SEAWEEDFS_TPU_EC_BATCH_SERVE_WORKERS", "8"))


class PartialUnavailable(IOError):
    """The protocol could not produce a combined partial (dead source,
    missing holder, bad stream) — degrade to the full-fetch path."""


# one bounded process-wide executor for the rebuilder's per-rack group
# fan-out (flat: group rpcs land on OTHER servers' handler threads, and
# serve-side delegate fan-out uses short-lived threads, so this pool
# never waits on itself)
_POOL = None
_POOL_LOCK = threading.Lock()


def _pool():
    global _POOL
    if _POOL is None:
        with _POOL_LOCK:
            if _POOL is None:
                from ...util.executors import MeteredThreadPoolExecutor

                workers = int(os.environ.get(
                    "SEAWEEDFS_TPU_EC_PARTIAL_WORKERS", "8"))
                _POOL = MeteredThreadPoolExecutor(
                    max_workers=workers, name="ec_partial",
                    thread_name_prefix="ec-partial")
    return _POOL


def compute_partial(coef: np.ndarray, rows: list) -> np.ndarray:
    """(M, K) GF coefficient rows x K equal-length byte rows -> (M, W).

    Routed through the shared host-mode codec service — concurrent
    partial serves from many rebuilds coalesce into one native SIMD call;
    the direct host codec when the service is disabled."""
    coef = np.ascontiguousarray(coef, dtype=np.uint8)
    svc = codec_service.get_service("cpu")
    if svc is not None:
        out = svc.submit_apply(coef, rows).result()
    else:
        from ...ops.codec import get_codec

        out = get_codec("cpu").apply_rows(coef, list(rows))
    return np.ascontiguousarray(np.asarray(out, dtype=np.uint8))


def pack_coefficients(coef_by_shard: "dict[int, np.ndarray]",
                      shard_ids: list[int]) -> bytes:
    """Row-major (row_count x len(shard_ids)) coefficient block whose
    column j weights shard_ids[j] — the wire layout of `coefficients`."""
    return np.ascontiguousarray(
        np.stack([np.asarray(coef_by_shard[s], dtype=np.uint8)
                  for s in shard_ids], axis=1)).tobytes()


# ---------------------------------------------------------------------------
# Source side
# ---------------------------------------------------------------------------


def serve_partial(request, read_interval, stub_for=None, ctx: str = "",
                  throttle=None) -> np.ndarray:
    """Compute one server's combined partial for a request: the local
    shards' coefficient-weighted sum, XOR'd with every delegate's
    partial (fetched concurrently).  Returns the (row_count, size)
    uint8 array.

    Raises on ANY missing contribution — a partial missing one term is
    silently wrong bytes, so the rpc must fail loudly and let the
    rebuilder fall back to full fetches.

    ``read_interval(shard_id, offset, length) -> bytes|None`` supplies
    local shard bytes; ``throttle(n)`` (optional) charges the node's
    shared background-I/O budget before the compute."""
    try:
        faultpoint.inject(FP_PARTIAL_APPLY, ctx=ctx)
        m = int(request.row_count)
        sids = list(request.shard_ids)
        width = int(request.size)
        coef = np.frombuffer(bytes(request.coefficients), dtype=np.uint8)
        if m <= 0 or width <= 0 or coef.size != m * len(sids):
            raise ValueError(
                f"bad partial-apply geometry: rows={m} width={width} "
                f"coef={coef.size} shards={len(sids)}")
        if throttle is not None:
            throttle(len(sids) * width)
        rows = []
        for sid in sids:
            buf = read_interval(sid, int(request.offset), width)
            if buf is None or len(buf) != width:
                raise IOError(
                    f"shard {sid} interval unreadable for partial apply")
            rows.append(np.frombuffer(buf, dtype=np.uint8))
        if sids:
            acc = compute_partial(coef.reshape(m, len(sids)), rows)
        else:
            acc = np.zeros((m, width), dtype=np.uint8)
        if len(request.delegates):
            if stub_for is None:
                raise IOError("delegates present but no delegate transport")
            # short-lived threads: delegate counts are bounded by rack
            # size and this runs once per served slice, so spawn cost is
            # noise next to the rpc RTT — and it cannot deadlock the
            # shared client pool from inside a handler
            parts: list = [None] * len(request.delegates)
            errs: list = []

            def fetch_one(i: int, d) -> None:
                try:
                    parts[i] = fetch_partial_once(
                        stub_for(d.grpc_address), request.volume_id,
                        request.collection, int(request.offset), width, m,
                        list(d.shard_ids), bytes(d.coefficients))
                except Exception as e:  # noqa: BLE001 — joined below
                    errs.append(e)

            threads = [threading.Thread(target=fetch_one, args=(i, d),
                                        daemon=True)
                       for i, d in enumerate(request.delegates)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errs:
                raise IOError(f"delegate partial failed: {errs[0]}")
            for p in parts:
                np.bitwise_xor(acc, p, out=acc)
        EC_PARTIAL_BYTES.labels("serve").inc(m * width)
        EC_PARTIAL_JOBS.labels("serve", "ok").inc()
        return acc
    except Exception:
        EC_PARTIAL_JOBS.labels("serve", "error").inc()
        raise


def serve_partial_batch(request, read_interval_for, stub_for=None,
                        ctx: str = "", throttle=None):
    """Serve a cross-volume batch (`request.batch`): every PartialVolumeJob
    is one volume's coefficient-column request, served through the SAME
    serve_partial core — jobs run concurrently so their codec-service
    submissions coalesce into multi-volume batches.  Yields ``(volume_id, ndarray | Exception)`` in
    completion order: a dead shard fails exactly ITS volume (the
    rebuilder degrades that one volume to per-volume sourcing) and never
    stalls the rest of the batch.

    ``read_interval_for(volume_id, collection)`` resolves one volume's
    `read_interval(shard_id, offset, length)` reader, or None when the
    volume is absent here."""
    import queue as _queue

    jobs = list(request.batch)
    done: _queue.Queue = _queue.Queue()
    gate = threading.Semaphore(max(BATCH_SERVE_WORKERS, 1))

    def serve_one(job) -> None:
        try:
            with gate:
                faultpoint.inject(
                    FP_BATCH_SOURCE, ctx=f"{ctx} vol={job.volume_id}")
                read_interval = read_interval_for(
                    job.volume_id, job.collection)
                if read_interval is None:
                    raise IOError(
                        f"ec volume {job.volume_id} not present here")
                done.put((job.volume_id, serve_partial(
                    job, read_interval, stub_for=stub_for, ctx=ctx,
                    throttle=throttle)))
        except Exception as e:  # noqa: BLE001 — per-volume isolation
            done.put((job.volume_id, e))

    threads = [threading.Thread(target=serve_one, args=(j,), daemon=True)
               for j in jobs]
    for t in threads:
        t.start()
    for _ in jobs:
        yield done.get()
    for t in threads:
        t.join()


def batch_response_frames(request, read_interval_for, stub_for=None,
                          ctx: str = "", throttle=None):
    """serve_partial_batch -> wire frames: per-volume data chunks tagged
    with volume_id, closed by an eof frame (carrying the error string on
    a failed job).  Shared by the gRPC handler and the in-process test
    network so both speak the identical framing."""
    for vid, result in serve_partial_batch(
            request, read_interval_for, stub_for=stub_for, ctx=ctx,
            throttle=throttle):
        if isinstance(result, Exception):
            yield vs.VolumeEcShardPartialApplyResponse(
                volume_id=vid, eof=True, error=str(result) or "failed")
            continue
        blob = result.tobytes()
        for at in range(0, len(blob), PARTIAL_CHUNK):
            yield vs.VolumeEcShardPartialApplyResponse(
                volume_id=vid, data=blob[at:at + PARTIAL_CHUNK])
        yield vs.VolumeEcShardPartialApplyResponse(volume_id=vid, eof=True)


# ---------------------------------------------------------------------------
# Rebuilder side
# ---------------------------------------------------------------------------


def fetch_partial_once(stub, volume_id: int, collection: str, offset: int,
                       size: int, row_count: int, shard_ids: list[int],
                       coefficients: bytes, delegates=()) -> np.ndarray:
    """One VolumeEcShardPartialApply rpc -> the (row_count, size) block."""
    req = vs.VolumeEcShardPartialApplyRequest(
        volume_id=volume_id, collection=collection, offset=offset,
        size=size, row_count=row_count, shard_ids=shard_ids,
        coefficients=coefficients)
    for addr, sids, coef in delegates:
        req.delegates.add(grpc_address=addr, shard_ids=sids,
                          coefficients=coef)
    EC_PARTIAL_BYTES.labels("req").inc(req.ByteSize())
    blob = b"".join(bytes(r.data) for r in
                    stub.VolumeEcShardPartialApply(req) if r.data)
    if len(blob) != row_count * size:
        raise IOError(
            f"short partial stream: want {row_count * size} got {len(blob)}")
    return np.frombuffer(blob, dtype=np.uint8).reshape(row_count, size)


def probe_shard_size(stub, volume_id: int, collection: str = "") -> int:
    """size=0 probe: a holder answers with its shard file size (what a
    rebuilder with zero local shards needs to size the stream from)."""
    req = vs.VolumeEcShardPartialApplyRequest(
        volume_id=volume_id, collection=collection, size=0)
    EC_PARTIAL_BYTES.labels("req").inc(req.ByteSize())
    for r in stub.VolumeEcShardPartialApply(req):
        return int(r.shard_size)
    return 0


class PartialRepairClient:
    """Rebuilder-side orchestration: locate holders, prefer same-rack
    sources, issue one aggregated request per rack, XOR the per-rack
    partials, and label the ingress bytes by locality.

    ``locate() -> {shard_id: [(grpc_address, rack, dc), ...]}`` resolves
    holders (the caller excludes itself); ``stub_for(addr)`` returns the
    rpc stub for an address.  Lookups ride a TieredLocationCache so a
    rebuild storm does not hammer the master.
    """

    def __init__(self, volume_id: int, collection: str, locate, stub_for,
                 my_rack: str = "", my_dc: str = ""):
        from ...wdclient.location_cache import TieredLocationCache

        self.volume_id = volume_id
        self.collection = collection
        self._stub_for = stub_for
        self._cache = TieredLocationCache(locate)
        self.my_rack = my_rack
        self.my_dc = my_dc

    def remote_shards(self) -> "dict[int, tuple[str, str, str]]":
        """Best holder per shard id — same-rack holders win, address as
        tiebreak so the choice is stable across slices."""
        out: dict[int, tuple[str, str, str]] = {}
        for sid, holders in self._cache.get().items():
            if holders:
                out[sid] = best_ec_holder(holders, self.my_rack, self.my_dc)
        return out

    def invalidate(self) -> None:
        self._cache.invalidate()

    def order(self, holders: "dict[int, tuple[str, str, str]]") -> list[int]:
        return order_ec_sources(holders, self.my_rack, self.my_dc)

    def ingress_advantage(self, remote_sids, row_count: int) -> float:
        """full-fetch ingress / partial ingress for this source set:
        partial pulls (racks x row_count x width) vs full's
        (sources x width).  Below 1.0 the protocol would MOVE MORE
        bytes than it saves (e.g. 4 lost shards against 3 remote
        sources) — callers then keep the full-fetch path."""
        holders = self.remote_shards()
        chosen = {sid: holders[sid] for sid in remote_sids
                  if sid in holders}
        if not chosen or row_count <= 0:
            return 0.0
        racks = len(group_partial_sources(chosen))
        return len(chosen) / float(racks * row_count)

    def locality_of(self, sid: int) -> str:
        h = self.remote_shards().get(sid)
        if h is None:
            return "dc"
        return ec_source_locality(h[1], h[2], self.my_rack, self.my_dc)

    def shard_size(self) -> int:
        """Probe any reachable holder for the shard file size."""
        for _sid, (addr, _r, _d) in sorted(self.remote_shards().items()):
            try:
                n = probe_shard_size(
                    self._stub_for(addr), self.volume_id, self.collection)
            except Exception:  # noqa: BLE001 — try the next holder
                continue
            if n:
                return n
        return 0

    def fetch(self, coef_by_shard: "dict[int, np.ndarray]", row_count: int,
              offset: int, length: int) -> np.ndarray:
        """One aggregated (row_count, length) partial over the given
        remote source shards.  Raises PartialUnavailable on ANY failure
        — the caller falls back to full fetches (and this client drops
        its location cache, so the retry sees fresh holders)."""
        holders = self.remote_shards()
        chosen: dict[int, tuple[str, str, str]] = {}
        for sid in coef_by_shard:
            h = holders.get(sid)
            if h is None:
                raise PartialUnavailable(f"no holder for source shard {sid}")
            chosen[sid] = h
        groups = group_partial_sources(chosen)
        try:
            results = self._fetch_groups(
                groups, coef_by_shard, row_count, offset, length)
        except Exception as e:
            EC_PARTIAL_JOBS.labels("fetch", "error").inc()
            self._cache.invalidate()
            if isinstance(e, PartialUnavailable):
                raise
            raise PartialUnavailable(str(e)) from e
        acc = np.zeros((row_count, length), dtype=np.uint8)
        for g, part in results:
            label = ec_source_locality(
                g["rack"], g["dc"], self.my_rack, self.my_dc)
            EC_REBUILD_BYTES.labels(label).inc(part.nbytes)
            EC_PARTIAL_BYTES.labels("recv").inc(part.nbytes)
            np.bitwise_xor(acc, part, out=acc)
        EC_PARTIAL_JOBS.labels("fetch", "ok").inc()
        return acc

    @staticmethod
    def _group_request(g: dict, coef_by_shard) -> tuple:
        """-> (aggregator_addr, its shard ids, its coefficient block,
        [(delegate_addr, sids, coef_block)]) for one rack group — the
        one wire shape shared by the direct and the batched dispatch."""
        agg = g["aggregator"]
        agg_sids = g["members"][agg]
        delegates = [
            (addr, sids, pack_coefficients(coef_by_shard, sids))
            for addr, sids in sorted(g["members"].items())
            if addr != agg
        ]
        return agg, agg_sids, pack_coefficients(coef_by_shard, agg_sids), \
            delegates

    def _fetch_groups(self, groups, coef_by_shard, row_count: int,
                      offset: int, length: int) -> list:
        """Direct dispatch: one rpc per rack group on the shared pool.
        The batched subclass reroutes this through a cross-volume
        group-commit session instead."""

        def one_group(g: dict) -> "tuple[dict, np.ndarray]":
            agg, agg_sids, coef, delegates = self._group_request(
                g, coef_by_shard)
            part = fetch_partial_once(
                self._stub_for(agg), self.volume_id, self.collection,
                offset, length, row_count, agg_sids, coef,
                delegates=delegates)
            return g, part

        if len(groups) == 1:
            return [one_group(groups[0])]
        return list(_pool().map(one_group, groups))


# ---------------------------------------------------------------------------
# Cross-volume aggregation: many volumes, one rpc per source
# ---------------------------------------------------------------------------


class MassPartialSession:
    """Group-commit dispatcher for a mass repair: concurrent per-volume
    partial fetches from MANY volume rebuilds coalesce into one streaming
    VolumeEcShardPartialApply rpc per source server.

    The window is the natural one: each source address has its own
    worker — while its rpc is in flight, every fetch for that address
    queues up and rides its next wave (no timers), and a slow source
    never head-of-line blocks dispatch to the fast ones.  Per-volume
    eof/error frames resolve each job's future independently, so a dead
    shard fails exactly its volume (PartialUnavailable -> that volume
    falls back per-volume) and never stalls the batch.
    """

    _CLOSE = object()

    def __init__(self, stub_for, max_jobs_per_rpc: int = 64):
        from concurrent.futures import Future

        self._Future = Future
        self._stub_for = stub_for
        self.max_jobs_per_rpc = max(max_jobs_per_rpc, 1)
        import queue as _queue

        self._queue_mod = _queue
        self._lock = threading.Lock()
        # per source address: its job queue + dedicated worker thread
        self._addr_q: dict[str, object] = {}
        self._workers: list[threading.Thread] = []
        self._closed = False
        self.rpcs = 0
        self.batched_jobs = 0

    def submit(self, addr: str, job: dict):
        """Queue one per-volume rack-group job for `addr`; -> Future of
        the (row_count, size) partial.  Job fields mirror
        PartialVolumeJob (+ 'delegates': [(addr, sids, coef_bytes)])."""
        fut = self._Future()
        with self._lock:
            if self._closed:
                raise PartialUnavailable("mass partial session closed")
            q = self._addr_q.get(addr)
            if q is None:
                q = self._queue_mod.Queue()
                self._addr_q[addr] = q
                t = threading.Thread(
                    target=self._addr_run, args=(addr, q),
                    name=f"mass-partial-{addr}", daemon=True)
                self._workers.append(t)
                t.start()
        q.put((job, fut))
        return fut

    def close(self) -> None:
        with self._lock:
            self._closed = True
            queues = list(self._addr_q.values())
            workers = list(self._workers)
        for q in queues:
            q.put(self._CLOSE)
        for t in workers:
            t.join(timeout=10)
        for q in queues:  # a submit that raced the close marker
            while True:
                try:
                    left = q.get_nowait()
                except self._queue_mod.Empty:
                    break
                if left is not self._CLOSE:
                    left[1].set_exception(
                        PartialUnavailable("session closed"))

    def _addr_run(self, addr: str, q) -> None:
        while True:
            item = q.get()
            if item is self._CLOSE:
                # fail anything that raced in behind the close marker
                while True:
                    try:
                        left = q.get_nowait()
                    except self._queue_mod.Empty:
                        return
                    if left is not self._CLOSE:
                        left[1].set_exception(
                            PartialUnavailable("session closed"))
            batch = [item]
            seen_vids = {item[0]["volume_id"]}
            defer = []
            while len(batch) < self.max_jobs_per_rpc:
                try:
                    nxt = q.get_nowait()
                except self._queue_mod.Empty:
                    break
                if nxt is self._CLOSE:
                    q.put(nxt)  # re-deliver after this batch
                    break
                if nxt[0]["volume_id"] in seen_vids:
                    # frames are keyed by volume_id within one rpc, so
                    # a second slice of the same volume rides the next
                    defer.append(nxt)
                    continue
                seen_vids.add(nxt[0]["volume_id"])
                batch.append(nxt)
            for d in defer:
                q.put(d)
            self._send(addr, [(addr, job, fut) for job, fut in batch])

    def _send(self, addr: str, items: list) -> None:
        req = vs.VolumeEcShardPartialApplyRequest()
        want: dict[int, tuple] = {}
        for _addr, job, fut in items:
            b = req.batch.add(
                volume_id=job["volume_id"],
                collection=job.get("collection", ""),
                offset=job["offset"], size=job["size"],
                row_count=job["row_count"], shard_ids=job["shard_ids"],
                coefficients=job["coefficients"])
            for daddr, sids, coef in job.get("delegates", ()):
                b.delegates.add(grpc_address=daddr, shard_ids=sids,
                                coefficients=coef)
            want[job["volume_id"]] = (
                job["row_count"] * job["size"], fut)
        with self._lock:
            self.rpcs += 1
            self.batched_jobs += len(items)
        EC_PARTIAL_BYTES.labels("req").inc(req.ByteSize())
        bufs: dict[int, list] = {vid: [] for vid in want}
        try:
            for r in self._stub_for(addr).VolumeEcShardPartialApply(req):
                vid = int(r.volume_id)
                if vid not in want:
                    continue
                expect, fut = want[vid]
                if r.error:
                    if not fut.done():
                        fut.set_exception(PartialUnavailable(r.error))
                    continue
                if r.data:
                    bufs[vid].append(bytes(r.data))
                if r.eof and not fut.done():
                    blob = b"".join(bufs[vid])
                    if len(blob) != expect:
                        fut.set_exception(PartialUnavailable(
                            f"short batch stream for volume {vid}: "
                            f"want {expect} got {len(blob)}"))
                    else:
                        fut.set_result(np.frombuffer(
                            blob, dtype=np.uint8))
        except Exception as e:  # noqa: BLE001 — the rpc died mid-stream
            for _expect, fut in want.values():
                if not fut.done():
                    fut.set_exception(PartialUnavailable(str(e)))
            return
        for vid, (_expect, fut) in want.items():
            if not fut.done():
                fut.set_exception(PartialUnavailable(
                    f"no eof frame for volume {vid}"))


class BatchedPartialClient(PartialRepairClient):
    """PartialRepairClient whose rack-group rpcs ride a shared
    MassPartialSession — the per-volume protocol is unchanged (same
    groups, same coefficients, same XOR), only the transport batches
    many volumes per wire round trip.  `shard_size_hint` (from the
    orchestrator's plan, which learned sizes from heartbeats) saves the
    per-volume size-probe rpc the solo client needs."""

    # source selection skips the 1-byte liveness probes: this client's
    # holder map is freshly looked up (the dead-node notice invalidated
    # it), and a stale holder degrades exactly one volume per-volume —
    # probing every source of every volume would re-serialize the batch
    trust_holders = True

    def __init__(self, session: MassPartialSession, *args,
                 shard_size_hint: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self._session = session
        self._size_hint = int(shard_size_hint)

    def shard_size(self) -> int:
        return self._size_hint or super().shard_size()

    def _fetch_groups(self, groups, coef_by_shard, row_count: int,
                      offset: int, length: int) -> list:
        futs = []
        for g in groups:
            agg, agg_sids, coef, delegates = self._group_request(
                g, coef_by_shard)
            futs.append((g, self._session.submit(agg, {
                "volume_id": self.volume_id,
                "collection": self.collection,
                "offset": offset, "size": length,
                "row_count": row_count, "shard_ids": agg_sids,
                "coefficients": coef, "delegates": delegates,
            })))
        return [(g, fut.result().reshape(row_count, length))
                for g, fut in futs]


# ---------------------------------------------------------------------------
# In-process source fleet (unit tests)
# ---------------------------------------------------------------------------


def local_source_network(nodes: "dict[str, object]"):
    """Drive the REAL serve/fetch code without sockets: ``nodes`` maps a
    fake grpc address -> (base_name, shard_ids it "holds"), or — for
    multi-volume fleets driving the batch protocol — a dict
    ``{volume_id: (base_name, shard_ids)}``.  Returns ``stub_for``
    usable by PartialRepairClient / MassPartialSession — each stub
    executes serve_partial (or the cross-volume batch serve) inline,
    including delegate fan-out through the same fleet, and streams the
    result in PARTIAL_CHUNK chunks like the wire handler does."""
    from types import SimpleNamespace

    def _held(addr: str, vid: int):
        """-> (base, sids) this fake node holds for vid, or None."""
        entry = nodes[addr]
        if isinstance(entry, dict):
            return entry.get(vid)
        return entry  # single-volume fleet: every vid maps to it

    class _Stub:
        def __init__(self, addr: str):
            self._addr = addr

        def _read_interval_for(self, vid: int, _collection: str = ""):
            held = _held(self._addr, vid)
            if held is None:
                return None
            base, sids = held

            def read_interval(sid, off, length):
                if sid not in sids:
                    return None
                with open(base + to_ext(sid), "rb") as f:
                    f.seek(off)
                    return f.read(length)

            return read_interval

        def VolumeEcShardPartialApply(self, request):
            if len(request.batch):
                yield from batch_response_frames(
                    request, self._read_interval_for, stub_for=stub_for,
                    ctx=self._addr)
                return
            held = _held(self._addr, int(request.volume_id))
            base, sids = held if held is not None else ("", [])

            if int(request.size) == 0:
                first = next((s for s in sids
                              if os.path.exists(base + to_ext(s))), None)
                size = (os.path.getsize(base + to_ext(first))
                        if first is not None else 0)
                yield SimpleNamespace(data=b"", shard_size=size)
                return

            def read_interval(sid, off, length):
                if sid not in sids:
                    return None
                with open(base + to_ext(sid), "rb") as f:
                    f.seek(off)
                    return f.read(length)

            acc = serve_partial(request, read_interval, stub_for=stub_for,
                                ctx=self._addr)
            blob = acc.tobytes()
            for at in range(0, len(blob), PARTIAL_CHUNK):
                yield SimpleNamespace(
                    data=blob[at:at + PARTIAL_CHUNK], shard_size=0)

    def stub_for(addr: str) -> _Stub:
        return _Stub(addr)

    return stub_for
