"""VolumeServer process: the HTTP data path, the raw-TCP path, the gRPC
admin and EC rpcs and the master heartbeat — the port of
seaweedfs_tpu/volume/server.py.

Reference: weed/server/volume_server.go + volume_grpc_client_to_master.go.
The gRPC port is http_port + 10000 by convention, like the reference: peers
and the master know a volume server by its `ip:port` and derive the gRPC
address from it (`grpc_addr`).

    from seaweedfs_tpu_torch.volume.server import VolumeServer
    vs = VolumeServer(["/data/v1"], ["master:9333"], port=8080,
                      metrics_port=9325, tcp_port=8090)
    vs.start()  # HTTP on 8080, gRPC on 18080, /metrics on 9325, TCP on
    ...         # 8090, heartbeats to master:19333
    vs.stop()

Differences from the reference, on purpose:
  * the codec defaults to ``cuda`` (the reference's server defaults to
    ``cpu``), as the port's Store and EcVolume do.  The codec is built
    when the server is made, so a ``cuda`` server on a host without a card
    raises there; it never switches to the host by itself.  Each EC rpc's
    `codec` field is honoured, and an HTTP GET of a needle in a lost
    interval is decoded on the server's codec;
  * `stop()` joins every thread the server started — the heartbeat, the
    HTTP, metrics and TCP front ends with their connection threads, and
    the replica fan-out pool — and releases the port's cached channels to
    this server's address, so a process that starts and stops servers
    (tests, chip_smoke.py) leaves no thread or channel behind.  It leaves
    the process-wide codec service running, as the reference does:
    sibling servers in the process may be using it.
"""

from __future__ import annotations

import os
import threading
import time
import urllib.error
import weakref

import grpc

from ..ops.codec import get_codec
from ..pb import master_pb2
from ..pb import rpc as rpclib
from ..pb import volume_server_pb2 as vs
from ..security import Guard
from ..stats.metrics import (
    DISK_SIZE_GAUGE,
    REGISTRY,
    REPLICATION_ERROR,
    VOLUME_GAUGE,
    serve_metrics,
)
from ..storage.scrub import Scrubber
from ..storage.store import Store
from ..util import connpool, glog
from ..util.executors import MeteredThreadPoolExecutor
from .grpc_handlers import VolumeGrpcService, _write_stream
from .http_handlers import serve_http

GRPC_PORT_OFFSET = 10000


def grpc_addr(url: str) -> str:
    """http `host:port` -> its grpc address (the one port convention)."""
    host, port = url.rsplit(":", 1)
    return f"{host}:{int(port) + GRPC_PORT_OFFSET}"


def partial_enabled() -> bool:
    """SEAWEEDFS_TPU_EC_PARTIAL gate (default on) — one parse shared by
    every client-construction site."""
    return os.environ.get("SEAWEEDFS_TPU_EC_PARTIAL", "1").lower() not in (
        "0", "false", "off", "no")


class VolumeServer:
    def __init__(
        self,
        directories: list[str],
        master_addresses: list[str],
        ip: str = "127.0.0.1",
        port: int = 8080,
        public_url: str = "",
        data_center: str = "",
        rack: str = "",
        codec_name: str = "cuda",
        pulse_seconds: float = 3.0,
        max_volume_count: int | None = None,
        metrics_port: int = 0,
        jwt_signing_key: bytes | str = b"",
        whitelist: list[str] | None = None,
        tier_backends: dict | None = None,
        tcp_port: int = 0,  # experimental raw-TCP data path; 0 disables
        disk_types: list[str] | None = None,  # per-dir: hdd (default) / ssd
    ):
        # remote-tier backends: {"s3.default": {"endpoint": ..., ...}}
        # (the [storage.backend] config tier; backend.go:32-46)
        if tier_backends:
            from ..storage.backend_s3 import make_s3_backend

            for name, conf in tier_backends.items():
                btype, _, bid = name.partition(".")
                if btype == "s3":
                    make_s3_backend(bid or "default", conf)
                else:
                    glog.warning("unknown tier backend type %s", btype)
        self.ip = ip
        self.port = port
        self.tcp_port = tcp_port
        self.grpc_port = port + GRPC_PORT_OFFSET
        self.master_addresses = master_addresses
        self.pulse_seconds = pulse_seconds
        self.store = Store(
            directories,
            ip=ip,
            port=port,
            public_url=public_url,
            data_center=data_center,
            rack=rack,
            codec_name=codec_name,
            disk_types=disk_types,
        )
        # the server's codec, built now: a `cuda` server without a card
        # fails here, at start-up, not at its first EC rpc
        get_codec(self.store.codec_name)
        if max_volume_count:
            counts: dict[str, int] = {}
            for loc in self.store.locations:
                loc.max_volume_count = max_volume_count
                counts[loc.disk_type] = (
                    counts.get(loc.disk_type, 0) + max_volume_count)
            self.store.max_volume_counts = counts
        self.current_leader: str | None = None
        # the leader whose heartbeat ack came last: what lookups ask when
        # no redirect pinned current_leader (a seed reached directly)
        self._acked_leader: str | None = None
        # highest leader epoch (raft term) learned from heartbeat acks;
        # mutating rpcs stamped with an older epoch are rejected — a
        # deposed master cannot drive rebuilds/vacuums on this node
        self._leader_epoch = 0
        self.metrics_port = metrics_port
        self.jwt_signing_key = (
            jwt_signing_key.encode() if isinstance(jwt_signing_key, str)
            else jwt_signing_key
        )
        self.guard = Guard(whitelist)
        self._stop = threading.Event()
        self._httpd = None
        self._metricsd = None
        self._tcpd = None
        self._grpc_server = None
        self._hb_thread: threading.Thread | None = None
        self._hb_call = None  # the live SendHeartbeat stream, cancelled by stop
        # replica fan-out workers: writes/deletes post to every peer
        # CONCURRENTLY on pooled connections, so the client's ack waits
        # one slowest-peer RTT, not the sum over peers
        self._replica_pool = MeteredThreadPoolExecutor(
            max_workers=8, name="replica_fanout",
            thread_name_prefix="replica-fanout")
        # self-healing integrity plane: throttled background scrubber +
        # quarantine the read path feeds (SEAWEEDFS_TPU_SCRUB_RATE_MBPS=0
        # disables the daemon; on-demand VolumeScrub still works)
        self.scrubber = Scrubber(self.store)
        self.store.scrubber = self.scrubber
        # every EC location cache handed to fetchers/partial clients, so
        # a master dead-node notice (heartbeat ack dead_node_seq) can
        # drop them ALL eagerly — the first post-death rebuild must not
        # plan against a dead holder.  Lock-guarded: request threads
        # register caches concurrently with the heartbeat thread
        # snapshotting the set
        self._loc_caches: "weakref.WeakSet" = weakref.WeakSet()
        self._loc_caches_lock = threading.Lock()
        self._dead_node_seq = 0
        # disk-fault plane: a classified write fault (ENOSPC/EIO) sets
        # this so the heartbeat generator pushes a full beat NOW
        self._beat_now = threading.Event()
        self.store.on_disk_event = self._beat_now.set

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self.store.ec_fetcher_factory = self._make_ec_fetcher
        self.store.partial_client_factory = self._make_partial_client
        for loc in self.store.locations:
            for vid, ev in loc.ec_volumes.items():
                ev.remote_fetch = self._make_ec_fetcher(vid)
                ev.partial_client = self._make_partial_client(vid)
                ev.corruption_hook = self.scrubber.suspect_shard
        self.scrubber.start()
        # flight-recorder plane: always-on low-hz stack sampler feeding
        # /debug/profile/history (kill-switch + hz env knobs respected)
        from ..util import profiler as _profiler

        _profiler.ensure_continuous()
        self._httpd = serve_http(self, "0.0.0.0", self.port)
        self._grpc_server = rpclib.serve(
            [(rpclib.VOLUME_SERVER, VolumeGrpcService(self))], self.grpc_port)
        if self.metrics_port:
            self._metricsd = serve_metrics(self.metrics_port)
        if self.tcp_port:
            from .tcp_handlers import serve_tcp

            self._tcpd = serve_tcp(self, self.tcp_port)
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="volume-heartbeat", daemon=True)
        self._hb_thread.start()
        glog.info("volume server started http=%d grpc=%d codec=%s dirs=%s",
                  self.port, self.grpc_port, self.store.codec_name,
                  ",".join(loc.directory for loc in self.store.locations))

    def stop(self) -> None:
        self.stop_heartbeat()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=10.0)
        self.scrubber.stop()
        # each front end: stop accepting, close its connections, join its
        # loop and connection threads
        for srv in (self._tcpd, self._httpd, self._metricsd):
            if srv is not None:
                srv.shutdown()
                srv.server_close()
                srv.serve_thread.join(timeout=10.0)
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=0.5).wait()
        self._replica_pool.shutdown(wait=True)
        rpclib.close_channels(f"{self.ip}:{self.grpc_port}")
        # NOTE: the shared EC codec service is deliberately NOT closed
        # here — it is a process-wide singleton, and several volume
        # servers may run in one process (closing it would fail a
        # sibling's in-flight encode with "service is closed").  Encode/
        # rebuild request threads block on their job futures, so a
        # stopping server leaves no orphan work; codec_service.
        # shutdown_all() exists for owners that want an explicit drain.
        self.store.close()

    def stop_heartbeat(self) -> None:
        self._stop.set()
        self._beat_now.set()  # wake the request generator
        call = self._hb_call
        if call is not None:
            call.cancel()

    def update_gauges(self) -> None:
        """Refresh volume/EC gauges from the store (stats/metrics.go
        volume counts incl. the ec_shards label)."""
        by_collection: dict[str, int] = {}
        ec_by_collection: dict[str, int] = {}
        size_by_collection: dict[str, int] = {}
        # zero every child first so deleted collections don't report stale
        # values on later scrapes
        for metric in (VOLUME_GAUGE, DISK_SIZE_GAUGE):
            with metric._lock:
                children = list(metric._children.values())
            for child in children:
                child.set(0)
        for loc in self.store.locations:
            for v in loc.volumes.values():
                by_collection[v.collection] = by_collection.get(v.collection, 0) + 1
                size_by_collection[v.collection] = (
                    size_by_collection.get(v.collection, 0) + v.content_size
                )
            for ev in loc.ec_volumes.values():
                ec_by_collection[ev.collection] = (
                    ec_by_collection.get(ev.collection, 0) + len(ev.shards)
                )
        for coll, n in by_collection.items():
            VOLUME_GAUGE.labels(coll, "volume").set(n)
        for coll, n in ec_by_collection.items():
            VOLUME_GAUGE.labels(coll, "ec_shards").set(n)
        for coll, n in size_by_collection.items():
            DISK_SIZE_GAUGE.labels(coll, "normal").set(n)

    # -- heartbeat client -------------------------------------------------

    def _heartbeat_loop(self) -> None:
        """Reconnecting SendHeartbeat bidi stream, chasing the leader."""
        idx = 0
        while not self._stop.is_set():
            master = self.current_leader or self.master_addresses[
                idx % len(self.master_addresses)
            ]
            idx += 1
            was_leader_hint = master == self.current_leader
            try:
                self._heartbeat_once(master)
                if self.current_leader and self.current_leader != master:
                    continue  # fresh leader hint: chase it immediately
                if self.current_leader == master:
                    # the pinned master ended the stream WITHOUT naming a
                    # successor — a deposed leader cut off from its quorum
                    # does not know who won.  Unpin and rotate the seed
                    # list, or we heartbeat the minority side forever
                    self.current_leader = None
                # clean return = follower ended the stream (no leader yet):
                # back off instead of busy-spinning through the master list
                self._stop.wait(min(self.pulse_seconds, 1.0))
            except Exception:  # incl. grpc.RpcError
                if was_leader_hint and self.current_leader == master:
                    # the hinted leader died: fall back to seed rotation
                    self.current_leader = None
                if self.current_leader and self.current_leader != master:
                    # deposed master handed us the new leader mid-stream:
                    # re-register NOW
                    continue
                self._stop.wait(min(self.pulse_seconds, 1.0))

    def _with_stats(self, hb: master_pb2.Heartbeat) -> master_pb2.Heartbeat:
        """Attach the compact gauge/counter snapshot to a full heartbeat:
        the master's /cluster/metrics fallback when a live federation
        scrape cannot reach this node."""
        hb.stats.captured_at_ms = int(time.time() * 1000)
        for name, value in REGISTRY.snapshot_samples():
            hb.stats.samples.add(name=name, value=value)
        # confirmed scrub findings ride the same beat; re-delivered every
        # full beat until the target heals (the master keys findings
        # idempotently), so a stream that dies mid-send loses nothing
        for f in self.scrubber.outstanding_findings():
            hb.scrub_findings.add(**f)
        return hb

    def _heartbeat_once(self, master: str) -> None:
        stub = rpclib.master_stub(master)

        def requests():
            yield self._with_stats(self.store.collect_heartbeat())
            last_full = time.monotonic()
            while not self._stop.is_set():
                self._beat_now.wait(min(self.pulse_seconds / 3, 1.0))
                if self._stop.is_set():
                    return
                nv, dv, ne, de = self.store.drain_deltas()
                if nv or dv or ne or de:
                    yield master_pb2.Heartbeat(
                        ip=self.store.ip,
                        port=self.store.port,
                        public_url=self.store.public_url,
                        new_volumes=nv,
                        deleted_volumes=dv,
                        new_ec_shards=ne,
                        deleted_ec_shards=de,
                    )
                beat_now = self._beat_now.is_set()
                if (beat_now or time.monotonic() - last_full
                        >= self.pulse_seconds):
                    # a disk-fault event forces the full beat early: the
                    # read_only/disk_health bits must reach the master
                    # before the next client write lands on the full disk
                    self._beat_now.clear()
                    last_full = time.monotonic()
                    self.update_gauges()
                    yield self._with_stats(self.store.collect_heartbeat())

        call = stub.SendHeartbeat(requests())
        self._hb_call = call
        if self._stop.is_set():  # stop() raced the call's creation
            call.cancel()
        try:
            for resp in call:
                self._on_heartbeat_response(master, resp)
                if self._stop.is_set():
                    return
        finally:
            # a stream left for a new leader (or by stop) is cancelled,
            # so its request generator ends at its next beat
            call.cancel()
            self._hb_call = None

    def _on_heartbeat_response(self, master: str, resp) -> None:
        if resp.volume_size_limit:
            self.store.volume_size_limit = resp.volume_size_limit
        # the cluster's shared background-I/O budget: scrub and other
        # background traffic drain one per-node bucket; a push of 0
        # WITHDRAWS a previously adopted budget
        self.scrubber.set_shared_rate(resp.lifecycle_rate_mbps)
        if resp.dead_node_seq and resp.dead_node_seq != self._dead_node_seq:
            # a node died since our last beat: drop every cached EC
            # holder map NOW instead of serving the dead holder out of a
            # still-fresh TTL.  The seq is recorded only AFTER the
            # invalidation succeeds
            dropped = self.invalidate_location_caches()
            self._dead_node_seq = resp.dead_node_seq
            glog.info(
                "dead-node notice seq=%d (%s): invalidated %d "
                "location cache(s)", resp.dead_node_seq,
                ",".join(resp.dead_nodes) or "?", dropped)
        if resp.leader_epoch:
            if resp.leader_epoch < self._leader_epoch:
                # a deposed leader still streaming acks: drop the stream
                # and chase the real leader
                if self.current_leader == master:
                    self.current_leader = None
                raise grpc.RpcError()
            self._leader_epoch = resp.leader_epoch
        if resp.leader_grpc and resp.leader_grpc != master:
            self.current_leader = resp.leader_grpc
            raise grpc.RpcError()  # reconnect to leader
        if resp.leader_grpc == master:
            self._acked_leader = master

    def _lookup_master(self) -> str:
        """The master the node's lookups ask: the pinned leader, else the
        one that acked its last heartbeat, else the first seed.  Port
        difference: the reference asks `current_leader or
        master_addresses[0]`, and `current_leader` is set only by a
        redirect, so a node that reached the leader as a seed asks the
        first seed, a follower or a dead master, after a failover."""
        return (self.current_leader or self._acked_leader
                or self.master_addresses[0])

    # -- remote EC shard access ------------------------------------------

    def _ec_shard_lookup(self, vid: int):
        """-> {shard_id: [(url, rack, dc), ...]} from the master (self
        excluded) — one lookup shape shared by the full-interval fetcher
        and the partial-repair client."""
        me = f"{self.ip}:{self.port}"
        master = self._lookup_master()
        resp = rpclib.master_stub(master, timeout=5).LookupEcVolume(
            master_pb2.LookupEcVolumeRequest(volume_id=vid)
        )
        locations: dict[int, list[tuple[str, str, str]]] = {}
        for e in resp.shard_id_locations:
            held = [(loc.url, loc.rack, loc.data_center)
                    for loc in e.locations if loc.url != me]
            if held:
                locations[e.shard_id] = held
        return locations

    def _make_ec_fetcher(self, vid: int):
        """FetchFn for EcVolume: resolve shard locations via the master
        through a tiered-TTL cache (found/empty/error tiers, negative
        caching — store_ec.go:223-264) and stream the interval from the
        owning peer via VolumeEcShardRead.  The returned callable also
        exposes ``locality_of(shard_id)`` so rebuild ingress counters
        label full-interval fetches by rack/dc, and ``invalidate()``,
        which drops its cached holder map."""
        from ..topology.placement import ec_source_locality
        from ..wdclient.location_cache import TieredLocationCache

        cache = TieredLocationCache(lambda: self._ec_shard_lookup(vid))
        self._register_cache(cache)
        # locality of the holder each shard was LAST actually read from
        # (a same-rack peer can be down, silently shifting the read
        # cross-rack — the ingress counters must not lie about that)
        used_locality: dict[int, str] = {}

        def fetch(shard_id: int, offset: int, length: int) -> bytes | None:
            # same-rack holders first: the fallback full fetch obeys the
            # same locality preference as partial source selection
            holders = sorted(
                cache.get().get(shard_id, []),
                key=lambda h: 0 if ec_source_locality(
                    h[1], h[2], self.store.rack,
                    self.store.data_center) == "rack" else 1)
            for url, rack, dc in holders:
                try:
                    stream = rpclib.volume_server_stub(
                        grpc_addr(url), timeout=30).VolumeEcShardRead(
                        vs.VolumeEcShardReadRequest(
                            volume_id=vid, shard_id=shard_id,
                            offset=offset, size=length,
                        )
                    )
                    data = b"".join(r.data for r in stream)
                    if len(data) == length:
                        used_locality[shard_id] = ec_source_locality(
                            rack, dc, self.store.rack,
                            self.store.data_center)
                        return data
                except grpc.RpcError:
                    continue
            if holders:
                # every cached location failed — the shard likely moved;
                # force a fresh master lookup for the next attempt
                cache.invalidate()
            return None

        def locality_of(shard_id: int) -> str:
            used = used_locality.get(shard_id)
            if used is not None:
                return used
            holders = cache.get().get(shard_id, [])
            if any(ec_source_locality(r, d, self.store.rack,
                                      self.store.data_center) == "rack"
                   for _u, r, d in holders):
                return "rack"
            return "dc"

        fetch.locality_of = locality_of
        # a rebuild drops the cached holder map before it probes sources
        # (Store.rebuild_ec_shards): an empty map negative-cached by an
        # earlier degraded read must not hide a holder that mounted since
        fetch.invalidate = cache.invalidate
        return fetch

    def _grpc_locate(self, vid: int):
        """locate() for partial clients: the master's shard->holders map
        with every holder rewritten to its grpc address."""

        def locate():
            return {
                sid: [(grpc_addr(url), rack, dc)
                      for url, rack, dc in holders]
                for sid, holders in self._ec_shard_lookup(vid).items()
            }

        return locate

    def _make_partial_client(self, vid: int):
        """PartialRepairClient for rebuilds/degraded reads on this node,
        or None when the protocol is disabled
        (SEAWEEDFS_TPU_EC_PARTIAL=0)."""
        from ..storage.ec.partial import PartialRepairClient

        if not partial_enabled():
            return None
        client = PartialRepairClient(
            vid, "", self._grpc_locate(vid),
            lambda addr: rpclib.volume_server_stub(addr, timeout=30),
            my_rack=self.store.rack, my_dc=self.store.data_center)
        self._register_cache(client._cache)
        return client

    def _register_cache(self, cache) -> None:
        with self._loc_caches_lock:
            self._loc_caches.add(cache)

    def invalidate_location_caches(self) -> int:
        """Drop every live EC holder-location cache (fetchers + partial
        clients); -> how many were invalidated."""
        with self._loc_caches_lock:
            caches = list(self._loc_caches)
        for c in caches:
            c.invalidate()
        return len(caches)

    # -- mass repair (batch rebuild target) -------------------------------

    def _ensure_ec_index(self, vid: int, collection: str) -> str:
        """Base path ready for a rebuild on this node: when we hold no
        piece of the volume yet (a spread mass-repair target), pull
        .ecx/.ecj/.vif from a surviving holder first — rebuilt shards
        without the index could never serve a read."""
        base = self.store.ec_base_for_rebuild(vid, collection)
        if os.path.exists(base + ".ecx"):
            return base
        peers: list[str] = []
        for _sid, holders in sorted(self._ec_shard_lookup(vid).items()):
            for url, _rack, _dc in holders:
                addr = grpc_addr(url)
                if addr not in peers:
                    peers.append(addr)
        last_err: Exception | None = None
        for addr in peers:
            try:
                src = rpclib.volume_server_stub(addr, timeout=60)
                for ext, optional in ((".ecx", False), (".ecj", True),
                                      (".vif", True)):
                    # pull to a temp name, publish atomically: a crash
                    # mid-stream must never leave a TORN .ecx that the
                    # exists() check above would trust on the retry
                    tmp = base + ext + ".masstmp"
                    try:
                        _write_stream(tmp, src.CopyFile(
                            vs.CopyFileRequest(
                                volume_id=vid, collection=collection,
                                ext=ext, is_ec_volume=True,
                                ignore_source_file_not_found=optional)),
                            drop_empty=optional)
                    except Exception:
                        try:
                            os.remove(tmp)
                        except FileNotFoundError:
                            pass
                        raise
                    if os.path.exists(tmp):
                        os.replace(tmp, base + ext)
                return base
            except (grpc.RpcError, OSError) as e:
                last_err = e
                continue
        raise IOError(
            f"volume {vid}: no reachable holder to pull .ecx from "
            f"({last_err})")

    def mass_rebuild(self, jobs: "list[tuple[int, str, int]]",
                     codec: str = "") -> list[dict]:
        """Rebuild many volumes' globally-missing shards here, remote
        columns aggregated CROSS-VOLUME through one MassPartialSession —
        one streaming rpc per source server carries every queued
        volume's coefficient columns.  Per-volume failures (or per-volume
        fallback to full fetches) never stall the batch.

        ``jobs`` is [(volume_id, collection, shard_size_hint)], the hint
        coming from the master's heartbeat-learned sizes (0 = probe)."""
        from concurrent.futures import ThreadPoolExecutor

        from ..storage.ec.partial import (
            BatchedPartialClient,
            MassPartialSession,
        )

        partial_on = partial_enabled()
        session = MassPartialSession(
            lambda addr: rpclib.volume_server_stub(addr, timeout=60))
        workers = max(1, int(os.environ.get(
            "SEAWEEDFS_TPU_MASS_REBUILD_WORKERS", "4")))

        def one(job: "tuple[int, str, int]") -> dict:
            vid, collection, size_hint = job
            try:
                self._ensure_ec_index(vid, collection)
                client = None
                if partial_on:
                    client = BatchedPartialClient(
                        session, vid, collection, self._grpc_locate(vid),
                        lambda addr: rpclib.volume_server_stub(
                            addr, timeout=60),
                        my_rack=self.store.rack,
                        my_dc=self.store.data_center,
                        shard_size_hint=size_hint)
                    self._register_cache(client._cache)
                rebuilt = self.store.rebuild_ec_shards(
                    vid, collection, codec_name=codec or None,
                    partial=client, shard_size=size_hint or None)
                if rebuilt:
                    self.store.mount_ec_shards(vid, collection, rebuilt)
                return {"volume_id": vid, "rebuilt": rebuilt,
                        "used_partial": client is not None}
            except Exception as e:  # noqa: BLE001 — per-volume isolation
                glog.warning("mass rebuild vol=%d failed: %s", vid, e)
                return {"volume_id": vid, "error": str(e)[:300] or "failed"}

        try:
            if len(jobs) == 1:
                return [one(jobs[0])]
            with ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="mass-rebuild") as pool:
                return list(pool.map(one, jobs))
        finally:
            session.close()

    def delete_ec_needle_distributed(self, vid: int, needle_id: int) -> int:
        """Tombstone an EC needle locally, then fan VolumeEcBlobDelete out to
        every other shard-holding server so the delete survives degraded
        reads anywhere (store_ec_delete.go:15-33 + :35).  Returns the
        needle's size from the local .ecx."""
        size = self.store.delete_ec_needle(vid, needle_id)
        master = self._lookup_master()
        try:
            resp = rpclib.master_stub(master, timeout=5).LookupEcVolume(
                master_pb2.LookupEcVolumeRequest(volume_id=vid)
            )
        except grpc.RpcError:
            return size
        me = f"{self.ip}:{self.port}"
        peers = {
            loc.url
            for e in resp.shard_id_locations
            for loc in e.locations
            if loc.url != me
        }
        for url in peers:
            try:
                rpclib.volume_server_stub(
                    grpc_addr(url), timeout=10).VolumeEcBlobDelete(
                    vs.VolumeEcBlobDeleteRequest(
                        volume_id=vid, file_key=needle_id
                    )
                )
            except grpc.RpcError:
                pass
        return size

    def lookup_volume_url(self, vid: int) -> str | None:
        """Public URL of some server holding vid (for read redirects)."""
        master = self._lookup_master()
        try:
            resp = rpclib.master_stub(master, timeout=5).LookupVolume(
                master_pb2.LookupVolumeRequest(volume_or_file_ids=[str(vid)])
            )
        except grpc.RpcError:
            return None
        for entry in resp.volume_id_locations:
            for loc in entry.locations:
                return loc.public_url or loc.url
        return None

    # -- replication fan-out ---------------------------------------------

    def other_replica_locations(self, vid: int) -> list[str]:
        """Ask the master where the other replicas of vid live."""
        master = self._lookup_master()
        try:
            stub = rpclib.master_stub(master, timeout=5)
            resp = stub.LookupVolume(
                master_pb2.LookupVolumeRequest(volume_or_file_ids=[str(vid)])
            )
        except grpc.RpcError:
            return []
        out = []
        me = self.store.public_url
        for loc in resp.volume_id_locations:
            for location in loc.locations:
                if location.url not in (me, f"{self.ip}:{self.port}"):
                    out.append(location.url)
        return out

    def replicate_write(self, fid, path: str, body: bytes, headers) -> str | None:
        """Fan the write out to every other replica CONCURRENTLY on
        pooled keep-alive connections; returns the first error (in peer
        order) or None.  Write-path semantics are unchanged — any peer
        failure still fails the client's write — but the ack now waits
        max(peer RTT) instead of sum(connect + POST) per peer."""
        v = self.store.find_volume(fid.volume_id)
        if v is None or v.super_block.replica_placement.copy_count() <= 1:
            return None
        peers = self.other_replica_locations(fid.volume_id)
        if not peers:
            return None
        sep = "&" if "?" in path else "?"
        from ..telemetry import trace
        from ..util.http_util import trace_headers

        ct = headers.get("Content-Type")
        auth = headers.get("Authorization")

        def post(peer: str) -> str | None:
            url = f"http://{peer}{path}{sep}type=replicate"
            try:
                with trace.child_span("volumeServer.replicate", peer=peer):
                    # traceparent captured inside the span so the peer's
                    # span parents to the replicate hop
                    hdrs = trace_headers()
                    if ct:
                        hdrs["Content-Type"] = ct
                    if auth:  # write jwt travels with the replica fan-out
                        hdrs["Authorization"] = auth
                    with connpool.request("POST", url, body=body,
                                          headers=hdrs, timeout=10) as r:
                        r.read()
                        if r.status >= 300:
                            return f"peer {peer} status {r.status}"
            except urllib.error.HTTPError as e:
                return f"peer {peer} status {e.code}"
            except OSError as e:
                return f"peer {peer}: {e}"
            return None

        if len(peers) == 1:
            results = [post(peers[0])]
        else:
            results = list(self._replica_pool.map(
                trace.wrap_context(post), peers))
        for err in results:
            if err:
                REPLICATION_ERROR.labels("write").inc()
                return err
        return None

    def replicate_delete(self, fid, path: str, auth: str = "") -> None:
        """Best-effort tombstone fan-out.  A failed peer no longer
        disappears silently: it logs at warning and counts
        seaweedfs_replication_error_total{op="delete"} so divergent
        replicas are visible before a failover read trips over them."""
        v = self.store.find_volume(fid.volume_id)
        if v is None or v.super_block.replica_placement.copy_count() <= 1:
            return
        peers = self.other_replica_locations(fid.volume_id)
        if not peers:
            return
        sep = "&" if "?" in path else "?"
        from ..telemetry import trace
        from ..util.http_util import trace_headers

        def delete(peer: str) -> None:
            url = f"http://{peer}{path}{sep}type=replicate"
            hdrs = trace_headers()
            if auth:
                hdrs["Authorization"] = auth
            try:
                with connpool.request("DELETE", url, headers=hdrs,
                                      timeout=10) as r:
                    r.read()
            except OSError as e:  # incl. HTTPError (4xx/5xx from the peer)
                REPLICATION_ERROR.labels("delete").inc()
                glog.warning("replicate delete %s to peer %s failed: %s",
                             path, peer, e)

        if len(peers) == 1:
            delete(peers[0])
        else:
            list(self._replica_pool.map(trace.wrap_context(delete), peers))
