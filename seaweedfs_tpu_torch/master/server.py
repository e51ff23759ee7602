"""MasterServer: placement metadata owner, out of the data path.

Reference: weed/server/master_server.go.  Single-master mode this round;
the leader() hook is where raft slots in.  Includes the volume growth path
(grow -> AllocateVolume on chosen volume servers), the vacuum sweep, and a
maintenance loop that runs EC encode/rebuild/balance periodically like the
reference's [master.maintenance] script block (master_server.go:187-242).

The port's copy of seaweedfs_tpu/master/server.py: assign and growth,
lookups, location pub/sub, the liveness sweep, vacuum orchestration, the
maintenance loop (which runs the port's shell), the scrub-finding ingest
and repair pass, replication health, admin tokens, the client registry,
the maintenance plane (maintenance/: the lifecycle controller and
dead-node mass repair, built by every master as in the reference; the
liveness sweep hands each dead node to the orchestrator), the raft quorum
(master/raft.py: volume ids and the maintenance journal replicate through
the log, a deposed leader fences its control plane, a new one warms up
before it serves), the SLO engine and canary (/cluster/alerts), the
flight recorder (/cluster/debug*), the federated /cluster/metrics,
/cluster/traces and /cluster/hot, and the HTTP API.

Left out for a later slice (ROADMAP A-7): the geo registry — the
`peer_clusters` argument raises ValueError naming it, and /cluster/geo
answers 501.  `stop()` joins every thread `start()`
started (the reference leaves daemon threads).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from ..util.httpd import FrameworkHTTPServer

import grpc

from ..pb import master_pb2
from ..pb import rpc as rpclib
from ..pb import volume_server_pb2 as vs
from ..stats.metrics import serve_metrics
from ..telemetry import http_request, record_op, serve_debug_http
from ..storage.replica_placement import ReplicaPlacement
from ..util import glog
from ..topology.placement import Candidate, pick_nodes_for_write
from ..topology.topology import Topology
from ..topology.volume_layout import VolumeLayout
from .grpc_handlers import MasterGrpcService
from .sequence import make_sequencer

GRPC_PORT_OFFSET = 10000


class _Unrepairable(Exception):
    """A scrub finding with no repair path (no healthy replica, node
    gone): parked as `unrepairable` instead of burning retry attempts."""


class MasterServer:
    def __init__(
        self,
        ip: str = "127.0.0.1",
        port: int = 9333,
        volume_size_limit_mb: int = 30 * 1024,
        default_replication: str = "000",
        pulse_seconds: float = 3.0,
        sequencer: str = "memory",
        sequencer_node_id: int = 0,  # snowflake worker id
        sequencer_etcd_urls: str = "127.0.0.1:2379",
        garbage_threshold: float = 0.3,
        maintenance_interval: float = 0.0,  # seconds; 0 disables
        maintenance_script: list[str] | None = None,  # None = default suite
        metrics_port: int = 0,
        jwt_signing_key: bytes | str = b"",
        peers: list[str] | None = None,  # master quorum (ip:port HTTP addrs)
        raft_state_dir: str = "",
        lifecycle_interval: float = 0.0,  # seconds; 0 = manual only
        lifecycle_dir: str = "",          # journal dir; "" = memory only
        lifecycle_rate_mbps: float | None = None,  # None = env, 0 = off
        lifecycle_policy: dict | None = None,
        repair_deadline_s: float | None = None,  # None = env, 0 = no bound
        peer_clusters: list[str] | None = None,  # remote master http addrs
        slo_interval: float = 0.0,    # SLO evaluation tick; 0 = on demand
        slo_specs: list | None = None,  # None = default_specs()
        slo_window_scale: float | None = None,  # None = env, 1.0 = real-time
        canary_interval: float = 0.0,  # black-box probe tick; 0 disables
        canary_s3: str = "",           # S3 gateway addr for metadata probes
        alert_webhook: str = "",       # POST alert transitions here
        debug_dir: str = "",           # flight-recorder bundle directory
    ):
        self.ip = ip
        self.port = port
        self.grpc_port = port + GRPC_PORT_OFFSET
        self.topo = Topology(
            volume_size_limit=volume_size_limit_mb * (1 << 20),
            pulse_seconds=pulse_seconds,
        )
        self.default_replication = default_replication
        self.garbage_threshold = garbage_threshold
        self.maintenance_interval = maintenance_interval
        self.maintenance_script = maintenance_script
        self.sequencer = make_sequencer(
            sequencer, sequencer_node_id,
            etcd_endpoint=sequencer_etcd_urls.split(",")[0])
        self.layouts: dict[tuple[str, str, str], VolumeLayout] = {}
        self._layout_lock = threading.RLock()
        self._subscribers: list = []
        self._sub_lock = threading.Lock()
        self._admin_locks: dict[str, int] = {}
        self._admin_lock_mutex = threading.Lock()
        self._grow_locks: dict[tuple, threading.Lock] = {}
        self._grow_locks_guard = threading.Lock()
        self._stop = threading.Event()
        self._grpc_server = None
        self._httpd = None
        self._metricsd = None
        self.metrics_port = metrics_port
        # observability plane: registered non-volume clients (filers via
        # KeepConnected), last-heartbeat stats snapshots per instance,
        # and the bounded fan-out pool /cluster/{metrics,traces} scrape on
        self.clients: dict[str, dict] = {}
        self._clients_lock = threading.Lock()
        self.stats_snapshots: dict[str, dict] = {}
        self._snapshots_lock = threading.Lock()
        # self-healing plane: corruption findings from volume-server scrub
        # daemons (heartbeat field 18), keyed for idempotent re-reports;
        # the maintenance loop's repair pass drains them
        self.scrub_findings: dict[tuple, dict] = {}
        self._scrub_lock = threading.Lock()
        # serializes repair passes (maintenance loop vs /vol/repair): a
        # concurrent pass would VolumeUnmount mid-VolumeCopy
        self._repair_mutex = threading.Lock()
        # vids the scrub repair pass is healing RIGHT NOW — the mass
        # repair orchestrator skips them (and the pass skips volumes
        # with an active mass_repair journal job: one repairer at a
        # time).  Claims on BOTH sides happen under _repair_claim_lock:
        # the pass registers its volume set and snapshots the journal
        # atomically, and the orchestrator journals its jobs while
        # reading this set — without the shared lock a death arriving
        # mid-pass could interleave check-then-act on the same volume
        self._scrub_repairing: set[int] = set()
        self._repair_claim_lock = threading.Lock()
        # dead-node announcements for the heartbeat ack: volume servers
        # seeing a newer seq drop their EC holder-location caches NOW
        self.dead_node_seq = 0
        self.recent_dead_nodes: list[str] = []
        self.jwt_signing_key = (
            jwt_signing_key.encode() if isinstance(jwt_signing_key, str)
            else jwt_signing_key
        )
        if peer_clusters:
            # never silently ignored: a deployment that asks for geo links
            # must not run without them
            raise ValueError(f"peer_clusters={peer_clusters!r}: the geo "
                             "registry (replication/geo.py), ROADMAP A-7, "
                             "is not ported yet; leave it at its default")
        from ..util.executors import MeteredThreadPoolExecutor

        self.federation_pool = MeteredThreadPoolExecutor(
            max_workers=8, name="federation",
            thread_name_prefix="master-federation")
        # the maintenance plane: policy-driven seal -> EC-encode -> tier
        # -> vacuum -> rebalance with a crash-safe job journal, built even
        # when the periodic loop is off (interval 0) so /cluster/lifecycle
        # and volume.lifecycle work; and dead-node mass repair, riding the
        # same journal, triggered from the liveness sweep and executed as
        # one batched rebuild rpc per target
        from ..maintenance import (LifecycleController,
                                   MassRepairOrchestrator, PolicySet)

        self.lifecycle = LifecycleController(
            self,
            policies=(PolicySet.parse(lifecycle_policy)
                      if lifecycle_policy is not None else None),
            interval_s=lifecycle_interval,
            rate_mbps=lifecycle_rate_mbps,
            journal_dir=lifecycle_dir,
        )
        self.mass_repair = MassRepairOrchestrator(
            self, self.lifecycle, deadline_s=repair_deadline_s)
        # judgment plane: the SLO engine evaluates burn-rate rules over
        # family-filtered federation scrapes; the canary prober feeds it
        # active black-box SLIs.  Both are constructed unconditionally so
        # /cluster/alerts and the shell work on a manually driven master
        # (engine interval 0 = evaluate-on-read; canary interval 0 =
        # disabled).
        from ..stats.metrics import REGISTRY as _registry
        from ..telemetry.canary import CanaryProber
        from ..telemetry.slo import SloEngine, WebhookSink, log_sink

        from . import observability as _obs

        # flight recorder: alert-triggered cluster debug bundles.
        # Constructed before the SLO engine so a transition to firing
        # captures a bundle through its sink; manual captures run via
        # /cluster/debug/capture and the cluster.debug shell command
        from .flight import FlightRecorder

        self.flight = FlightRecorder(self, debug_dir=debug_dir)
        sinks = [log_sink, self.flight.sink]
        if alert_webhook:
            sinks.append(WebhookSink(alert_webhook))
        self.slo = SloEngine(
            scrape=lambda fams: _obs.cluster_metrics(self, fams),
            specs=slo_specs,
            sinks=sinks,
            interval_s=slo_interval,
            exemplars=_registry.exemplars,
            window_scale=slo_window_scale,
        )
        self.canary = CanaryProber(
            self, interval_s=canary_interval, s3_address=canary_s3)
        self._rng = random.Random()
        # raft quorum (raft_server.go:21-46): multi-master when peers given
        self.raft = None
        addr = f"{ip}:{port}"
        peer_list = [p.strip() for p in (peers or []) if p.strip()]
        if peer_list:
            if addr not in peer_list:
                # silently falling back to single-master here would give
                # every quorum member is_leader()=True -> split brain
                raise ValueError(
                    f"this master {addr!r} is not in -peers {peer_list}; "
                    "include its own ip:port in the quorum list"
                )
            if len(peer_list) > 1:
                from .raft import RaftNode

                state_path = (
                    f"{raft_state_dir}/raft-{port}.json"
                    if raft_state_dir else ""
                )
                self.raft = RaftNode(
                    addr, peer_list, self._raft_send,
                    apply_fn=self._raft_apply, state_path=state_path,
                )
        # leader-fenced control plane: the warm-up barrier holds assigns
        # and repair planning on a freshly elected leader until the
        # committed log tail is applied and a heartbeat cycle has been
        # seen; role transitions fence the deposed side.
        self._warmed = threading.Event()
        self._beat_count = 0  # full-state heartbeats processed as leader
        if self.raft is None:
            self._warmed.set()  # single master: always warm
        else:
            self.raft.on_role_change = self._on_role_change
            # lifecycle + mass-repair journal records replicate through
            # the raft log; every quorum member mirrors the job set
            self.lifecycle.journal.proposer = self._journal_propose
        self._threads: list[threading.Thread] = []

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._grpc_server = rpclib.serve(
            [(rpclib.MASTER, MasterGrpcService(self))], self.grpc_port,
            thread_name_prefix="master-grpc",
        )
        self._httpd = _serve_http(self, "0.0.0.0", self.port)
        if self.metrics_port:
            self._metricsd = serve_metrics(self.metrics_port)
        # flight-recorder plane: always-on low-hz stack sampler feeding
        # /debug/profile/history (kill-switch + hz env knobs respected)
        from ..util import profiler as _profiler

        _profiler.ensure_continuous()
        loops = [("master-liveness", self._liveness_loop)]
        if self.maintenance_interval > 0:
            loops.append(("master-maintenance", self._maintenance_loop))
        for name, fn in loops:
            th = threading.Thread(target=fn, name=name, daemon=True)
            th.start()
            self._threads.append(th)
        self.lifecycle.start()
        self.slo.start()
        self.canary.start()
        if self.is_leader():
            # journaled mass-repair jobs interrupted by a crash replay
            # as pending: resume them exactly once from the journal
            self.mass_repair.resume()
        if self.raft is not None:
            self.raft.start()
        glog.info("master started http=%d grpc=%d peers=%d",
                  self.port, self.grpc_port,
                  len(self.raft.peers) + 1 if self.raft else 1)

    def stop(self) -> None:
        """Stop serving and join every thread start() started: the
        liveness and maintenance loops, the canary and the SLO engine,
        the flight recorder's captures, the lifecycle controller's loop,
        workers and emergency runners, the mass-repair runner and its
        evacuations, the raft node's loops, callbacks and rpc pool, the
        federation pool, the HTTP front ends and the gRPC server's
        workers.  A job or run in progress finishes its current rpc
        first."""
        self._stop.set()
        self.canary.stop()
        self.slo.stop()
        self.mass_repair.stop()
        self.lifecycle.stop()
        if self.raft is not None:
            self.raft.stop()
        self.flight.stop()
        for srv in (self._httpd, self._metricsd):
            if srv is not None:
                srv.shutdown()
                srv.server_close()
                srv.serve_thread.join(timeout=10.0)
        if self._grpc_server:
            self._grpc_server.stop(grace=0.5).wait()
            # streams end with the server; then its workers are idle
            self._grpc_server.pool.shutdown(wait=True)
        self.federation_pool.shutdown(wait=True, cancel_futures=True)
        for th in self._threads:
            th.join(timeout=30.0)
        self._threads = []
        rpclib.close_channels(f"{self.ip}:{self.grpc_port}")

    # -- raft plumbing ----------------------------------------------------

    def _raft_sig(self, payload: bytes) -> str:
        import hashlib
        import hmac

        return hmac.new(
            self.jwt_signing_key, payload, hashlib.sha256
        ).hexdigest()

    def _raft_send(self, peer: str, msg: dict) -> dict | None:
        from ..util import connpool

        payload = json.dumps(msg).encode()
        headers = {"Content-Type": "application/json"}
        if self.jwt_signing_key:
            # consensus messages forge cluster state; sign them with the
            # same shared secret that protects writes (security/jwt.go)
            headers["X-Raft-Signature"] = self._raft_sig(payload)
        with connpool.request(
                "POST", f"http://{peer}/cluster/raft", body=payload,
                headers=headers, timeout=1.0) as r:
            return json.loads(r.read())

    def verify_raft_request(self, payload: bytes, signature: str) -> bool:
        import hmac

        if not self.jwt_signing_key:
            return True
        return hmac.compare_digest(self._raft_sig(payload), signature or "")

    def _raft_apply(self, cmd: dict):
        """State machine: the reference's MaxVolumeIdCommand analogue.

        "inc_vid" computes the new id HERE (in log order, identically on
        every replica) — a fresh leader first applies the old leader's
        tail, so it can never re-issue an id committed before failover."""
        op = cmd.get("op")
        if op == "inc_vid":
            with self.topo.lock:
                self.topo.max_volume_id += 1
                return self.topo.max_volume_id
        if op == "max_vid":  # older persisted logs
            with self.topo.lock:
                self.topo.max_volume_id = max(
                    self.topo.max_volume_id, int(cmd["value"])
                )
                return self.topo.max_volume_id
        if op == "journal":  # lifecycle/mass-repair job record mirror
            self.lifecycle.journal.apply_replicated(cmd["rec"])
            return True
        if op == "journal_drop":
            self.lifecycle.journal.apply_drop(cmd["key"])
            return True
        if op == "barrier":  # warm-up: committing this proves the new
            return True      # leader has applied every prior entry
        return None

    def _journal_propose(self, op: str, payload: dict) -> bool:
        """JobJournal proposer: replicate one journal mutation through
        raft; False (-> the journal raises) when not the leader or the
        quorum is unreachable."""
        if op == "drop":
            return self.raft.propose(
                {"op": "journal_drop", "key": payload["key"]})
        return self.raft.propose({"op": "journal", "rec": payload})

    def _on_role_change(self, role: str, term: int) -> None:
        """Raft leadership transition (fires from a raft callback thread).

        Deposed: fence the whole control plane NOW — cancel lifecycle
        executor queues and running mass-repair waves so this master
        stops racing the new leader (its in-flight rpcs are additionally
        rejected volume-server-side by epoch).

        Elected: warm-up barrier before serving — (1) commit a barrier
        entry, which proves the old leader's committed tail (journal
        records, vid increments) is applied here; (2) wait for one
        heartbeat cycle (bounded) so assigns see real topology; then
        resume journaled jobs exactly-once."""
        if role != "leader":
            self._warmed.clear()
            self.lifecycle.fence(term)
            self.mass_repair.fence(term)
            glog.warning("master %s:%d deposed at term %d — "
                         "control plane fenced", self.ip, self.port, term)
            return
        self._warmed.clear()
        beats0 = self._beat_count
        if not self.raft.propose({"op": "barrier"}, timeout=10.0):
            glog.warning("master %s:%d elected at term %d but barrier "
                         "did not commit (deposed again?)",
                         self.ip, self.port, term)
            return
        grace = float(os.environ.get("SEAWEEDFS_TPU_WARMUP_GRACE_S", "2.0"))
        deadline = time.monotonic() + grace
        while (time.monotonic() < deadline
               and self._beat_count == beats0
               and self.raft.is_leader()
               and not self._stop.is_set()):
            time.sleep(0.05)
        if not self.raft.is_leader() or self._stop.is_set():
            return
        resumed = self.lifecycle.journal.resume_stale_running()
        self._warmed.set()
        glog.info("master %s:%d warmed up at term %d (resumed=%d)",
                  self.ip, self.port, term, resumed)
        # journaled jobs inherited from the deposed leader restart
        # exactly-once: the replicated journal is the dedup memory
        self.mass_repair.resume()

    def control_warmed(self) -> bool:
        """True once this master may hand out fids / plan repairs: not
        mid-failover-warm-up (always true without raft)."""
        return self._warmed.is_set()

    def leader_epoch(self) -> int:
        """The fencing epoch stamped on every leader->volume-server
        mutating rpc; 0 without raft (fencing off, single master)."""
        return self.raft.leader_epoch() if self.raft is not None else 0

    def is_leader(self) -> bool:
        return self.raft is None or self.raft.is_leader()

    def next_volume_id(self) -> int:
        """Allocate a volume id; in quorum mode the increment commits
        through raft before use (topology/cluster_commands.go)."""
        if self.raft is None:
            return self.topo.next_volume_id()
        ok, vid = self.raft.propose_and_get({"op": "inc_vid"})
        if not ok or vid is None:
            raise RuntimeError("not the leader or quorum unavailable")
        return int(vid)

    def leader(self) -> str:
        if self.raft is not None and self.raft.leader_id:
            return self.raft.leader_id
        return f"{self.ip}:{self.port}"

    def leader_grpc(self) -> str:
        host, _, port = self.leader().partition(":")
        return f"{host}:{int(port) + GRPC_PORT_OFFSET}"

    # -- layouts ----------------------------------------------------------

    def delete_collection(self, name: str) -> None:
        """Delete a collection everywhere: fan out DeleteCollection to the
        volume servers AND purge the master's own layouts, so a later
        assign to the same collection name starts from scratch instead of
        picking a deleted vid out of a stale writable set
        (master_grpc_server_collection.go)."""
        with self.topo.lock:
            nodes = list(self.topo.nodes.values())
        for n in nodes:
            try:
                rpclib.volume_server_stub(
                    n.grpc_address, timeout=30
                ).DeleteCollection(
                    vs.DeleteCollectionRequest(collection=name))
            except grpc.RpcError:
                pass
        with self._layout_lock:
            for key in [k for k in self.layouts if k[0] == name]:
                del self.layouts[key]
        with self._grow_locks_guard:
            for key in [k for k in self._grow_locks if k[0] == name]:
                del self._grow_locks[key]

    def get_layout(self, collection: str, replication: str, ttl: str) -> VolumeLayout:
        replication = replication or self.default_replication
        key = (collection, replication, ttl)
        with self._layout_lock:
            layout = self.layouts.get(key)
            if layout is None:
                layout = VolumeLayout(
                    ReplicaPlacement.parse(replication),
                    ttl,
                    self.topo.volume_size_limit,
                )
                self.layouts[key] = layout
            return layout

    def unregister_from_layouts(self, vids, node_id: str) -> None:
        with self._layout_lock:
            for layout in self.layouts.values():
                for vid in vids:
                    layout.unregister(vid, node_id)

    def rebuild_layouts(self, node) -> None:
        """Re-register a node's volumes into their layouts."""
        with self.topo.lock:
            volumes = list(node.volumes.values())
        for v in volumes:
            rp = ReplicaPlacement.from_byte(v.replica_placement)
            from ..storage.ttl import TTL

            layout = self.get_layout(
                v.collection, str(rp), str(TTL.from_uint32(v.ttl))
            )
            layout.register(v.volume_id, node.id, v.size, v.read_only)
            layout.set_oversized(v.volume_id, v.size)

    # -- assign -----------------------------------------------------------

    def sign_fid(self, fid: str) -> str:
        """Write JWT for an assigned fid (security/jwt.go GenJwt); empty
        when the cluster runs without a signing key."""
        if not self.jwt_signing_key:
            return ""
        from ..security.jwt import gen_write_jwt

        return gen_write_jwt(self.jwt_signing_key, fid)

    def assign(self, count: int, collection: str, replication: str,
               ttl: str, data_center: str = "", rack: str = "") -> tuple[str, str, str, int]:
        # instrumented HERE (not in the HTTP layer) so gRPC Assign and
        # /dir/assign both land in the same ("master","assign") series,
        # now with a latency histogram + span instead of counter-only
        with record_op("master", "assign", collection=collection):
            return self._assign(count, collection, replication, ttl,
                                data_center, rack)

    def _assign(self, count: int, collection: str, replication: str,
                ttl: str, data_center: str = "", rack: str = "") -> tuple[str, str, str, int]:
        # warm-up barrier: a freshly elected leader must not hand out
        # fids until the deposed leader's committed tail is applied and a
        # heartbeat cycle has refreshed topology — close the fid-reuse
        # window by BLOCKING briefly (clients see a slow assign during
        # failover, never a 5xx)
        if not self._warmed.wait(timeout=15.0):
            raise RuntimeError("control plane warming up after failover")
        layout = self.get_layout(collection, replication, ttl)
        try:
            vid, node_ids = layout.pick_for_write()
        except LookupError:
            # serialize growth PER LAYOUT and re-check inside the lock: a
            # burst of first assigns to a new collection would otherwise
            # each grow their own batch (observed: 5 concurrent growths
            # allocating 15 volumes where 3 suffice), while a stalled
            # grow for one collection must not block assigns elsewhere
            key = (collection, replication or self.default_replication, ttl)
            with self._grow_locks_guard:
                grow_lock = self._grow_locks.setdefault(
                    key, threading.Lock())
            with grow_lock:
                try:
                    vid, node_ids = layout.pick_for_write()
                except LookupError:
                    self.grow_volumes(
                        collection,
                        replication or self.default_replication,
                        ttl, data_center, rack)
                    vid, node_ids = layout.pick_for_write()
        key = self.sequencer.next_file_id(count)
        cookie = self._rng.randrange(0, 2**32)
        fid = f"{vid},{key:x}{cookie:08x}"
        node = self.topo.nodes.get(node_ids[0])
        url = node.id if node else node_ids[0]
        public_url = node.public_url if node else node_ids[0]
        return fid, url, public_url, count

    def grow_volumes(self, collection: str, replication: str, ttl: str,
                     data_center: str = "", rack: str = "",
                     target_count: int | None = None) -> list[int]:
        """VolumeGrowth: pick nodes per placement, AllocateVolume on each."""
        rp = ReplicaPlacement.parse(replication)
        # grow several volumes for write concurrency, like the reference's
        # automatic growth defaults (volume_growth.go)
        n_grow = target_count or max(1, 7 // rp.copy_count() // 2)
        glog.info("growing %d volume(s) collection=%r replication=%s",
                  n_grow, collection, replication)
        grown: list[int] = []
        for _ in range(n_grow):
            with self.topo.lock:
                candidates = [
                    Candidate(n.id, n.data_center, n.rack, n.free_slots())
                    for n in self.topo.nodes.values()
                ]
            try:
                picked = pick_nodes_for_write(
                    candidates, rp, data_center, rack,
                    rng=random.Random(self._rng.random()),
                )
            except ValueError:
                if grown:
                    break
                raise
            vid = self.next_volume_id()
            ok = True
            for c in picked:
                node = self.topo.nodes[c.node_id]
                try:
                    rpclib.volume_server_stub(node.grpc_address, timeout=30).AllocateVolume(
                        vs.AllocateVolumeRequest(
                            volume_id=vid,
                            collection=collection,
                            replication=replication,
                            ttl=ttl,
                        )
                    )
                except grpc.RpcError:
                    ok = False
                    break
            if ok:
                layout = self.get_layout(collection, replication, ttl)
                for c in picked:
                    layout.register(vid, c.node_id, 0, False)
                grown.append(vid)
        return grown

    def lookup_volume_locations(self, vid: int) -> list[tuple[str, str]]:
        """-> [(url, public_url)]: layouts first (fresh growth), then the
        topology (heartbeat state), then EC shard holders."""
        node_ids: list[str] = []
        with self._layout_lock:
            for layout in self.layouts.values():
                if vid in layout.locations:
                    node_ids = list(layout.locations[vid])
                    break
        out = []
        with self.topo.lock:
            if not node_ids:
                node_ids = [
                    n.id for n in self.topo.nodes.values() if vid in n.volumes
                ]
            for nid in node_ids:
                n = self.topo.nodes.get(nid)
                out.append((nid, n.public_url if n else nid))
        if not out:
            seen = {}
            for ns in self.topo.lookup_ec_shards(vid).values():
                for n in ns:
                    seen[n.id] = n.public_url
            out = sorted(seen.items())
        return out

    # -- pub/sub ----------------------------------------------------------

    def subscribe(self, q) -> None:
        with self._sub_lock:
            self._subscribers.append(q)

    def unsubscribe(self, q) -> None:
        with self._sub_lock:
            if q in self._subscribers:
                self._subscribers.remove(q)

    def broadcast_location(self, node, new_vids, deleted_vids) -> None:
        loc = master_pb2.VolumeLocation(
            url=node.id,
            public_url=node.public_url,
            new_vids=sorted(set(new_vids)),
            deleted_vids=sorted(set(deleted_vids)),
            leader=self.leader(),
            data_center=node.data_center,
        )
        with self._sub_lock:
            for q in self._subscribers:
                q.put(loc)

    # -- liveness ---------------------------------------------------------

    def _liveness_loop(self) -> None:
        while not self._stop.wait(self.topo.pulse_seconds):
            for node_id in self.topo.collect_dead_nodes():
                vids = self.topo.unregister_node(node_id)
                self.unregister_from_layouts(vids, node_id)
                self.note_dead_node(node_id)
                if self.is_leader():
                    # plan AFTER the node left the topology, so the
                    # orchestrator ranks exactly the post-death shard map
                    self.mass_repair.on_node_dead(node_id)
            if self.is_leader():
                self.mass_repair.tick()

    def note_dead_node(self, node_id: str) -> None:
        """Bump the dead-node sequence the heartbeat ack carries; volume
        servers seeing a newer seq invalidate their EC holder-location
        caches eagerly (the first post-death rebuild must not plan
        against the dead holder)."""
        self.dead_node_seq += 1
        self.recent_dead_nodes = (self.recent_dead_nodes + [node_id])[-8:]
        glog.warning("node %s presumed dead (seq %d)", node_id,
                     self.dead_node_seq)

    def note_disk_health(self, node) -> None:
        """Heartbeat-ingest hook for the disk-fault plane: a low-space
        or full disk gets the lifecycle plane's emergency vacuum; a
        failing disk becomes a proactive-evacuation trigger for the
        mass-repair orchestrator (drain it before it dies)."""
        worst = node.worst_disk_state()
        if worst in ("low_space", "full"):
            try:
                self.lifecycle.note_low_space(node.id)
            except Exception as e:  # noqa: BLE001 — never fail the beat
                glog.warning("low-space reaction for %s failed: %s",
                             node.id, e)
        if worst == "failing" and self.is_leader():
            try:
                self.mass_repair.on_disk_failing(node.id)
            except Exception as e:  # noqa: BLE001
                glog.warning("evacuation trigger for %s failed: %s",
                             node.id, e)

    def note_topology_change(self, node_id: str) -> None:
        """A node JOINED (first heartbeat, incl. a rejoin after a
        death): same cache-invalidation broadcast as a death, because a
        peer's found-tier holder cache trusting the node-less map for
        its full TTL makes degraded reads fail for minutes after the
        holder is back."""
        self.dead_node_seq += 1
        glog.info("node %s joined (cache-invalidation seq %d)", node_id,
                  self.dead_node_seq)

    # -- vacuum -----------------------------------------------------------

    def vacuum(self, threshold: float | None = None) -> list[int]:
        """Leader-driven Check -> Compact -> Commit over gRPC."""
        threshold = threshold or self.garbage_threshold
        vacuumed = []
        with self.topo.lock:
            vids = sorted({vid for n in self.topo.nodes.values()
                           for vid in n.volumes})
        for vid in vids:
            if self.vacuum_volume(vid, threshold):
                vacuumed.append(vid)
        return vacuumed

    def vacuum_volume(self, vid: int,
                      threshold: float | None = None,
                      force: bool = False) -> bool:
        """Check -> Compact -> Commit one volume on every holder (the
        lifecycle controller's vacuum jobs call this directly); a failed
        phase rolls back with VacuumVolumeCleanup.  Returns True when
        the volume was compacted.

        `force=True` (the disk-fault plane's emergency vacuum) includes
        read-only volumes: a read-only-FULL volume is exactly the one
        that needs its garbage compacted away.  The volume server still
        refuses remote-tiered / mid-tier volumes, so the tier race the
        normal exemption guards against stays impossible."""
        threshold = threshold or self.garbage_threshold
        with self.topo.lock:
            nodes = [n for n in self.topo.nodes.values()
                     if vid in n.volumes]
            # sealed (read-only) volumes are exempt, like the
            # reference's vacuum: they are EC-encode/tier candidates,
            # and a compact commit racing a lifecycle tier upload would
            # swap the .dat mid-transfer
            if not force and any(n.volumes[vid].read_only for n in nodes):
                return False
        if not nodes:
            return False
        try:
            epoch = self.leader_epoch()
            ratios = [
                rpclib.volume_server_stub(n.grpc_address, timeout=30)
                .VacuumVolumeCheck(vs.VacuumVolumeCheckRequest(
                    volume_id=vid, leader_epoch=epoch))
                .garbage_ratio
                for n in nodes
            ]
            if not ratios or min(ratios) < threshold:
                return False
            for n in nodes:
                rpclib.volume_server_stub(n.grpc_address, timeout=600).VacuumVolumeCompact(
                    vs.VacuumVolumeCompactRequest(
                        volume_id=vid, leader_epoch=epoch)
                )
            for n in nodes:
                rpclib.volume_server_stub(n.grpc_address, timeout=600).VacuumVolumeCommit(
                    vs.VacuumVolumeCommitRequest(
                        volume_id=vid, leader_epoch=epoch)
                )
            return True
        except grpc.RpcError:
            for n in nodes:
                try:
                    rpclib.volume_server_stub(n.grpc_address, timeout=30).VacuumVolumeCleanup(
                        vs.VacuumVolumeCleanupRequest(
                            volume_id=vid,
                            leader_epoch=self.leader_epoch())
                    )
                except grpc.RpcError:
                    pass
            return False

    # -- maintenance loop (ec.encode/rebuild/balance automation) ----------

    def _maintenance_loop(self) -> None:
        from ..shell.commands import CommandEnv, run_maintenance

        while not self._stop.wait(self.maintenance_interval):
            try:
                # self-healing first: corruption findings queued by scrub
                # daemons turn into re-copies/rebuilds before the heavier
                # encode/balance script runs
                self.repair_pass()
            except Exception as e:
                glog.warning("repair pass failed: %s", e)
            try:
                env = CommandEnv(f"{self.ip}:{self.grpc_port}")
                for line in run_maintenance(env,
                                            script=self.maintenance_script):
                    if glog.V(1):
                        glog.info("maintenance: %s", line)
            except Exception as e:  # the loop must survive, not go mute
                glog.warning("maintenance run failed: %s", e)

    # -- self-healing: scrub finding ingest + repair orchestration --------

    MAX_SCRUB_FINDINGS = 1024
    MAX_REPAIR_ATTEMPTS = 3

    def record_scrub_findings(self, node_id: str, findings) -> None:
        """Heartbeat ingest: keep findings keyed so a node re-reporting
        persistent corruption updates in place instead of piling up."""
        with self._scrub_lock:
            for f in findings:
                key = (node_id, f.volume_id, f.kind, f.shard_id, f.needle_id)
                cur = self.scrub_findings.get(key)
                if cur is not None:
                    cur["last_reported_ms"] = f.detected_at_ms
                    continue
                if len(self.scrub_findings) >= self.MAX_SCRUB_FINDINGS:
                    # one rotten disk can report thousands of needles;
                    # the repair (one volume re-copy) fixes them all, so
                    # dropping the tail loses nothing actionable
                    continue
                self.scrub_findings[key] = {
                    "node": node_id, "volume_id": f.volume_id,
                    "kind": f.kind, "shard_id": f.shard_id,
                    "needle_id": f.needle_id, "detail": f.detail,
                    "detected_at_ms": f.detected_at_ms,
                    "last_reported_ms": f.detected_at_ms,
                    "attempts": 0, "status": "pending",
                }

    def scrub_findings_snapshot(self) -> list[dict]:
        with self._scrub_lock:
            return [dict(v) for v in self.scrub_findings.values()]

    def repair_pass(self) -> dict:
        """Turn queued scrub findings into repairs: a corrupt replica is
        re-copied from a healthy peer (VolumeCopy), a corrupt EC shard is
        deleted and rebuilt in place (VolumeEcShardsRebuild) then
        remounted.  Also refreshes the under-replication gauge."""
        summary = {"repaired": [], "failed": [], "skipped": []}
        if not self.is_leader():
            return summary
        if not self._repair_mutex.acquire(blocking=False):
            return summary  # a pass is already running (loop vs /vol/repair)
        try:
            return self._repair_pass_locked(summary)
        finally:
            # conservative: vids stay claimed for the whole pass, so the
            # mass-repair planner can never start on a volume this pass
            # is mid-VolumeCopy on
            with self._repair_claim_lock:
                self._scrub_repairing.clear()
            self._repair_mutex.release()

    def _mass_repair_active_vids(self) -> set[int]:
        """Volumes with an active mass_repair journal job: the scrub
        repair pass leaves them to the orchestrator (and vice versa —
        one repairer per volume, never a double rebuild)."""
        from ..maintenance.mass_repair import TRANSITION

        return {j["volume_id"] for j in self.lifecycle.journal.active()
                if j.get("transition") == TRANSITION}

    def _repair_pass_locked(self, summary: dict) -> dict:
        from ..stats.metrics import SCRUB_REPAIRS

        with self._scrub_lock:
            work = [(k, dict(v)) for k, v in self.scrub_findings.items()
                    if v["status"] in ("pending", "failed")
                    and v["attempts"] < self.MAX_REPAIR_ATTEMPTS]
        # claim EVERY volume this pass intends to touch UP FRONT and
        # snapshot the orchestrator's active jobs in the same locked
        # section: the mass-repair planner journals its jobs under this
        # lock while reading our claims, so a node death arriving
        # mid-pass can never interleave check-then-act on one volume
        with self._repair_claim_lock:
            self._scrub_repairing.update(f["volume_id"] for _k, f in work)
            mass_busy = self._mass_repair_active_vids()
        for key, f in work:
            with self._scrub_lock:
                if key not in self.scrub_findings:
                    # an earlier repair in THIS pass already healed the
                    # whole volume and dropped its sibling findings
                    continue
            if f["volume_id"] in mass_busy:
                # the mass-repair orchestrator is rebuilding this volume
                # right now; the finding stays queued and a later pass
                # re-checks it against the freshly rebuilt shards
                summary["skipped"].append(key)
                continue
            kind = f["kind"]
            repair_kind = "ec_shard" if kind == "ec_shard" else "replica"
            try:
                if kind == "ec_shard":
                    self._repair_ec_shard(f)
                else:
                    # replica + index findings both heal by re-copying the
                    # whole volume from a healthy peer
                    self._repair_replica(f)
            except _Unrepairable as e:
                with self._scrub_lock:
                    if key in self.scrub_findings:
                        self.scrub_findings[key]["status"] = "unrepairable"
                        self.scrub_findings[key]["error"] = str(e)
                summary["skipped"].append(key)
                continue
            except Exception as e:  # noqa: BLE001 — per-finding isolation
                SCRUB_REPAIRS.labels(repair_kind, "error").inc()
                with self._scrub_lock:
                    if key in self.scrub_findings:
                        self.scrub_findings[key]["attempts"] += 1
                        self.scrub_findings[key]["status"] = "failed"
                        self.scrub_findings[key]["error"] = str(e)
                glog.warning("repair of %s failed: %s", key, e)
                summary["failed"].append(key)
                continue
            SCRUB_REPAIRS.labels(repair_kind, "ok").inc()
            with self._scrub_lock:
                if kind == "ec_shard":
                    # the rebuild healed exactly this shard
                    drop = [k for k, v in self.scrub_findings.items()
                            if v["node"] == f["node"]
                            and v["volume_id"] == f["volume_id"]
                            and v["kind"] == "ec_shard"
                            and v["shard_id"] == f["shard_id"]]
                else:
                    # one volume re-copy heals EVERY queued needle/index
                    # finding on that (node, volume)
                    drop = [k for k, v in self.scrub_findings.items()
                            if v["node"] == f["node"]
                            and v["volume_id"] == f["volume_id"]
                            and v["kind"] != "ec_shard"]
                for k in drop:
                    del self.scrub_findings[k]
            glog.info("repaired %s finding on %s vol=%d",
                      kind, f["node"], f["volume_id"])
            summary["repaired"].append(key)
        self.update_replication_health()
        return summary

    def _repair_replica(self, f: dict) -> None:
        """Re-copy a corrupted replica from a healthy peer via the
        existing VolumeCopy pull protocol."""
        vid = f["volume_id"]
        with self.topo.lock:
            corrupt = self.topo.nodes.get(f["node"])
            holders = [n for n in self.topo.nodes.values()
                       if vid in n.volumes]
            collection = ""
            for n in holders:
                collection = n.volumes[vid].collection
                break
        if corrupt is None:
            raise _Unrepairable(f"node {f['node']} left the cluster")
        healthy = [n for n in holders if n.id != corrupt.id]
        if not healthy:
            raise _Unrepairable(
                f"volume {vid}: no healthy replica to copy from")
        source = healthy[0]
        stub = rpclib.volume_server_stub(corrupt.grpc_address, timeout=600)
        try:
            stub.VolumeUnmount(vs.VolumeUnmountRequest(volume_id=vid))
        except grpc.RpcError:
            pass  # already unmounted (or racing) — the copy re-mounts
        stub.VolumeCopy(vs.VolumeCopyRequest(
            volume_id=vid, collection=collection,
            source_data_node=source.grpc_address,
        ))

    def _repair_ec_shard(self, f: dict) -> None:
        """Rebuild a corrupted EC shard in place: drop the rotten .ecNN,
        decode it back from the surviving shards, remount."""
        vid, sid = f["volume_id"], f["shard_id"]
        with self.topo.lock:
            node = self.topo.nodes.get(f["node"])
            collection = (node.ec_collections.get(vid, "")
                          if node is not None else "")
        if node is None:
            raise _Unrepairable(f"node {f['node']} left the cluster")
        stub = rpclib.volume_server_stub(node.grpc_address, timeout=600)
        stub.VolumeEcShardsDelete(vs.VolumeEcShardsDeleteRequest(
            volume_id=vid, collection=collection, shard_ids=[sid]))
        rebuilt = stub.VolumeEcShardsRebuild(vs.VolumeEcShardsRebuildRequest(
            volume_id=vid, collection=collection))
        if sid not in list(rebuilt.rebuilt_shard_ids):
            raise IOError(
                f"shard {sid} not rebuilt (got {list(rebuilt.rebuilt_shard_ids)})")
        stub.VolumeEcShardsMount(vs.VolumeEcShardsMountRequest(
            volume_id=vid, collection=collection, shard_ids=[sid]))

    def update_replication_health(self) -> dict:
        """Per-volume replica health + the cluster under-replication
        gauge (seaweedfs_volume_underreplicated)."""
        from ..stats.metrics import VOLUME_UNDERREPLICATED

        health: dict[str, dict] = {}
        under = 0
        with self.topo.lock:
            holders: dict[int, list] = {}
            desired: dict[int, int] = {}
            for n in self.topo.nodes.values():
                for vid, v in n.volumes.items():
                    holders.setdefault(vid, []).append(n.id)
                    desired[vid] = ReplicaPlacement.from_byte(
                        v.replica_placement).copy_count()
        for vid, locs in holders.items():
            want = max(desired.get(vid, 1), 1)
            if len(locs) < want:
                under += 1
                health[str(vid)] = {
                    "replicas": len(locs), "desired": want,
                    "underReplicated": True, "locations": sorted(locs),
                }
        VOLUME_UNDERREPLICATED.set(under)
        self._volume_health = health
        return health

    def volume_health_snapshot(self) -> dict:
        """The /cluster/status health block: under-replicated volumes +
        outstanding scrub findings grouped per volume."""
        health = dict(getattr(self, "_volume_health", {}))
        for f in self.scrub_findings_snapshot():
            entry = health.setdefault(str(f["volume_id"]), {})
            entry.setdefault("findings", []).append({
                "node": f["node"], "kind": f["kind"],
                "shardId": f["shard_id"],
                "needleId": f"{f['needle_id']:x}",
                "status": f["status"], "attempts": f["attempts"],
                "detail": f.get("detail", ""),
            })
        return health

    # -- admin lock -------------------------------------------------------

    def lease_admin_token(self, lock_name: str, previous: int) -> int | None:
        with self._admin_lock_mutex:
            current = self._admin_locks.get(lock_name)
            if current is not None and current != previous:
                return None
            token = int(time.time_ns())
            self._admin_locks[lock_name] = token
            return token

    def release_admin_token(self, lock_name: str, token: int) -> None:
        with self._admin_lock_mutex:
            if self._admin_locks.get(lock_name) == token:
                del self._admin_locks[lock_name]

    # -- observability plane ----------------------------------------------

    MAX_STATS_SNAPSHOTS = 256

    def record_stats_snapshot(self, instance: str, node_type: str,
                              snapshot) -> None:
        """Keep a node's heartbeat stats snapshot (pb StatsSnapshot) as
        the /cluster/metrics fallback when a live scrape can't reach it.
        Survives the node leaving the topology — that is the whole point."""
        if not snapshot.samples:
            return
        with self._snapshots_lock:
            # pop-then-reinsert keeps the dict ordered by receive time,
            # so the bound evicts the stalest entry in O(1) — this runs
            # on every full heartbeat of every volume server
            self.stats_snapshots.pop(instance, None)
            self.stats_snapshots[instance] = {
                "type": node_type,
                "samples": [(s.name, s.value) for s in snapshot.samples],
                "captured_at_ms": snapshot.captured_at_ms,
                "received": time.monotonic(),
            }
            if len(self.stats_snapshots) > self.MAX_STATS_SNAPSHOTS:
                del self.stats_snapshots[next(iter(self.stats_snapshots))]

    def stats_snapshots_snapshot(self) -> dict:
        with self._snapshots_lock:
            return dict(self.stats_snapshots)

    def register_client(self, name: str, client_type: str,
                        http_address: str) -> object:
        """-> registration token.  Unregistration requires the token: a
        reconnecting client registers on its new stream BEFORE the old
        stream's handler notices the break (up to its poll interval), so
        an unconditional pop would deregister the fresh registration and
        the client would vanish from the federation plane until its next
        reconnect."""
        token = object()
        with self._clients_lock:
            self.clients[name] = {
                "type": client_type,
                "http_address": http_address,
                "last_seen": time.monotonic(),
                "token": token,
            }
        return token

    def touch_client(self, name: str) -> None:
        with self._clients_lock:
            info = self.clients.get(name)
            if info is not None:
                info["last_seen"] = time.monotonic()

    def unregister_client(self, name: str, token: object) -> None:
        with self._clients_lock:
            info = self.clients.get(name)
            if info is not None and info["token"] is token:
                del self.clients[name]

    def clients_snapshot(self) -> dict:
        with self._clients_lock:
            return {k: dict(v) for k, v in self.clients.items()}


# ---------------------------------------------------------------------------
# HTTP API (/dir/assign, /dir/lookup, /cluster/status, /vol/vacuum)
# ---------------------------------------------------------------------------


# request-metric op per path; unknown paths collapse to "other" so a
# scanner can't explode the label cardinality.  /dir/assign is absent
# on purpose: the logical ("master","assign") series inside
# MasterServer.assign() covers it (shared with the gRPC path), and a
# second middleware series for the same request would double-count
# master QPS.
_MASTER_OPS = {
    "/dir/lookup": "dir.lookup",
    "/dir/status": "cluster.status", "/cluster/status": "cluster.status",
    "/cluster/healthz": "cluster.healthz", "/stats/health": "cluster.healthz",
    "/cluster/raft": "cluster.raft",
    "/cluster/metrics": "cluster.metrics",
    "/cluster/traces": "cluster.traces",
    "/cluster/alerts": "cluster.alerts",
    "/cluster/lifecycle": "cluster.lifecycle",
    "/cluster/geo": "cluster.geo",
    "/cluster/hot": "cluster.hot",
    "/cluster/debug": "cluster.debug",
    "/cluster/debug/capture": "cluster.debug",
    "/debug/hot": "debug.hot",
    "/debug/profile/history": "debug.profile",
    "/vol/vacuum": "vol.vacuum", "/vol/grow": "vol.grow",
    "/vol/repair": "vol.repair",
    "/vol/status": "vol.status", "/col/delete": "col.delete",
    "/submit": "submit", "/debug/profile": "debug.profile",
    "/debug/traces": "debug.traces", "/metrics": "metrics",
    "/ui": "ui", "/ui/": "ui", "/ui/index.html": "ui",
}


# the master's surfaces whose planes come with a later slice: each answers
# 501 with the plane and the ROADMAP item that brings it
_LEFT_OUT_PATHS = {
    "/cluster/geo": "geo registry (replication/geo.py), ROADMAP A-7",
}


def _master_op(path: str) -> str:
    return _MASTER_OPS.get(path.split("?")[0], "other")


class _MasterHttpHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    master: MasterServer = None

    def log_message(self, fmt, *args):
        pass

    def _json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _redirect_to_leader(self) -> None:
        """307 to the leader; 503 when no leader is elected.  Drains any
        unread request body first — skipping it desyncs HTTP/1.1
        keep-alive (the next request parses the stale body as a request
        line)."""
        self._drain_body()
        leader = self.master.leader()
        if leader == f"{self.master.ip}:{self.master.port}":
            return self._json(503, {"error": "no leader elected yet"})
        self.send_response(307)
        self.send_header("Location", f"http://{leader}{self.path}")
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_DELETE(self):
        with http_request(self, "master", _master_op(self.path)):
            self._do_delete()

    def _do_delete(self):
        u = urllib.parse.urlparse(self.path)
        if u.path == "/col/delete":
            return self._col_delete(u)
        return self._json(404, {"error": f"unknown path {u.path}"})

    def _col_delete(self, u) -> None:
        # master_server_handlers_admin.go deleteFromMasterServerHandler.
        # Exactly ONE drain per request: _redirect_to_leader drains for
        # itself, so the leader/error paths drain here and the redirect
        # path must not (draining twice blocks on already-consumed bytes)
        q = urllib.parse.parse_qs(u.query)
        name = q.get("collection", [""])[0]
        if not name:
            self._drain_body()
            return self._json(400, {"error": "collection required"})
        if not self.master.is_leader():
            return self._redirect_to_leader()
        self._drain_body()  # keep-alive hygiene: params ride the query
        self.master.delete_collection(name)
        return self._json(200, {"collection": name, "deleted": True})

    def _left_out(self, path: str) -> None:
        """501 for a surface of a plane this master does not have yet."""
        self._drain_body()
        return self._json(501, {
            "error": f"{path} is not ported yet",
            "plane": _LEFT_OUT_PATHS[path],
        })

    def _drain_body(self, cap: int = 1 << 20) -> None:
        from ..util.httpd import drain_request_body

        drain_request_body(self, cap)

    def do_POST(self):
        with http_request(self, "master", _master_op(self.path)):
            self._do_post()

    def _do_post(self):
        u = urllib.parse.urlparse(self.path)
        if u.path == "/col/delete":
            return self._col_delete(u)
        if u.path in _LEFT_OUT_PATHS:
            return self._left_out(u.path)
        if u.path == "/cluster/raft" and self.master.raft is not None:
            length = int(self.headers.get("Content-Length") or 0)
            payload = self.rfile.read(length)
            if not self.master.verify_raft_request(
                payload, self.headers.get("X-Raft-Signature", "")
            ):
                return self._json(403, {"error": "bad raft signature"})
            try:
                msg = json.loads(payload)
                return self._json(200, self.master.raft.handle(msg))
            except (ValueError, KeyError) as e:
                return self._json(400, {"error": str(e)})
        if u.path == "/submit":
            # one-shot convenience: assign + upload in a single request
            # (master_server_handlers.go submitFromMasterServerHandler)
            from ..operation.upload import upload_data
            from ..volume.http_handlers import _parse_multipart

            if not self.master.is_leader():
                return self._redirect_to_leader()
            q = urllib.parse.parse_qs(u.query)
            try:
                length = int(self.headers.get("Content-Length") or 0)
                # the master never handles object payloads elsewhere — cap
                # /submit bodies so one oversized POST can't exhaust its
                # memory (413 mirrors the volume server's own size check).
                # Draining a >limit body is impractical, so the keep-alive
                # connection closes instead of desyncing on the unread rest
                if length > self.master.topo.volume_size_limit:
                    self.close_connection = True
                    return self._json(413, {
                        "error": "submitted object exceeds volume size limit"})
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                name = mime = b""
                if ctype.startswith("multipart/form-data"):
                    data, name, mime = _parse_multipart(body, ctype)
                else:
                    data = body
                fid, url, public_url, _count = self.master.assign(
                    count=1,
                    collection=q.get("collection", [""])[0],
                    replication=q.get("replication", [""])[0],
                    ttl=q.get("ttl", [""])[0],
                    data_center=q.get("dataCenter", [""])[0],
                    rack=q.get("rack", [""])[0],
                )
                res = upload_data(
                    f"http://{url}/{fid}", data,
                    filename=name.decode() if name else "",
                    mime=mime.decode() if mime else "",
                    jwt=self.master.sign_fid(fid),
                )
                return self._json(201, {
                    "fid": fid,
                    "fileUrl": f"{public_url}/{fid}",
                    "fileName": name.decode() if name else "",
                    "size": res.size,
                })
            except ValueError as e:  # malformed client input -> 400
                return self._json(400, {"error": str(e)})
            except Exception as e:
                return self._json(500, {"error": str(e)})
        return self._json(404, {"error": f"unknown path {u.path}"})

    def do_GET(self):
        from ..telemetry import trace

        if self.path.split("?")[0] == "/dir/assign":
            # metered once, inside MasterServer.assign(); here only the
            # caller's trace context is adopted so the assign span joins
            with trace.remote_context(self.headers.get(trace.TRACEPARENT)):
                return self._do_get()
        with http_request(self, "master", _master_op(self.path)):
            self._do_get()

    def _do_get(self):
        u = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(u.query)

        def qget(name, default=""):
            return q.get(name, [default])[0]

        if serve_debug_http(self, u.path):
            return

        if u.path in _LEFT_OUT_PATHS:
            return self._left_out(u.path)

        if u.path == "/cluster/metrics":
            from ..stats.metrics import parse_family_prefixes
            from . import observability

            try:
                prefixes = parse_family_prefixes(qget("family"))
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            body = observability.cluster_metrics(
                self.master, prefixes).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if u.path == "/cluster/alerts":
            # the judgment plane's operator surface: SLO states, active
            # alerts (exemplar trace ids included), bounded transition
            # history, the canary's last probe round, and the flight
            # recorder's captured bundles (the page's evidence locker)
            doc = self.master.slo.status()
            doc["canary"] = self.master.canary.status()
            doc["debugBundles"] = self.master.flight.list_bundles()
            return self._json(200, doc)
        if u.path == "/cluster/hot":
            # federated heavy-hitter tables: which needle/bucket/tenant/
            # peer is hot right now, cluster-wide, in one request
            from . import observability

            try:
                n = int(qget("n", "32") or 32)
                if not 1 <= n <= 1024:
                    raise ValueError
            except ValueError:
                return self._json(400, {"error": "n must be in [1, 1024]"})
            return self._json(200, observability.cluster_hot(
                self.master, n))
        if u.path == "/cluster/debug":
            name = qget("bundle")
            if name:
                doc = self.master.flight.bundle(name)
                if doc is None:
                    return self._json(404, {
                        "error": f"no bundle named {name!r}"})
                return self._json(200, doc)
            return self._json(200, {
                "debugDir": self.master.flight.debug_dir,
                "retain": self.master.flight.retain,
                "bundles": self.master.flight.list_bundles(),
            })
        if u.path == "/cluster/debug/capture":
            # on-demand flight-recorder capture (the shell's
            # cluster.debug -capture); alert-triggered captures run
            # through the SLO sink without this endpoint
            try:
                return self._json(200, self.master.flight.capture(
                    trigger="manual"))
            except RuntimeError as e:  # capture already in flight
                return self._json(409, {"error": str(e)})
            except Exception as e:
                return self._json(500, {"error": str(e)})
        if u.path == "/cluster/traces":
            from ..telemetry import parse_trace_query
            from . import observability

            try:
                trace_id, limit = parse_trace_query(q)
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            if trace_id is None:
                return self._json(400, {
                    "error": "trace=<32-hex trace id> is required "
                             "(per-node rings are at /debug/traces)"})
            return self._json(200, observability.cluster_traces(
                self.master, trace_id, limit))


        if (((u.path.startswith("/dir/") and u.path != "/dir/status")
                or u.path in ("/vol/grow", "/vol/status"))
                and not self.master.is_leader()):
            # followers hold no topology (volume servers heartbeat the
            # leader only) — redirect like the reference's ProxyToLeader
            return self._redirect_to_leader()
        if u.path == "/dir/assign":
            try:
                fid, url, public_url, count = self.master.assign(
                    count=int(qget("count", "1") or 1),
                    collection=qget("collection"),
                    replication=qget("replication"),
                    ttl=qget("ttl"),
                    data_center=qget("dataCenter"),
                    rack=qget("rack"),
                )
                out = {
                    "fid": fid, "url": url, "publicUrl": public_url,
                    "count": count,
                }
                auth = self.master.sign_fid(fid)
                if auth:
                    out["auth"] = auth
                return self._json(200, out)
            except Exception as e:
                return self._json(500, {"error": str(e)})
        if u.path == "/dir/lookup":
            vid_s = qget("volumeId") or qget("fileId").split(",")[0]
            try:
                vid = int(vid_s)
            except ValueError:
                return self._json(400, {"error": "invalid volumeId"})
            locations = self.master.lookup_volume_locations(vid)
            if not locations:
                return self._json(404, {"volumeId": vid_s, "error": "not found"})
            return self._json(200, {
                "volumeId": vid_s,
                "locations": [
                    {"url": url, "publicUrl": public_url}
                    for url, public_url in locations
                ],
            })
        if u.path in ("/ui", "/ui/", "/ui/index.html"):
            from ..util.ui import render_status_page

            with self.master.topo.lock:
                page = render_status_page(
                    f"seaweedfs-tpu master {self.master.ip}:{self.master.port}",
                    {
                        "Cluster": {
                            "IsLeader": self.master.is_leader(),
                            "Leader": self.master.leader(),
                            "MaxVolumeId": self.master.topo.max_volume_id,
                        },
                        "DataNodes": [
                            {
                                "id": n.id,
                                "dataCenter": n.data_center,
                                "rack": n.rack,
                                "volumes": len(n.volumes),
                                "ecVolumes": len(n.ec_shards),
                            }
                            for n in self.master.topo.nodes.values()
                        ],
                    })
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(page)))
            self.end_headers()
            self.wfile.write(page)
            return
        if u.path == "/cluster/lifecycle":
            # lifecycle controller status: policies, journal, job states
            return self._json(200, self.master.lifecycle.status())
        if u.path in ("/cluster/status", "/dir/status"):
            from . import observability

            return self._json(200, observability.cluster_status(self.master))
        if u.path == "/vol/vacuum":
            vacuumed = self.master.vacuum(
                float(qget("garbageThreshold", "0") or 0) or None
            )
            return self._json(200, {"vacuumed": vacuumed})
        if u.path == "/vol/repair":
            # on-demand repair pass over queued scrub findings (the
            # maintenance loop runs the same pass on its interval)
            if not self.master.is_leader():
                return self._redirect_to_leader()
            s = self.master.repair_pass()
            return self._json(200, {
                "repaired": [list(k) for k in s["repaired"]],
                "failed": [list(k) for k in s["failed"]],
                "skipped": [list(k) for k in s["skipped"]],
                "outstanding": len(self.master.scrub_findings_snapshot()),
                "massRepair": self.master.mass_repair.status(),
            })
        if u.path == "/vol/grow":
            # master_server_handlers_admin.go volumeGrowHandler
            try:
                grown = self.master.grow_volumes(
                    qget("collection"),
                    qget("replication") or self.master.default_replication,
                    qget("ttl"),
                    data_center=qget("dataCenter"),
                    rack=qget("rack"),
                    target_count=int(qget("count", "0") or 0) or None,
                )
                return self._json(200, {"count": len(grown),
                                        "volumeIds": grown})
            except ValueError as e:  # malformed client input -> 400
                return self._json(400, {"error": str(e)})
            except Exception as e:
                return self._json(500, {"error": str(e)})
        if u.path == "/vol/status":
            with self.master.topo.lock:
                vols = {}
                for n in self.master.topo.nodes.values():
                    for vid, v in n.volumes.items():
                        vols.setdefault(str(vid), {
                            "size": v.size,
                            "fileCount": v.file_count,
                            "collection": v.collection,
                            "readOnly": v.read_only,
                            "replicaPlacement": str(
                                ReplicaPlacement.from_byte(
                                    v.replica_placement)),
                            "locations": [],
                        })["locations"].append(n.id)
                return self._json(200, {"Volumes": vols})
        if u.path == "/col/delete":
            # state-changing: POST/DELETE only, so a stray crawler's GET
            # can't drop a collection
            return self._json(405, {
                "error": "collection delete requires POST or DELETE"})
        if u.path in ("/cluster/healthz", "/stats/health"):
            own = f"{self.master.ip}:{self.master.port}"
            healthy = (self.master.is_leader()
                       or self.master.leader() != own)
            return self._json(200 if healthy else 503, {"ok": healthy})
        return self._json(404, {"error": f"unknown path {u.path}"})


class _MasterHTTPServer(FrameworkHTTPServer):
    conn_thread_prefix = "master-http-conn"


def _serve_http(master: MasterServer, host: str, port: int) -> ThreadingHTTPServer:
    handler = type("BoundMasterHttp", (_MasterHttpHandler,), {"master": master})
    httpd = _MasterHTTPServer((host, port), handler)
    httpd.serve_thread = threading.Thread(
        target=httpd.serve_forever, name="master-http", daemon=True)
    httpd.serve_thread.start()
    return httpd
