"""Master gRPC service: heartbeat ingest, assign/lookup, location pub/sub.

Reference: weed/server/master_grpc_server*.go.

The port's copy of seaweedfs_tpu/master/grpc_handlers.py.
"""

from __future__ import annotations

import json
import queue
import random
import threading
import time

import grpc

from ..pb import master_pb2
from ..storage.file_id import FileId
from ..topology.topology import DataNode


class MasterGrpcService:
    def __init__(self, master):
        self.master = master  # MasterServer
        self.topo = master.topo

    def _require_leader(self, context) -> None:
        """Followers refuse stateful rpcs; the error names the leader so
        clients re-aim (master_grpc_server.go leader checks)."""
        if not self.master.is_leader():
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"not the leader; leader is {self.master.leader_grpc()}",
            )

    # -- heartbeat ingest (bidi) -----------------------------------------

    def SendHeartbeat(self, request_iterator, context):
        if not self.master.is_leader():
            # answer once with the leader hint, then end the stream — the
            # volume server reconnects there (volume_grpc_client_to_master)
            yield master_pb2.HeartbeatResponse(
                leader=self.master.leader(),
                leader_grpc=self.master.leader_grpc(),
            )
            return
        node: DataNode | None = None
        try:
            for hb in request_iterator:
                if not self.master.is_leader():
                    # deposed mid-stream: hand the volume server the new
                    # leader hint immediately instead of letting it ride
                    # a dead stream until its next full-pulse timeout
                    yield master_pb2.HeartbeatResponse(
                        leader=self.master.leader(),
                        leader_grpc=self.master.leader_grpc(),
                    )
                    return
                if node is None:
                    node = DataNode(
                        id=f"{hb.ip}:{hb.port}",
                        public_url=hb.public_url or f"{hb.ip}:{hb.port}",
                        grpc_address=f"{hb.ip}:{hb.port + 10000}",
                        data_center=hb.data_center or "DefaultDataCenter",
                        rack=hb.rack or "DefaultRack",
                        max_volumes=sum(hb.max_volume_counts.values()) or 7,
                        max_volume_counts=dict(hb.max_volume_counts),
                    )
                # EVERY beat re-registers (idempotent): if the liveness
                # sweep unregistered a starved node while its stream stayed
                # up, the node must rejoin on its next beat — otherwise it
                # ghosts forever, still heartbeating into a topology that
                # no longer contains it
                node, was_new = self.topo.register_node(node)
                if was_new:
                    # a JOIN changes the EC holder map exactly like a
                    # death: bump the cache-invalidation seq the ack
                    # carries, or every peer's found-tier location cache
                    # (found_ttl 300s) keeps serving the node-less map —
                    # observed live as degraded reads failing "only 9
                    # shards available" for minutes after a dead shard
                    # holder REJOINED (the canary plane found this)
                    self.master.note_topology_change(node.id)
                if hb.max_file_key:
                    self.master.sequencer.set_max(hb.max_file_key)
                new_vids, deleted_vids = [], []
                if hb.volumes or hb.has_no_volumes:
                    before = set(node.volumes)
                    self.topo.sync_volumes(node, list(hb.volumes))
                    after = set(node.volumes)
                    new_vids = sorted(after - before)
                    deleted_vids = sorted(before - after)
                    self.master.rebuild_layouts(node)
                if hb.ec_shards or hb.has_no_ec_shards:
                    self.topo.sync_ec_shards(node, list(hb.ec_shards))
                if (hb.new_volumes or hb.deleted_volumes or hb.new_ec_shards
                        or hb.deleted_ec_shards):
                    self.topo.apply_incremental(node, hb)
                    self.master.rebuild_layouts(node)
                    new_vids += [m.id for m in hb.new_volumes]
                    deleted_vids += [m.id for m in hb.deleted_volumes]
                node.last_seen = time.monotonic()
                if hb.disk_health:
                    # disk-fault plane: record per-dir health, then
                    # react — low_space triggers emergency vacuum via
                    # the lifecycle plane, failing triggers proactive
                    # evacuation via the mass-repair orchestrator
                    node.disk_health = {
                        d.dir: {"state": d.state,
                                "free_bytes": d.free_bytes,
                                "total_bytes": d.total_bytes}
                        for d in hb.disk_health}
                    self.master.note_disk_health(node)
                if hb.HasField("stats"):
                    # federation fallback: keep the node's last stats
                    # snapshot for /cluster/metrics when a live scrape
                    # can't reach it
                    self.master.record_stats_snapshot(
                        node.id, "volume", hb.stats)
                if hb.scrub_findings:
                    # confirmed corruption findings from the node's scrub
                    # daemon: queue them for the maintenance repair pass
                    self.master.record_scrub_findings(
                        node.id, hb.scrub_findings)
                if deleted_vids:
                    # vids gone from this node must leave the writable
                    # sets too — rebuild_layouts only ever registers, so
                    # without this a deleted volume stays assignable on
                    # this node until master restart
                    self.master.unregister_from_layouts(deleted_vids,
                                                        node.id)
                if new_vids or deleted_vids:
                    self.master.broadcast_location(
                        node, new_vids, deleted_vids
                    )
                # the shared background-I/O budget: volume servers point
                # their scrub bucket at this rate so scrub + lifecycle
                # traffic can never saturate a node together (0 = keep
                # the node's local default).  During a deadline-bounded
                # mass repair the pushed rate is raised to the floor the
                # bound requires — never below the operator's budget,
                # and only while a budget exists to raise.
                rate = self.master.lifecycle.rate_mbps
                if rate > 0:
                    rate = max(rate, self.master.mass_repair
                               .rate_floor_mbps())
                # warm-up barrier input: one processed beat on a fresh
                # leader means a volume server found us and re-registered
                self.master._beat_count += 1
                yield master_pb2.HeartbeatResponse(
                    volume_size_limit=self.topo.volume_size_limit,
                    leader=self.master.leader(),
                    leader_grpc=self.master.leader_grpc(),
                    lifecycle_rate_mbps=rate,
                    # dead-node notice: a newer seq makes the volume
                    # server drop its EC holder-location caches eagerly
                    dead_node_seq=self.master.dead_node_seq,
                    dead_nodes=self.master.recent_dead_nodes,
                    # fencing epoch: the committed raft term this ack was
                    # produced under — volume servers reject mutating
                    # rpcs stamped with anything older
                    leader_epoch=self.master.leader_epoch(),
                )
        finally:
            if node is not None and context.code() is None:
                pass  # connection drop handled by liveness sweep

    # -- location pub/sub -------------------------------------------------

    def KeepConnected(self, request_iterator, context):
        if not self.master.is_leader():
            # one leader-hint message, then end: clients re-subscribe there
            yield master_pb2.VolumeLocation(leader=self.master.leader())
            return
        q: queue.Queue = queue.Queue()
        self.master.subscribe(q)
        registered_name, registration = "", None
        try:
            req_iter = iter(request_iterator)
            first = next(req_iter, None)
            if first is not None and first.client_type:
                # federation registration: a filer (or other scrapeable
                # client) announces its HTTP address; later requests on
                # the same stream refresh its stats snapshot
                registered_name = first.name
                registration = self.master.register_client(
                    first.name, first.client_type, first.http_address)
                self._ingest_client_stats(first)
                threading.Thread(
                    target=self._drain_client_stream,
                    args=(req_iter,), daemon=True,
                    name="keepconnected-stats").start()
            # initial snapshot: all known volume locations
            with self.topo.lock:
                for n in self.topo.nodes.values():
                    yield master_pb2.VolumeLocation(
                        url=n.id,
                        public_url=n.public_url,
                        new_vids=sorted(set(n.volumes) | set(n.ec_shards)),
                        leader=self.master.leader(),
                        data_center=n.data_center,
                    )
            while context.is_active():
                if not self.master.is_leader():
                    # deposed mid-stream: hand subscribers the new leader
                    # and end, or they'd sit on a silent queue forever
                    yield master_pb2.VolumeLocation(
                        leader=self.master.leader()
                    )
                    return
                try:
                    loc = q.get(timeout=1.0)
                except queue.Empty:
                    continue
                yield loc
        finally:
            self.master.unsubscribe(q)
            if registered_name:
                # token-guarded: only removes OUR registration, never a
                # reconnected stream's fresher one
                self.master.unregister_client(registered_name, registration)

    def _ingest_client_stats(self, req) -> None:
        if req.HasField("stats") and req.http_address:
            self.master.record_stats_snapshot(
                req.http_address, req.client_type or "client", req.stats)

    def _drain_client_stream(self, req_iter) -> None:
        """Consume a registered client's stats refreshes (the stream
        otherwise only matters at open time)."""
        try:
            for req in req_iter:
                if req.client_type:
                    self.master.touch_client(req.name)
                    self._ingest_client_stats(req)
        except Exception:  # noqa: BLE001 — stream teardown races are fine
            pass

    # -- assign / lookup --------------------------------------------------

    def Assign(self, request, context):
        self._require_leader(context)
        try:
            fid, url, public_url, count = self.master.assign(
                count=max(int(request.count), 1),
                collection=request.collection,
                replication=request.replication,
                ttl=request.ttl,
                data_center=request.data_center,
                rack=request.rack,
            )
        except Exception as e:
            return master_pb2.AssignResponse(error=str(e))
        return master_pb2.AssignResponse(
            fid=fid, url=url, public_url=public_url, count=count,
            auth=self.master.sign_fid(fid),
        )

    def LookupVolume(self, request, context):
        self._require_leader(context)
        resp = master_pb2.LookupVolumeResponse()
        for vof in request.volume_or_file_ids:
            entry = resp.volume_id_locations.add(volume_or_file_id=vof)
            try:
                vid = int(vof.split(",", 1)[0])
            except ValueError:
                entry.error = "invalid volume id"
                continue
            locations = self.master.lookup_volume_locations(vid)
            if not locations:
                entry.error = f"volume {vid} not found"
                continue
            for url, public_url in locations:
                entry.locations.add(url=url, public_url=public_url)
        return resp

    def LookupEcVolume(self, request, context):
        self._require_leader(context)
        shard_map = self.topo.lookup_ec_shards(request.volume_id)
        if not shard_map:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"ec volume {request.volume_id} not found",
            )
        resp = master_pb2.LookupEcVolumeResponse(volume_id=request.volume_id)
        for sid in sorted(shard_map):
            e = resp.shard_id_locations.add(shard_id=sid)
            for n in shard_map[sid]:
                # rack/dc ride along so rebuilders can prefer same-rack
                # sources and aggregate one cross-rack partial per rack
                e.locations.add(url=n.id, public_url=n.public_url,
                                data_center=n.data_center, rack=n.rack)
        return resp

    # -- cluster info -----------------------------------------------------

    def VolumeList(self, request, context):
        return master_pb2.VolumeListResponse(
            topology_info=self.topo.to_topology_info(),
            volume_size_limit_mb=self.topo.volume_size_limit // (1 << 20),
        )

    def Statistics(self, request, context):
        total = used = files = 0
        with self.topo.lock:
            for n in self.topo.nodes.values():
                for v in n.volumes.values():
                    if request.collection and v.collection != request.collection:
                        continue
                    used += v.size
                    files += v.file_count
                total += n.max_volumes * self.topo.volume_size_limit
        return master_pb2.StatisticsResponse(
            total_size=total, used_size=used, file_count=files
        )

    def CollectionList(self, request, context):
        resp = master_pb2.CollectionListResponse()
        for name in sorted(self.topo.collections()):
            if name:
                resp.collections.add(name=name)
        return resp

    def CollectionDelete(self, request, context):
        self._require_leader(context)
        self.master.delete_collection(request.name)
        return master_pb2.CollectionDeleteResponse()

    def GetMasterConfiguration(self, request, context):
        return master_pb2.GetMasterConfigurationResponse(
            volume_size_limit_mb=self.topo.volume_size_limit // (1 << 20),
            default_replication=self.master.default_replication,
            leader=self.master.leader(),
        )

    def ListMasterClients(self, request, context):
        return master_pb2.ListMasterClientsResponse()

    def VacuumVolume(self, request, context):
        self._require_leader(context)
        self.master.vacuum(request.garbage_threshold or 0.3)
        return master_pb2.VacuumVolumeResponse()

    # -- lifecycle plane --------------------------------------------------

    def Lifecycle(self, request, context):
        """The volume.lifecycle / volume.repair shell surface.

        `status` / `policy` / `run` drive the lifecycle controller: `run`
        evaluates the policies now; with apply=False it only reports the
        plan (dry run), with apply=True the planned jobs are journaled and
        executed before the response returns.  `mass_repair_status` /
        `mass_repair_plan` / `mass_repair_run` do the same for the
        dead-node mass-repair orchestrator."""
        lc = self.master.lifecycle
        action = request.action or "status"
        if action == "status":
            return master_pb2.LifecycleResponse(
                report=json.dumps(lc.status()))
        if action == "policy":
            try:
                policies = lc.set_policies(request.policy_json)
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            return master_pb2.LifecycleResponse(report=policies.dumps())
        if action == "run":
            self._require_leader(context)
            plans = lc.evaluate()
            if request.volume_id:
                plans = [p for p in plans
                         if p["volume_id"] == request.volume_id]
            if request.transition:
                plans = [p for p in plans
                         if p["transition"] == request.transition]
            report = {"planned": plans, "results": []}
            if request.apply:
                accepted = lc.submit(plans)
                # scoped: execute only the jobs THIS request planned —
                # unrelated resumed/queued jobs stay for the controller
                report["results"] = lc.run_pending(
                    wait=True, keys={j["key"] for j in accepted})
            return master_pb2.LifecycleResponse(
                report=json.dumps(report))
        if action == "mass_repair_status":
            return master_pb2.LifecycleResponse(
                report=json.dumps(self.master.mass_repair.status()))
        if action in ("mass_repair_plan", "mass_repair_run"):
            self._require_leader(context)
            mr = self.master.mass_repair
            plans = mr.plan(dead_node=request.node)
            report = {"planned": plans, "results": []}
            if action == "mass_repair_run":
                accepted = mr.submit(plans)
                report["accepted"] = [j["key"] for j in accepted]
                report["results"] = mr.run_wave(mr.pending())
            return master_pb2.LifecycleResponse(
                report=json.dumps(report))
        context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                      f"unknown lifecycle action {action!r} "
                      "(want status|policy|run|mass_repair_status|"
                      "mass_repair_plan|mass_repair_run)")

    # -- admin lock -------------------------------------------------------

    def LeaseAdminToken(self, request, context):
        self._require_leader(context)
        token = self.master.lease_admin_token(
            request.lock_name, request.previous_token
        )
        if token is None:
            context.abort(grpc.StatusCode.ABORTED, "already locked")
        return master_pb2.LeaseAdminTokenResponse(
            token=token, lock_ts_ns=time.time_ns()
        )

    def ReleaseAdminToken(self, request, context):
        self.master.release_admin_token(request.lock_name, request.previous_token)
        return master_pb2.ReleaseAdminTokenResponse()
