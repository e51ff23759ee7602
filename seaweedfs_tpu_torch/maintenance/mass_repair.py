"""Dead-node mass repair: the cluster-scale repair orchestrator — the
port's copy of seaweedfs_tpu/maintenance/mass_repair.py.

A dead volume server drops many EC volumes to reduced redundancy at once;
per-volume rebuilds under one shared token bucket have no global plan
(arXiv:1309.0186 measures repair traffic dominating cross-rack bandwidth
during exactly this failure mode).  This module is the master-side plan:

  * **detect** — the liveness sweep calls :meth:`on_node_dead` the
    moment a node misses its 3-pulse heartbeat window;
  * **rank** — every affected EC volume is ordered by exposure (fewest
    surviving shards first, bytes-at-risk as tiebreak), so volumes one
    shard from data loss rebuild strictly before healthier ones;
  * **spread** — rebuild targets are assigned with a hard per-node cap
    (ceil(N / alive) + 1, topology/placement.spread_rebuild_targets) so
    no node or rack becomes the write bottleneck;
  * **drive** — plans become journaled, crash-safe jobs in the lifecycle
    journal (transition ``mass_repair``, duplicate-suppressed by the
    (volume, transition) key — which also mutually excludes the
    scrub-driven repair pass), executed as ONE VolumeEcShardsBatchRebuild
    rpc per target node (in chunks of ``jobs_per_rpc``) whose volumes
    source remote columns through cross-volume aggregated partial rpcs
    (storage/ec/partial.py).  The request names no codec: each target
    rebuilds on its own default, for a port volume server the card's
    batched kernel through its codec service;
  * **bound** — with a configured total-repair-time bound the
    orchestrator raises the pushed shared background-I/O rate to the
    floor the deadline requires (never below the operator's budget) and
    exposes the slack as seaweedfs_repair_batch_deadline_slack_seconds.

On by default (SEAWEEDFS_TPU_MASS_REPAIR=0 turns it off), as in the
reference.  Port difference: an EC volume that is still mounted as a
plain volume somewhere (an ec.encode, the shell's or the controller's,
whose shards are still being copied and mounted; an ec.decode whose
shards are being dropped) is neither planned nor counted lost, whatever
its shard count: its .dat is whole.  The reference plans a rebuild for
such a volume at 10-13 shards and warns "data loss" below 10.  Fault
point ``repair.batch.plan`` fires before each planning pass.  Threads are named ``master-mass-repair*``; ``stop()`` joins the
runner and the evacuation threads.
"""

from __future__ import annotations

import os
import threading
import time

import grpc

from ..pb import rpc as rpclib
from ..pb import volume_server_pb2 as vs
from ..stats.metrics import (
    DISK_EVACUATE_COUNTER,
    REPAIR_BATCH_BYTES,
    REPAIR_BATCH_DEADLINE_SLACK,
    REPAIR_BATCH_JOBS,
    REPAIR_BATCH_QUEUE_DEPTH,
    REPAIR_BATCH_SECONDS,
    REPAIR_BATCH_VOLUMES,
)
from ..storage.ec.constants import DATA_SHARDS, TOTAL_SHARDS
from ..topology.placement import spread_rebuild_targets
from ..util import faultpoint, glog
from .journal import ACTIVE_STATES, job_key

FP_BATCH_PLAN = faultpoint.register("repair.batch.plan")

TRANSITION = "mass_repair"

ENABLED_ENV = "SEAWEEDFS_TPU_MASS_REPAIR"
DEADLINE_ENV = "SEAWEEDFS_TPU_MASS_REPAIR_DEADLINE_S"
WORKERS_ENV = "SEAWEEDFS_TPU_MASS_REPAIR_TARGETS"

MAX_ATTEMPTS = 3
# a finished job is not reissuable until the target's heartbeat had time
# to register the rebuilt shards with the master (else every periodic
# re-plan against the lagging topology would resurrect it for a no-op)
DONE_REISSUE_GRACE_S = 15.0
# volumes per VolumeEcShardsBatchRebuild rpc: a target's whole slice of
# a big dead node in ONE rpc would outlive any fixed deadline and turn
# a timeout into 3 wasted re-rebuilds of work that actually completed —
# chunking bounds each rpc and journals progress incrementally
JOBS_PER_RPC_ENV = "SEAWEEDFS_TPU_MASS_REPAIR_JOBS_PER_RPC"
RPC_TIMEOUT_ENV = "SEAWEEDFS_TPU_MASS_REPAIR_RPC_TIMEOUT_S"


def exposure_class(surviving: int) -> str:
    """Metric label for a volume's distance from the decode floor:
    "0" = one shard from data loss .. "3", "lost" = below the floor."""
    margin = surviving - DATA_SHARDS
    return "lost" if margin < 0 else str(min(margin, TOTAL_SHARDS
                                             - DATA_SHARDS - 1))


def rank_by_exposure(volumes: "list[dict]") -> "list[dict]":
    """Fewest surviving shards first; ties broken by bytes at risk
    (largest shard size first), volume id for determinism."""
    return sorted(volumes, key=lambda v: (
        v["surviving"], -int(v.get("shard_size", 0)), v["volume_id"]))


class MassRepairOrchestrator:
    """Master-resident; shares the lifecycle controller's journal so
    mass-repair jobs resume across master restarts and a volume under
    mass repair is invisible to every other transition planner."""

    def __init__(self, master, controller, deadline_s: float | None = None,
                 enabled: bool | None = None):
        self.master = master
        self.controller = controller
        self.journal = controller.journal
        if deadline_s is None:
            deadline_s = float(os.environ.get(DEADLINE_ENV, "0"))
        self.deadline_s = deadline_s
        if enabled is None:
            enabled = os.environ.get(ENABLED_ENV, "1").lower() not in (
                "0", "false", "off", "no")
        self.enabled = enabled
        self.max_target_rpcs = max(1, int(os.environ.get(WORKERS_ENV, "4")))
        self.jobs_per_rpc = max(1, int(os.environ.get(
            JOBS_PER_RPC_ENV, "8")))
        self.rpc_timeout_s = float(os.environ.get(RPC_TIMEOUT_ENV, "600"))
        self._lock = threading.Lock()
        # one wave at a time: the background runner and an operator's
        # `volume.repair -apply` must never both claim the same pending
        # job (the pending->running flip is get-then-update, not CAS)
        self._wave_mutex = threading.Lock()
        self._runner: threading.Thread | None = None
        self._stop = threading.Event()
        # leader fencing: set on depose, cleared on resume — a running
        # wave stops issuing batch rpcs the moment the raft role flips,
        # instead of racing the new leader's plan
        self._fence = threading.Event()
        # current batch accounting for the deadline bound: set when jobs
        # are accepted, cleared when the queue drains
        self._deadline_at = 0.0
        self._remaining_bytes = 0
        self._counts = {"deaths": 0, "planned": 0, "repaired": 0,
                        "failed": 0, "parked": 0, "unrepairable": 0,
                        "waves": 0, "evacuated": 0}
        self._last_plan = 0.0
        self._lost_seen: set[int] = set()
        # proactive evacuation state: node -> last finished run
        # (cooldown), plus the set of in-flight evacuation threads
        self._evacuations: dict[str, float] = {}
        self._evacuating: set[str] = set()
        self._evacuators: list[threading.Thread] = []
        for rec in self.journal.jobs(("pending",)):
            if rec.get("transition") == TRANSITION and rec.get("resumed"):
                REPAIR_BATCH_JOBS.labels("resumed").inc()

    # -- planning ---------------------------------------------------------

    def _affected_volumes(self) -> "list[dict]":
        """Every EC volume below TOTAL_SHARDS in the live topology, with
        holder map, surviving count and the heartbeat-learned shard
        size; a volume still mounted as a plain volume is left out."""
        topo = self.master.topo
        shards: dict[int, set] = {}
        holders: dict[int, dict] = {}
        sizes: dict[int, int] = {}
        collections: dict[int, str] = {}
        plain: set[int] = set()
        with topo.lock:
            for n in topo.nodes.values():
                plain.update(n.volumes)
                for vid, bits in n.ec_shards.items():
                    sids = set(bits.shard_ids())
                    shards.setdefault(vid, set()).update(sids)
                    holders.setdefault(vid, {})[n.id] = len(sids)
                    collections[vid] = n.ec_collections.get(vid, "")
                    size = n.ec_shard_sizes.get(vid, 0)
                    if size:
                        sizes[vid] = max(sizes.get(vid, 0), size)
        out = []
        for vid, sids in shards.items():
            if len(sids) >= TOTAL_SHARDS or vid in plain:
                continue
            out.append({
                "volume_id": vid,
                "collection": collections.get(vid, ""),
                "surviving": len(sids),
                "missing": TOTAL_SHARDS - len(sids),
                "holders": holders.get(vid, {}),
                "shard_size": sizes.get(vid, 0),
            })
        return out

    def plan(self, dead_node: str = "") -> "list[dict]":
        """Rank affected volumes by exposure and spread rebuild targets;
        pure against the current topology — nothing is journaled here."""
        faultpoint.inject(FP_BATCH_PLAN, ctx=dead_node)
        affected = rank_by_exposure(self._affected_volumes())
        repairable = [v for v in affected if v["surviving"] >= DATA_SHARDS]
        with self.master.topo.lock:
            candidates = {n.id: max(n.free_ec_slots(), 0)
                          for n in self.master.topo.nodes.values()}
        targets = spread_rebuild_targets(repairable, candidates)
        plans = []
        for v in affected:
            if v["surviving"] < DATA_SHARDS:
                if v["volume_id"] not in self._lost_seen:
                    self._lost_seen.add(v["volume_id"])
                    REPAIR_BATCH_VOLUMES.labels("lost").inc()
                    self._counts["unrepairable"] += 1
                    glog.warning(
                        "mass repair: volume %d below decode floor "
                        "(%d surviving shards) — data loss, nothing "
                        "to plan", v["volume_id"], v["surviving"])
                continue
            target = targets.get(v["volume_id"])
            if target is None:
                continue
            plans.append({
                "key": job_key(v["volume_id"], TRANSITION),
                "volume_id": v["volume_id"],
                "transition": TRANSITION,
                "collection": v["collection"],
                "node": target,
                "holders": sorted(v["holders"]),
                "surviving": v["surviving"],
                "bytes": v["missing"] * v["shard_size"],
                "shard_size": v["shard_size"],
                "dead_node": dead_node,
            })
        return plans

    # -- submission (journal + dedup) -------------------------------------

    def submit(self, plans: "list[dict]") -> "list[dict]":
        """Journal new mass-repair jobs.  Dedup mirrors the lifecycle
        controller's: the (volume, transition) key suppresses an active
        duplicate, parked jobs wait for an operator, a volume with ANY
        other active journal job is skipped (one transition at a time),
        and a volume the scrub repair pass is currently healing is left
        to it (the pass skips ours symmetrically)."""
        now_ms = int(time.time() * 1000)
        # journal the batch under the master's repair-claim lock: the
        # scrub pass registers ITS volume claims and snapshots our
        # active jobs under the same lock, so neither side can slip a
        # claim into the other's check-then-act window
        with self.master._repair_claim_lock:
            return self._submit_locked(plans, now_ms)

    def _submit_locked(self, plans: "list[dict]", now_ms: int) -> "list[dict]":
        active_vids = {j["volume_id"] for j in self.journal.active()}
        scrub_busy = set(self.master._scrub_repairing)
        accepted = []
        for plan in plans:
            key = plan["key"]
            existing = self.journal.get(key)
            resurrect = False
            if existing is not None:
                state = existing.get("state")
                if state in ACTIVE_STATES or state == "parked":
                    continue
                if (state == "done"
                        and now_ms - existing.get("updated_ms", 0)
                        < DONE_REISSUE_GRACE_S * 1000):
                    # the rebuilt shards register with the master on the
                    # target's NEXT heartbeat — re-planning against that
                    # lag would resurrect every just-finished job for a
                    # no-op rebuild and inflate the counters
                    continue
                # done-or-failed + the volume is degraded AGAIN (plan()
                # only emits currently-degraded volumes): this is a new
                # incident (or a retry) — resurrect the same record.  A
                # fresh incident after a completed repair starts a fresh
                # attempt counter; a failed attempt keeps its count so
                # MAX_ATTEMPTS still parks it.
                resurrect = True
            if plan["volume_id"] in active_vids:
                continue
            if plan["volume_id"] in scrub_busy:
                continue
            try:
                if resurrect:
                    fields = {k: v for k, v in plan.items() if k != "key"}
                    if existing.get("state") == "done":
                        fields["attempts"] = 0
                    job = self.journal.update(key, state="pending",
                                              **fields)
                    if job is None:
                        continue
                else:
                    job = {**plan, "state": "pending", "attempts": 0,
                           "created_ms": now_ms}
                    self.journal.put(job)
            except Exception as e:  # journal write failed: no job
                glog.warning("mass repair: journal write for %s "
                             "failed: %s", key, e)
                REPAIR_BATCH_JOBS.labels("error").inc()
                continue
            active_vids.add(plan["volume_id"])
            accepted.append(job)
            REPAIR_BATCH_VOLUMES.labels(
                exposure_class(plan.get("surviving", TOTAL_SHARDS))).inc()
            self._counts["planned"] += 1
        if accepted:
            with self._lock:
                self._remaining_bytes += sum(
                    int(j.get("bytes") or 0) for j in accepted)
                if self.deadline_s > 0:
                    self._deadline_at = (
                        self._deadline_at
                        or time.monotonic() + self.deadline_s)
        self._refresh_gauges()
        return accepted

    # -- triggers ---------------------------------------------------------

    def on_node_dead(self, node_id: str) -> None:
        """Liveness-sweep hook: the node is already out of the topology,
        so plan() sees exactly the post-death shard map."""
        if not self.enabled or not self._warmed():
            return
        self._counts["deaths"] += 1
        try:
            accepted = self.submit(self.plan(dead_node=node_id))
        except Exception as e:  # noqa: BLE001 — the sweep must survive
            glog.warning("mass repair: planning for dead node %s "
                         "failed: %s", node_id, e)
            return
        if accepted:
            glog.warning(
                "mass repair: node %s dead, %d volume(s) planned "
                "(most exposed: %s)", node_id, len(accepted),
                [j["volume_id"] for j in accepted[:8]])
        self.kick()

    # -- proactive evacuation (failing disk, node still alive) ------------

    EVACUATION_COOLDOWN_S = 30.0

    def on_disk_failing(self, node_id: str) -> None:
        """Heartbeat-ingest trigger: a node reports a FAILING disk
        (K EIOs / statvfs errors).  Unlike on_node_dead the node is
        still alive and its bytes still readable — the cheapest repair
        there will ever be is to drain it NOW (arXiv:1309.0186: paying
        a planned migration beats paying the post-death repair storm).
        EC shards move via copy+mount-on-target then unmount+delete-on-
        source (readable throughout); volumes whose ONLY copy lives on
        the failing node are re-copied to a healthy peer.  Idempotent
        and rate-limited: re-triggers (the node keeps beating `failing`)
        pick up whatever the topology still shows on the node."""
        if not self.enabled or self._stop.is_set():
            return
        with self._lock:
            last = self._evacuations.get(node_id, 0.0)
            if time.monotonic() - last < self.EVACUATION_COOLDOWN_S:
                return
            if node_id in self._evacuating:
                return
            self._evacuating.add(node_id)
        t = threading.Thread(target=self._evacuate, args=(node_id,),
                             name=f"master-mass-repair-evacuate-{node_id}",
                             daemon=True)
        with self._lock:
            self._evacuators = [th for th in self._evacuators
                                if th.is_alive()] + [t]
        t.start()

    def plan_evacuation(self, node_id: str) -> "list[dict]":
        """Pure: what should move off `node_id` right now.  EC shards
        held there spread to healthy nodes by free EC slots; volumes
        with no healthy holder get one copy each."""
        topo = self.master.topo
        moves: list[dict] = []
        with topo.lock:
            node = topo.nodes.get(node_id)
            if node is None:
                return []
            healthy = [n for n in topo.nodes.values()
                       if n.id != node_id and n.has_writable_disk()]
            ec_free = {n.id: max(n.free_ec_slots(), 0) for n in healthy}
            vol_free = {n.id: max(n.free_slots(), 0) for n in healthy}
            from ..storage.ec.shard_bits import ShardBits

            for vid, bits in sorted(node.ec_shards.items()):
                coll = node.ec_collections.get(vid, "")
                # per-volume spread: stacking one volume's shards on a
                # single node would turn that node's later death into
                # data loss — prefer targets holding (or receiving) the
                # fewest shards of THIS volume, then most free slots
                vol_load = {
                    n.id: (ShardBits(n.ec_shards[vid]).count()
                           if vid in n.ec_shards else 0)
                    for n in healthy}
                for sid in bits.shard_ids():
                    candidates = [n for n in ec_free if ec_free[n] > 0]
                    if not candidates:
                        break
                    target = min(candidates, key=lambda n: (
                        vol_load.get(n, 0), -ec_free[n], n))
                    ec_free[target] -= 1
                    vol_load[target] = vol_load.get(target, 0) + 1
                    moves.append({"kind": "ec_shard", "volume_id": vid,
                                  "shard_id": sid, "collection": coll,
                                  "source": node_id, "target": target})
            for vid, v in sorted(node.volumes.items()):
                if any(vid in n.volumes for n in healthy):
                    continue  # a healthy replica already exists
                target = max(vol_free, key=lambda n: (vol_free[n], n),
                             default=None)
                if target is None or vol_free[target] <= 0:
                    continue
                vol_free[target] -= 1
                moves.append({"kind": "volume", "volume_id": vid,
                              "collection": v.collection,
                              "source": node_id, "target": target})
        return moves

    def _evacuate(self, node_id: str) -> None:
        moved = failed = 0
        try:
            moves = self.plan_evacuation(node_id)
            if moves:
                glog.warning(
                    "mass repair: disk FAILING on %s — evacuating %d "
                    "shard(s)/volume(s) proactively", node_id, len(moves))
            for mv in moves:
                if self._stop.is_set():
                    break
                try:
                    if mv["kind"] == "ec_shard":
                        self._evacuate_ec_shard(mv)
                    else:
                        self._evacuate_volume(mv)
                    DISK_EVACUATE_COUNTER.labels(mv["kind"], "ok").inc()
                    moved += 1
                except Exception as e:  # noqa: BLE001 — per-move isolation
                    DISK_EVACUATE_COUNTER.labels(mv["kind"], "error").inc()
                    failed += 1
                    glog.warning("evacuation move %s failed: %s", mv, e)
            self._counts["evacuated"] += moved
            if moved or failed:
                glog.warning("mass repair: evacuation of %s: %d moved, "
                             "%d failed", node_id, moved, failed)
        finally:
            with self._lock:
                self._evacuating.discard(node_id)
                self._evacuations[node_id] = time.monotonic()

    def _evacuate_ec_shard(self, mv: dict) -> None:
        """copy+mount on the target, then unmount+delete on the failing
        source — the two-phase order keeps the shard readable
        throughout (same discipline as the shell's ec.balance)."""
        vid, sid, coll = mv["volume_id"], mv["shard_id"], mv["collection"]
        tgt = self._target_stub(mv["target"])
        from ..shell.ec_commands import _node_grpc

        tgt.VolumeEcShardsCopy(vs.VolumeEcShardsCopyRequest(
            volume_id=vid, collection=coll, shard_ids=[sid],
            copy_ecx_file=True, copy_ecj_file=True, copy_vif_file=True,
            copy_from_data_node=_node_grpc(mv["source"]),
            leader_epoch=self._epoch()))
        tgt.VolumeEcShardsMount(vs.VolumeEcShardsMountRequest(
            volume_id=vid, collection=coll, shard_ids=[sid]))
        src = self._target_stub(mv["source"])
        src.VolumeEcShardsUnmount(vs.VolumeEcShardsUnmountRequest(
            volume_id=vid, shard_ids=[sid]))
        src.VolumeEcShardsDelete(vs.VolumeEcShardsDeleteRequest(
            volume_id=vid, collection=coll, shard_ids=[sid]))

    def _evacuate_volume(self, mv: dict) -> None:
        """Pull the sole copy of a volume onto a healthy node.  The
        failing node's copy is left in place as extra redundancy —
        death (or the operator) removes it; deleting the original while
        its disk still half-works would trade durability for tidiness."""
        from ..shell.ec_commands import _node_grpc

        self._target_stub(mv["target"]).VolumeCopy(vs.VolumeCopyRequest(
            volume_id=mv["volume_id"], collection=mv["collection"],
            source_data_node=_node_grpc(mv["source"]),
            leader_epoch=self._epoch()))

    def tick(self) -> None:
        """Periodic re-evaluation (liveness cadence): re-plans degraded
        volumes whose earlier jobs failed or were deferred behind other
        transitions, and keeps the runner alive while jobs are pending.
        Cheap and rate-limited — a healthy cluster scans nothing."""
        if (not self.enabled or not self.master.is_leader()
                or not self._warmed()):
            return
        now = time.monotonic()
        if now - self._last_plan < 5.0:
            return
        self._last_plan = now
        try:
            plans = self.plan()
            if plans:
                self.submit(plans)
        except Exception as e:  # noqa: BLE001
            glog.warning("mass repair tick failed: %s", e)
        if self.pending():
            self.kick()

    def _warmed(self) -> bool:
        """Planning gate: a freshly elected leader must finish its
        warm-up barrier (log tail applied + heartbeat cycle seen) before
        planning repairs, or it plans duplicates of work the deposed
        leader's committed journal already covers."""
        fn = getattr(self.master, "control_warmed", None)
        return fn() if callable(fn) else True

    def _epoch(self) -> int:
        return self.master.leader_epoch()

    def fence(self, term: int) -> None:
        """Deposed: cancel the running wave between chunks; the volume
        servers reject anything already on the wire by stale epoch."""
        self._fence.set()
        glog.warning("mass repair: fenced at term %d — running waves "
                     "cancelled", term)

    def resume(self) -> None:
        """Master start: journaled mass-repair jobs that were pending or
        running at the crash replayed as pending — run them."""
        self._fence.clear()
        if self.pending():
            glog.warning("mass repair: resuming %d journaled job(s)",
                         len(self.pending()))
            if self.deadline_s > 0:
                with self._lock:
                    self._remaining_bytes = sum(
                        int(j.get("bytes") or 0) for j in self.pending())
                    self._deadline_at = time.monotonic() + self.deadline_s
            self.kick()

    def pending(self) -> "list[dict]":
        return [j for j in self.journal.jobs(("pending",))
                if j.get("transition") == TRANSITION]

    def kick(self) -> None:
        with self._lock:
            if self._stop.is_set() or (self._runner is not None
                                       and self._runner.is_alive()):
                return
            self._runner = threading.Thread(
                target=self._run, name="master-mass-repair", daemon=True)
            self._runner.start()

    def stop(self) -> None:
        """Stop and join the runner (a wave in flight finishes its
        current rpc) and the evacuation threads."""
        self._stop.set()
        with self._lock:
            threads = [self._runner, *self._evacuators]
        for th in threads:
            if th is not None:
                th.join(timeout=30.0)

    # -- execution --------------------------------------------------------

    def _run(self) -> None:
        # after a master restart the runner can win the race against the
        # volume servers' re-registration heartbeats — rebuild targets
        # would then fail their holder lookups and burn attempts, so
        # wait (bounded) for the topology to repopulate first
        deadline = time.monotonic() + 15.0
        while (not self.master.topo.nodes
               and time.monotonic() < deadline
               and not self._stop.wait(0.3)):
            pass
        try:
            while not self._stop.is_set() and self.master.is_leader():
                batch = self.pending()
                if not batch:
                    break
                if not self.run_wave(batch):
                    # zero progress (e.g. the journal itself cannot be
                    # written): back off instead of spinning the leader
                    # at 100% CPU on the same stuck batch
                    if self._stop.wait(2.0):
                        break
        finally:
            with self._lock:
                if not self.pending():
                    self._remaining_bytes = 0
                    self._deadline_at = 0.0
            self._refresh_gauges()

    def run_wave(self, jobs: "list[dict]") -> "list[dict]":
        """One pass over pending jobs: group by target node, one
        VolumeEcShardsBatchRebuild rpc per target (bounded concurrency),
        per-volume results journaled individually.  Exposure order is
        preserved inside each target's job list, so the most exposed
        volumes rebuild first on every node."""
        from concurrent.futures import ThreadPoolExecutor

        with self._wave_mutex:
            return self._run_wave_locked(jobs, ThreadPoolExecutor)

    def _run_wave_locked(self, jobs, ThreadPoolExecutor) -> "list[dict]":
        t0 = time.monotonic()
        self._counts["waves"] += 1
        by_target: dict[str, list[dict]] = {}
        order = {j["key"]: i for i, j in enumerate(jobs)}
        for job in sorted(jobs, key=lambda j: (
                j.get("surviving", TOTAL_SHARDS), order[j["key"]])):
            by_target.setdefault(job.get("node", ""), []).append(job)
        results: list[dict] = []

        def run_target(target: str, tjobs: "list[dict]") -> None:
            # exposure order preserved chunk by chunk: the most exposed
            # volumes ride (and finish) the first rpcs
            for at in range(0, len(tjobs), self.jobs_per_rpc):
                if self._fence.is_set() or not self.master.is_leader():
                    return  # deposed mid-wave: leave the rest pending
                run_target_chunk(target, tjobs[at:at + self.jobs_per_rpc])

        def run_target_chunk(target: str, tjobs: "list[dict]") -> None:
            claimed = []
            for job in tjobs:
                cur = self.journal.get(job["key"])
                if cur is None or cur.get("state") != "pending":
                    continue
                try:
                    self.journal.update(job["key"], state="running")
                except Exception:  # noqa: BLE001 — unjournaled = unrun
                    continue
                claimed.append({**job, **(self.journal.get(job["key"])
                                          or {})})
            if not claimed:
                return
            finished: set[str] = set()
            try:
                stub = self._target_stub(target)
                resp = stub.VolumeEcShardsBatchRebuild(
                    vs.VolumeEcShardsBatchRebuildRequest(
                        leader_epoch=self._epoch(),
                        jobs=[vs.BatchRebuildJob(
                            volume_id=j["volume_id"],
                            collection=j.get("collection", ""),
                            shard_size=int(j.get("shard_size") or 0))
                            for j in claimed]))
                by_vid = {r.volume_id: r for r in resp.results}
                for job in claimed:
                    r = by_vid.get(job["volume_id"])
                    if r is None:
                        results.append(self._finish(
                            job, error=f"target {target}: no result"))
                    elif r.error:
                        results.append(self._finish(job, error=r.error))
                    else:
                        results.append(self._finish(
                            job, rebuilt=list(r.rebuilt_shard_ids),
                            used_partial=r.used_partial))
                    finished.add(job["key"])
            except Exception as e:  # noqa: BLE001 — claimed jobs MUST
                # resolve: an rpc failure (or a journal-write error
                # mid-result-loop) fails the rest of the claim instead
                # of stranding it `running` forever — `running` would
                # suppress every future re-plan until a master restart
                code = e.code() if isinstance(
                    e, grpc.RpcError) and hasattr(e, "code") else e
                for job in claimed:
                    if job["key"] in finished:
                        continue
                    try:
                        results.append(self._finish(
                            job, error=f"target {target}: {code}"))
                    except Exception as e2:  # noqa: BLE001
                        glog.warning("mass repair: could not journal "
                                     "failure of %s: %s", job["key"], e2)

        self._refresh_gauges()
        if len(by_target) == 1:
            ((target, tjobs),) = by_target.items()
            run_target(target, tjobs)
        else:
            with ThreadPoolExecutor(
                    max_workers=self.max_target_rpcs,
                    thread_name_prefix="master-mass-repair-rpc") as pool:
                list(pool.map(lambda kv: run_target(*kv),
                              by_target.items()))
        REPAIR_BATCH_SECONDS.observe(time.monotonic() - t0)
        self._refresh_gauges()
        return results

    def _target_stub(self, node_id: str):
        from ..shell.ec_commands import _node_grpc  # one address rule

        return rpclib.volume_server_stub(
            _node_grpc(node_id), timeout=self.rpc_timeout_s)

    def _finish(self, job: dict, rebuilt: "list[int] | None" = None,
                used_partial: bool = False, error: str = "") -> dict:
        key = job["key"]
        if not error:
            self.journal.update(
                key, state="done", used_partial=used_partial,
                detail=f"rebuilt {sorted(rebuilt or [])}")
            REPAIR_BATCH_JOBS.labels("ok").inc()
            done_bytes = int(job.get("bytes") or 0)
            REPAIR_BATCH_BYTES.inc(done_bytes)
            with self._lock:
                self._remaining_bytes = max(
                    0, self._remaining_bytes - done_bytes)
            self._counts["repaired"] += 1
            glog.info("mass repair: %s done on %s (rebuilt %s)",
                      key, job.get("node"), sorted(rebuilt or []))
            return {"key": key, "state": "done"}
        attempts = int(job.get("attempts", 0)) + 1
        state = "failed" if attempts < MAX_ATTEMPTS else "parked"
        self.journal.update(key, state=state, attempts=attempts,
                            error=error[:300])
        REPAIR_BATCH_JOBS.labels(
            "parked" if state == "parked" else "error").inc()
        self._counts["parked" if state == "parked" else "failed"] += 1
        glog.warning("mass repair: %s %s (attempt %d): %s",
                     key, state, attempts, error)
        return {"key": key, "state": state, "error": error[:300]}

    # -- deadline bound ---------------------------------------------------

    def rate_floor_mbps(self) -> float:
        """MBps the configured total-repair-time bound requires for the
        bytes still queued — the master pushes max(budget, this) to the
        nodes, so the shared bucket can never throttle the batch past
        its deadline (0 when no deadline or nothing queued)."""
        with self._lock:
            if (self.deadline_s <= 0 or self._deadline_at <= 0
                    or self._remaining_bytes <= 0):
                return 0.0
            left_s = max(self._deadline_at - time.monotonic(), 1.0)
            return self._remaining_bytes / left_s / (1 << 20)

    def _refresh_gauges(self) -> None:
        REPAIR_BATCH_QUEUE_DEPTH.set(len(
            [j for j in self.journal.active()
             if j.get("transition") == TRANSITION]))
        with self._lock:
            if self.deadline_s <= 0 or self._deadline_at <= 0:
                REPAIR_BATCH_DEADLINE_SLACK.set(0.0)
                return
            left_s = self._deadline_at - time.monotonic()
            rate = self.controller.bucket.rate  # bytes/s budget
            projected = (self._remaining_bytes / rate) if rate > 0 else 0.0
            REPAIR_BATCH_DEADLINE_SLACK.set(left_s - projected)

    # -- status -----------------------------------------------------------

    def status(self) -> dict:
        jobs = [j for j in self.journal.jobs()
                if j.get("transition") == TRANSITION]
        with self._lock:
            deadline_left = (self._deadline_at - time.monotonic()
                             if self._deadline_at > 0 else 0.0)
            remaining = self._remaining_bytes
        return {
            "enabled": self.enabled,
            "deadlineSeconds": self.deadline_s,
            "deadlineLeftSeconds": round(deadline_left, 1),
            "remainingBytes": remaining,
            "rateFloorMBps": round(self.rate_floor_mbps(), 2),
            "counts": dict(self._counts),
            "pending": len([j for j in jobs
                            if j.get("state") in ACTIVE_STATES]),
            "jobs": jobs[-64:],
        }
