"""Master-resident lifecycle controller: evaluate policies, run jobs — the
port's copy of seaweedfs_tpu/maintenance/controller.py.

  * `evaluate()` scans heartbeat-fed topology state against the
    per-collection `PolicySet` and plans transitions — seal
    (fullness/age), ttl_expire, ec_encode (cool-down; the volume server's
    VolumeEcShardsGenerate, on its codec: the card for a port server),
    tier (the sealed, encoded .dat moved to a remote backend),
    vacuum (garbage ratio), rebalance (node skew, reusing the shell's
    move planner);
  * plans become journaled jobs, duplicate-suppressed by
    (volume, transition) and replayed across master restarts — every
    underlying RPC (VolumeMarkReadonly, VolumeEcShardsGenerate,
    VolumeTierMoveDatToRemote, VacuumVolume*, VolumeCopy) is idempotent
    or two-phase, so a resumed job re-runs safely;
  * execution is bounded per node (one transition at a time per volume
    server by default), paced by a cluster-wide bytes/s token bucket
    (the scrubber's TokenBucket; the bucket's rate is also pushed to
    volume servers in heartbeat acks so scrub + lifecycle drain one
    per-node budget), and backs off while the executor queue-depth gauges
    show serving pools saturated.

A bad persisted policy file is warned about and the defaults stand, as in
the reference.

Fault points: `lifecycle.job.run` fires before each job executes,
`lifecycle.journal.write` before each journal append.  Threads are named
`master-lifecycle*`; `stop()` joins them.
"""

from __future__ import annotations

import json
import os
import threading
import time

import grpc

from ..pb import rpc as rpclib
from ..pb import volume_server_pb2 as vs
from ..stats.metrics import (
    LIFECYCLE_BYTES,
    LIFECYCLE_JOBS,
    LIFECYCLE_QUEUE_DEPTH,
    LIFECYCLE_SECONDS,
    LIFECYCLE_TRANSITIONS,
)
from ..storage.scrub import TokenBucket, _saturation
from ..storage.ttl import TTL
from ..util import faultpoint, glog
from .journal import ACTIVE_STATES, JobJournal, job_key
from .policy import PolicySet

FP_JOB_RUN = faultpoint.register("lifecycle.job.run")

RATE_ENV = "SEAWEEDFS_TPU_LIFECYCLE_RATE_MBPS"
WORKERS_ENV = "SEAWEEDFS_TPU_LIFECYCLE_WORKERS"
BACKOFF_DEPTH_ENV = "SEAWEEDFS_TPU_LIFECYCLE_BACKOFF_QUEUE_DEPTH"

POLICY_FILE = "lifecycle.policy.json"

# "mass_repair" jobs share this journal (so dedup + crash-safe resume
# are one mechanism) but are planned and executed by the
# MassRepairOrchestrator, never by this controller's executor
TRANSITIONS = ("seal", "ttl_expire", "ec_encode", "tier", "vacuum",
               "rebalance", "mass_repair")

MAX_ATTEMPTS = 3
# how long a finished vacuum/rebalance suppresses re-planning the same
# (volume, transition); seal/ec/tier/ttl are permanently suppressed by
# the topology state itself (read_only flag, EC shard set, deleted vid)
REISSUE_AFTER_S = {"vacuum": 600.0, "rebalance": 600.0}


class LifecycleController:
    def __init__(
        self,
        master,
        policies: PolicySet | None = None,
        interval_s: float = 0.0,
        rate_mbps: float | None = None,
        journal_dir: str = "",
        max_workers: int | None = None,
        per_node: int = 1,
    ):
        self.master = master
        self.interval_s = interval_s
        self.journal_dir = journal_dir
        if rate_mbps is None:
            rate_mbps = float(os.environ.get(RATE_ENV, "0"))
        self.rate_mbps = rate_mbps
        # rate<=0 = unthrottled (a huge bucket, like scrub's disable path)
        self.bucket = TokenBucket(
            rate_mbps * (1 << 20) if rate_mbps > 0 else float(1 << 40))
        self.backoff_depth = float(
            os.environ.get(BACKOFF_DEPTH_ENV, "8"))
        self.per_node = max(per_node, 1)
        journal_path = (
            os.path.join(journal_dir, "lifecycle.journal.jsonl")
            if journal_dir else None)
        self.journal = JobJournal(journal_path)
        for rec in self.journal.jobs(("pending",)):
            if rec.get("resumed"):
                LIFECYCLE_JOBS.labels(rec["transition"], "resumed").inc()
        # policy precedence: persisted file (an operator's -policy set)
        # first, then an explicit constructor/CLI policy on top
        self.policies = self._load_policy_file() or PolicySet()
        if policies is not None:
            self.policies = policies
            self._save_policy_file()
        if max_workers is None:
            max_workers = int(os.environ.get(WORKERS_ENV, "4"))
        from ..util.executors import MeteredThreadPoolExecutor

        # the executor label stays "lifecycle": the saturation backoff
        # leaves this pool's own queue out (storage/scrub.py)
        self._pool = MeteredThreadPoolExecutor(
            max_workers=max_workers, name="lifecycle",
            thread_name_prefix="master-lifecycle")
        self._node_gates: dict[str, threading.Semaphore] = {}
        self._gates_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._emergency: list[threading.Thread] = []
        self._run_lock = threading.Lock()  # one run_once at a time
        self._counts = {"cycles": 0, "planned": 0, "executed": 0,
                        "errors": 0, "throttle_seconds": 0.0,
                        "backoff_seconds": 0.0, "emergency": 0}
        self._last_cycle = 0.0
        # disk-fault plane: per-node rate limit for the low-space
        # emergency reaction (the node keeps heartbeating low_space
        # until space actually frees)
        self._low_space_last: dict[str, float] = {}
        self._low_space_lock = threading.Lock()
        LIFECYCLE_QUEUE_DEPTH.set(len(self.journal.active()))

    # -- policy persistence -----------------------------------------------

    def _policy_path(self) -> str | None:
        return (os.path.join(self.journal_dir, POLICY_FILE)
                if self.journal_dir else None)

    def _load_policy_file(self) -> PolicySet | None:
        path = self._policy_path()
        if not path:
            return None
        try:
            with open(path) as f:
                return PolicySet.parse(json.load(f))
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            glog.warning("lifecycle: bad policy file %s: %s", path, e)
            return None

    def _save_policy_file(self) -> None:
        path = self._policy_path()
        if not path:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.policies.dumps())
        os.replace(tmp, path)

    def set_policies(self, doc) -> PolicySet:
        self.policies = PolicySet.parse(doc)
        self._save_policy_file()
        return self.policies

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self.interval_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="master-lifecycle-controller",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the loop and join every thread of the controller: the
        loop, the workers (a running job finishes its current rpc;
        queued ones are cancelled) and the emergency runners."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        self._pool.shutdown(wait=True, cancel_futures=True)
        for th in list(self._emergency):
            th.join(timeout=30.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            if not self.master.is_leader():
                continue
            try:
                self.run_once()
            except Exception as e:  # the loop must survive, not go mute
                glog.warning("lifecycle cycle failed: %s", e)

    # -- evaluation -------------------------------------------------------

    def _volume_states(self) -> tuple[dict, set, dict]:
        """Aggregate per-volume state across replicas from the live
        (heartbeat-fed) topology: -> (vid -> state dict, ec vid set,
        node -> volume count)."""
        topo = self.master.topo
        states: dict[int, dict] = {}
        ec_vids: set[int] = set()
        node_counts: dict[str, int] = {}
        with topo.lock:
            for n in topo.nodes.values():
                node_counts[n.id] = len(n.volumes)
                ec_vids.update(n.ec_shards)
                for vid, v in n.volumes.items():
                    st = states.setdefault(vid, {
                        "volume_id": vid, "collection": v.collection,
                        "size": 0, "holders": [], "read_only": True,
                        "modified": 0, "ttl": 0, "garbage": 0.0,
                    })
                    st["holders"].append(n.id)
                    st["size"] = max(st["size"], v.size)
                    st["collection"] = v.collection
                    # sealed means sealed EVERYWHERE; a half-sealed
                    # volume re-plans seal until every replica froze
                    st["read_only"] = st["read_only"] and v.read_only
                    st["modified"] = max(st["modified"],
                                         v.modified_at_second)
                    st["ttl"] = v.ttl
                    if v.size:
                        st["garbage"] = max(
                            st["garbage"], v.deleted_byte_count / v.size)
        return states, ec_vids, node_counts

    def evaluate(self, now: float | None = None) -> list[dict]:
        """Plan transitions from current topology state.  Pure decision
        logic — nothing is journaled or executed here."""
        if now is None:
            now = time.time()
        states, ec_vids, node_counts = self._volume_states()
        limit = self.master.topo.volume_size_limit
        plans: list[dict] = []
        for vid, st in sorted(states.items()):
            pol = self.policies.for_collection(st["collection"])
            quiet = now - st["modified"] if st["modified"] > 0 else -1.0
            plan = self._plan_volume(vid, st, pol, quiet, limit, ec_vids,
                                     now)
            if plan is not None:
                plans.append(plan)
        plans.extend(self._plan_rebalance(node_counts, states))
        return plans

    def _plan_volume(self, vid, st, pol, quiet, limit, ec_vids, now):
        mk = self._mk_plan
        # ttl_expire first: an expired volume needs no other care
        if (pol.ttl_expire
                and TTL.from_uint32(st["ttl"]).expired(st["modified"],
                                                       now=now)):
            return mk(vid, "ttl_expire", st, bytes_=0)
        if not st["read_only"]:
            full = (pol.seal_full_percent > 0 and limit
                    and st["size"] >= limit * pol.seal_full_percent / 100.0)
            aged = (pol.seal_age_seconds > 0 and quiet >= 0
                    and quiet >= pol.seal_age_seconds and st["size"] > 0)
            if full or aged:
                return mk(vid, "seal", st, bytes_=0)
            if (pol.vacuum_garbage_ratio > 0
                    and st["garbage"] >= pol.vacuum_garbage_ratio):
                # carry the POLICY ratio: execution must gate on the
                # same threshold planning used, not the master's global
                # default (a 0.1 policy against a 0.3 default would
                # plan forever and compact never)
                return mk(vid, "vacuum", st, bytes_=st["size"],
                          ratio=pol.vacuum_garbage_ratio)
            return None
        # sealed: encode when cold, then tier the .dat
        if (pol.ec_cooldown_seconds >= 0 and vid not in ec_vids
                and st["size"] > 0
                and quiet >= pol.ec_cooldown_seconds):
            return mk(vid, "ec_encode", st, bytes_=st["size"],
                      codec=pol.ec_codec,
                      # when a tier stage follows, the source volume
                      # must survive the encode so its .dat can move
                      keep_source=bool(pol.tier_backend))
        if (pol.tier_backend and st["size"] > 0
                and (pol.ec_cooldown_seconds < 0 or vid in ec_vids)
                and quiet >= pol.tier_idle_seconds):
            return mk(vid, "tier", st, bytes_=st["size"],
                      backend=pol.tier_backend,
                      keep_local=pol.keep_local_dat)
        return None

    # -- low-space emergency (disk-fault plane) ---------------------------

    LOW_SPACE_COOLDOWN_S = 30.0
    EMERGENCY_GARBAGE_RATIO = 0.01

    def note_low_space(self, node_id: str) -> list[dict]:
        """Heartbeat-ingest trigger: a node reports a low_space/full
        disk.  Plan emergency space recovery for the volumes it holds —
        vacuum anything with garbage (policy quiet windows and ratios
        bypassed, read-only-full volumes INCLUDED via force), and tier
        sealed volumes out when the collection's policy has a tier
        backend.  Rate-limited per node; executes asynchronously on the
        worker pool.  -> the accepted jobs."""
        now = time.monotonic()
        with self._low_space_lock:
            if (now - self._low_space_last.get(node_id, 0.0)
                    < self.LOW_SPACE_COOLDOWN_S):
                return []
            self._low_space_last[node_id] = now
        plans = self.plan_emergency(node_id)
        accepted = self.submit(plans)
        if accepted and not self._stop.is_set():
            self._counts["emergency"] += len(accepted)
            glog.warning(
                "lifecycle: node %s low on space — emergency %s",
                node_id, [j["key"] for j in accepted])
            keys = {j["key"] for j in accepted}
            th = threading.Thread(
                target=self.run_pending, kwargs={"wait": True,
                                                 "keys": keys},
                name="master-lifecycle-emergency", daemon=True)
            self._emergency = [t for t in self._emergency
                               if t.is_alive()] + [th]
            th.start()
        return accepted

    def plan_emergency(self, node_id: str) -> list[dict]:
        """Pure: space-recovery plans for volumes held on `node_id`."""
        states, ec_vids, _counts = self._volume_states()
        with self.master.topo.lock:
            node = self.master.topo.nodes.get(node_id)
            free_bytes = min(
                (d.get("free_bytes", 0)
                 for d in (node.disk_health if node else {}).values()),
                default=0)
        plans: list[dict] = []
        for vid, st in sorted(states.items()):
            if node_id not in st["holders"]:
                continue
            # compaction writes the volume's LIVE bytes to a .cpd on the
            # SAME disk: planning one that cannot fit would burn the
            # reserved delete headroom on a doomed copy and park the job
            live = int(st["size"] * (1.0 - st["garbage"]))
            fits = free_bytes == 0 or free_bytes > live * 1.1 + (4 << 20)
            pol = self.policies.for_collection(st["collection"])
            if st["garbage"] >= self.EMERGENCY_GARBAGE_RATIO and fits:
                plans.append(self._mk_plan(
                    vid, "vacuum", st, bytes_=st["size"],
                    ratio=self.EMERGENCY_GARBAGE_RATIO, force=True,
                    reason="low_space"))
            elif (pol.tier_backend and st["read_only"] and st["size"] > 0
                    and (pol.ec_cooldown_seconds < 0 or vid in ec_vids)):
                # sealed + tier-eligible: move the .dat off the node NOW
                # (idle-seconds bypassed — space is the emergency)
                plans.append(self._mk_plan(
                    vid, "tier", st, bytes_=st["size"],
                    backend=pol.tier_backend,
                    keep_local=False, reason="low_space"))
        return plans

    def _mk_plan(self, vid, transition, st, bytes_=0, **extra) -> dict:
        return {
            "key": job_key(vid, transition),
            "volume_id": vid, "transition": transition,
            "collection": st["collection"], "node": st["holders"][0],
            "holders": sorted(st["holders"]), "bytes": int(bytes_),
            **extra,
        }

    def _plan_rebalance(self, node_counts, states) -> list[dict]:
        pol = self.policies.for_collection("*")
        skews = [p.rebalance_skew for p in self.policies.policies.values()
                 if p.rebalance_skew > 0]
        skew = min(skews) if skews else pol.rebalance_skew
        if skew <= 0 or len(node_counts) < 2:
            return []
        if (max(node_counts.values()) - min(node_counts.values())) <= skew:
            return []
        from ..shell.volume_commands import plan_volume_balance_moves

        moves = plan_volume_balance_moves(
            self.master.topo.to_topology_info())
        plans = []
        for mv in moves:
            st = states.get(mv["volumeId"])
            if st is None:
                continue
            plans.append({
                "key": job_key(mv["volumeId"], "rebalance"),
                "volume_id": mv["volumeId"], "transition": "rebalance",
                "collection": st["collection"], "node": mv["source"],
                "holders": sorted(st["holders"]), "bytes": st["size"],
                "source": mv["source"], "target": mv["target"],
            })
        return plans

    # -- submission (journal + dedup) -------------------------------------

    def submit(self, plans: list[dict]) -> list[dict]:
        """Journal new jobs; duplicates (active job on the same
        (volume, transition), a volume with ANY active job, or a
        recently-finished reissuable transition) are suppressed."""
        now_ms = int(time.time() * 1000)
        active_vids = {j["volume_id"] for j in self.journal.active()}
        accepted = []
        for plan in plans:
            key = plan["key"]
            existing = self.journal.get(key)
            resurrect = False
            if existing is not None:
                state = existing.get("state")
                if state in ACTIVE_STATES:
                    continue
                if state == "parked":
                    continue  # operator attention needed, not a retry loop
                reissue = REISSUE_AFTER_S.get(plan["transition"])
                if state == "done" and reissue is None:
                    continue  # seal/ec/tier/ttl: done is done
                if (state in ("done", "failed") and reissue is not None
                        and now_ms - existing.get("updated_ms", 0)
                        < reissue * 1000):
                    continue
                # a failed job comes back as the SAME record (attempts
                # preserved) so MAX_ATTEMPTS eventually parks it instead
                # of retrying forever with a fresh counter
                resurrect = state == "failed"
            if plan["volume_id"] in active_vids:
                # one transition at a time per volume: a vacuum must not
                # race the seal that is flipping the same volume
                continue
            try:
                if resurrect:
                    fields = {k: v for k, v in plan.items()
                              if k not in ("key",)}
                    job = self.journal.update(key, state="pending",
                                              **fields)
                    if job is None:
                        continue
                else:
                    job = {**plan, "state": "pending", "attempts": 0,
                           "created_ms": now_ms}
                    self.journal.put(job)
            except Exception as e:  # journal write failed: no job
                glog.warning("lifecycle: journal write for %s failed: %s",
                             key, e)
                LIFECYCLE_JOBS.labels(plan["transition"], "error").inc()
                continue
            active_vids.add(plan["volume_id"])
            accepted.append(job)
            self._counts["planned"] += 1
        LIFECYCLE_QUEUE_DEPTH.set(len(self.journal.active()))
        return accepted

    # -- execution --------------------------------------------------------

    def _gate(self, node: str) -> threading.Semaphore:
        with self._gates_lock:
            gate = self._node_gates.get(node)
            if gate is None:
                gate = threading.Semaphore(self.per_node)
                self._node_gates[node] = gate
            return gate

    def run_pending(self, wait: bool = True,
                    keys: "set[str] | None" = None) -> list[dict]:
        """Execute pending journaled jobs on the worker pool.  `keys`
        restricts execution to that job set (a scoped
        `volume.lifecycle -apply -volumeId=…` must not drain unrelated
        resumed/queued jobs as a side effect); None runs everything."""
        pending = [j for j in self.journal.jobs(("pending",))
                   if (keys is None or j["key"] in keys)
                   # mass-repair jobs ride this journal for dedup +
                   # crash-safe resume, but the orchestrator drives them
                   # (one batched rpc per target node, not one worker
                   # per volume)
                   and j.get("transition") != "mass_repair"]
        try:
            futures = [(j, self._pool.submit(self._run_job, j))
                       for j in pending]
        except RuntimeError:  # the pool shut down: the master is stopping
            return []
        results = []
        if wait:
            for job, fut in futures:
                try:
                    results.append(fut.result())
                except Exception as e:  # noqa: BLE001 — per-job isolation
                    glog.warning("lifecycle job %s failed: %s",
                                 job["key"], e)
        LIFECYCLE_QUEUE_DEPTH.set(len(self.journal.active()))
        return results

    def run_once(self) -> dict:
        """One controller cycle: evaluate -> journal -> execute."""
        with self._run_lock:
            self._counts["cycles"] += 1
            self._last_cycle = time.time()
            planned = self.submit(self.evaluate())
            results = self.run_pending(wait=True)
            return {"planned": [j["key"] for j in planned],
                    "results": results}

    def _throttle(self, job: dict) -> None:
        # saturation backoff first (the executor queue-depth gauges),
        # then the bytes/s bucket — the scrubber's discipline.  Tier jobs
        # skip the master-side bucket: their bytes are charged where the
        # I/O happens, by the volume server's shared scrub bucket (which
        # runs at the same pushed rate) inside VolumeTierMoveDatToRemote;
        # charging both sides would bill every tiered byte twice
        while (_saturation() >= self.backoff_depth
               and not self._stop.is_set()):
            self._counts["backoff_seconds"] += 0.2
            if self._stop.wait(0.2):
                return
        n = int(job.get("bytes") or 0)
        if n > 0 and job.get("transition") != "tier":
            self._counts["throttle_seconds"] += self.bucket.consume(
                n, stop=self._stop)

    def _run_job(self, job: dict) -> dict:
        key = job["key"]
        transition = job["transition"]
        t0 = time.monotonic()
        gate = self._gate(job.get("node", ""))
        with gate:
            if not self.master.is_leader():
                # fenced: work queued before a depose must not execute
                # against volume servers the new leader now owns
                return {"key": key, "state": "fenced"}
            cur = self.journal.get(key)
            if cur is None or cur.get("state") != "pending":
                return {"key": key, "state": cur and cur.get("state")}
            self._throttle(job)
            if self._stop.is_set():
                return {"key": key, "state": "pending"}
            self.journal.update(key, state="running")
            try:
                faultpoint.inject(
                    FP_JOB_RUN, ctx=f"{transition}:{job['volume_id']}")
                detail = self._execute(job)
            except Exception as e:  # noqa: BLE001 — park after retries
                attempts = cur.get("attempts", 0) + 1
                state = "failed" if attempts < MAX_ATTEMPTS else "parked"
                self.journal.update(key, state=state, attempts=attempts,
                                    error=str(e)[:300])
                LIFECYCLE_JOBS.labels(
                    transition,
                    "parked" if state == "parked" else "error").inc()
                LIFECYCLE_TRANSITIONS.labels(transition, "error").inc()
                self._counts["errors"] += 1
                glog.warning("lifecycle %s failed (attempt %d): %s",
                             key, attempts, e)
                return {"key": key, "state": state, "error": str(e)[:300]}
        self.journal.update(key, state="done", detail=str(detail)[:300])
        LIFECYCLE_JOBS.labels(transition, "ok").inc()
        LIFECYCLE_TRANSITIONS.labels(transition, "ok").inc()
        LIFECYCLE_BYTES.labels(transition).inc(int(job.get("bytes") or 0))
        LIFECYCLE_SECONDS.labels(transition).observe(
            time.monotonic() - t0)
        self._counts["executed"] += 1
        glog.info("lifecycle: %s done (%s)", key, detail)
        return {"key": key, "state": "done", "detail": str(detail)[:300]}

    # -- transition executors ---------------------------------------------

    def _execute(self, job: dict) -> str:
        return getattr(self, f"_do_{job['transition']}")(job)

    def _stub(self, node: str):
        from ..shell.ec_commands import _node_grpc  # one address rule

        return rpclib.volume_server_stub(_node_grpc(node), timeout=600)

    def _epoch(self) -> int:
        """Fencing epoch stamped on every outgoing mutating rpc: the
        raft term this job runs under (0 = unfenced single master)."""
        return self.master.leader_epoch()

    def fence(self, term: int) -> None:
        """Deposed: queued executor work no-ops (the is_leader check at
        claim time), and the volume servers reject any still-outbound
        rpc by stale epoch."""
        self._counts["fenced"] = self._counts.get("fenced", 0) + 1
        glog.warning("lifecycle: fenced at term %d — executor queue "
                     "cancelled, running jobs will fail their journal "
                     "writes instead of racing the new leader", term)

    def _live_holders(self, job: dict) -> list[str]:
        with self.master.topo.lock:
            return [n.id for n in self.master.topo.nodes.values()
                    if job["volume_id"] in n.volumes]

    def _do_seal(self, job: dict) -> str:
        vid = job["volume_id"]
        holders = self._live_holders(job) or job["holders"]
        for node in holders:
            self._stub(node).VolumeMarkReadonly(
                vs.VolumeMarkReadonlyRequest(
                    volume_id=vid, leader_epoch=self._epoch()))
        return f"sealed on {sorted(holders)}"

    def _do_ttl_expire(self, job: dict) -> str:
        vid = job["volume_id"]
        holders = self._live_holders(job)
        if not holders:
            # ttl_expire is done-forever once journaled: succeeding
            # vacuously while every holder is offline would retain the
            # expired data for good.  Fail (retryable) instead.
            raise RuntimeError(
                f"volume {vid}: no live holder to delete from")
        for node in holders:
            self._stub(node).VolumeDelete(
                vs.VolumeDeleteRequest(
                    volume_id=vid, leader_epoch=self._epoch()))
            # drop the vid from the writable sets NOW (per holder):
            # waiting for the deleted-volume heartbeat delta would leave
            # a window where /dir/assign hands out fids on it
            self.master.unregister_from_layouts([vid], node)
        return f"expired volume deleted on {sorted(holders)}"

    def _do_ec_encode(self, job: dict) -> str:
        from ..shell.commands import CommandEnv
        from ..shell.ec_commands import do_ec_encode
        from ..storage.ec.constants import TOTAL_SHARDS

        vid = job["volume_id"]
        env = CommandEnv(f"{self.master.ip}:{self.master.grpc_port}")
        detail = do_ec_encode(
            env, self.master.topo.to_topology_info(),
            vid, job["collection"],
            codec=job.get("codec", ""), delete_source=False,
            leader_epoch=self._epoch())
        if job.get("keep_source"):
            return detail  # a tier stage follows; the sealed .dat stays
        # zero-downtime source drop: heartbeat DELTAS carry the new shard
        # locations to the master — deleting before they land sends
        # degraded reads through a lookup that cannot see the fresh
        # shards yet.  The controller runs inside the master, so it
        # waits for its own topology to cover all 14 shards.
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if len(self.master.topo.lookup_ec_shards(vid)) >= TOTAL_SHARDS:
                break
            if self._stop.wait(0.2):
                break
        for node in self._live_holders(job):
            self._stub(node).VolumeDelete(
                vs.VolumeDeleteRequest(
                    volume_id=vid, leader_epoch=self._epoch()))
        return detail + "; source volume dropped"

    def _do_tier(self, job: dict) -> str:
        vid = job["volume_id"]
        holders = self._live_holders(job) or job["holders"]
        node = job["node"] if job["node"] in holders else holders[0]
        stub = self._stub(node)
        try:
            stub.VolumeMarkReadonly(vs.VolumeMarkReadonlyRequest(
                volume_id=vid, leader_epoch=self._epoch()))
        except grpc.RpcError:
            pass  # already sealed / racing — the move checks again
        processed = 0
        try:
            for resp in stub.VolumeTierMoveDatToRemote(
                    vs.VolumeTierMoveDatToRemoteRequest(
                        volume_id=vid,
                        destination_backend_name=job["backend"],
                        keep_local_dat_file=job.get("keep_local", False),
                        leader_epoch=self._epoch())):
                processed = resp.processed
        except grpc.RpcError as e:
            if (e.code() is grpc.StatusCode.FAILED_PRECONDITION
                    and "already remote" in (e.details() or "")):
                # resumed after a crash that lost the ack: the transition
                # completed — idempotent success, not a failure
                return f"already remote on {node}"
            raise
        return f".dat -> {job['backend']} on {node} ({processed} bytes)"

    def _do_vacuum(self, job: dict) -> str:
        ok = self.master.vacuum_volume(
            job["volume_id"], threshold=job.get("ratio"),
            force=bool(job.get("force")))
        return "compacted" if ok else "skipped (ratio below threshold)"

    def _do_rebalance(self, job: dict) -> str:
        from ..shell.commands import CommandEnv
        from ..shell.volume_commands import apply_volume_move

        env = CommandEnv(f"{self.master.ip}:{self.master.grpc_port}")
        return apply_volume_move(env, {
            "volumeId": job["volume_id"],
            "source": job["source"], "target": job["target"],
        })

    # -- status -----------------------------------------------------------

    def status(self) -> dict:
        jobs = self.journal.jobs()
        return {
            "enabled": self.interval_s > 0,
            "running": (self._thread is not None
                        and self._thread.is_alive()),
            "intervalSeconds": self.interval_s,
            "rateMBps": self.rate_mbps,
            "backoffQueueDepth": self.backoff_depth,
            "journalPath": self.journal.path or "",
            "policies": self.policies.to_dict(),
            "counts": dict(self._counts),
            "jobStates": self.journal.counts(),
            "lastCycle": self._last_cycle,
            "jobs": jobs[-64:],
        }
