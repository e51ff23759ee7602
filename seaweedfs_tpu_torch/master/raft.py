"""Raft consensus for the master quorum — the port's copy of
seaweedfs_tpu/master/raft.py.

Reference: weed/server/raft_server.go:21-46 (chrislusf/raft over the master
HTTP port, state machine = MaxVolumeId only) and topology/cluster_commands.go
(the MaxVolumeIdCommand).  Re-implemented from the Raft paper rather than
ported: leader election with randomized timeouts, log replication with the
commit-only-current-term rule, and the election restriction on log
up-to-dateness.  The applied state is a small key->int map (op "max_vid"),
so the log stays tiny (one entry per volume growth) and no snapshot/
InstallSnapshot machinery is needed at master scale.

Transport is pluggable: tests inject an in-memory send function; the
MasterServer wires an HTTP JSON POST to each peer's /cluster/raft endpoint
(the reference also multiplexes raft onto the master HTTP listener).

Port differences:
  * `stop()` joins every thread the node started (the election and
    replication loops, the role-change callbacks and the peer rpc pool);
    the reference leaves daemon threads.  Threads are named
    ``master-raft-*``.
  * A reference fault, repaired: the reference's leader waits for every
    peer's answer (up to 2 s) in each replication round and renews its
    check-quorum lease only after the round, so one slow follower (a
    restarted master applying its log) stalls the heartbeats to the
    others and deposes the leader although a majority answered: the
    quorum then re-elects without end.  Here each follower has at most
    one append and one heartbeat in flight (a heartbeat goes out while
    an append is still being flushed, its commit index capped at the
    follower's known match), answers are taken as they come, and the
    lease counts from the moment a majority was last heard.
  * A reference fault, repaired: the reference flushes the log and
    applies committed entries (journal records flushed in turn) under the
    node lock, and a follower stamps its election clock before its
    flush.  On a disk busy with shard writes a flush can take longer than
    an election timeout, so a healthy leader went silent or a follower
    started an election at once.  Here a leader's proposal is flushed
    outside the lock (the leader counts itself toward a commit only once
    its own copy is durable, as Raft requires), committed entries are
    applied outside it, in log order, once each; a follower flushes
    appended entries outside the lock too, answering heartbeats
    meanwhile, and acknowledges entries only once they are durable.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import random
import threading
import time
from dataclasses import dataclass

from ..util import faultpoint, glog

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

_ROLE_CODE = {FOLLOWER: 0, CANDIDATE: 1, LEADER: 2}

# partition chaos: fires before every outbound raft rpc with
# ctx "<src>-><dst>:<type>", so a `match` substring arms symmetric
# ("8001"), one-way ("a->b") or rpc-type-scoped (":append") drops and
# delays — the asymmetric-partition shapes the paper's safety argument
# must survive
FP_SEND = faultpoint.register("raft.send")


@dataclass
class LogEntry:
    term: int
    command: dict

    def to_json(self) -> dict:
        return {"term": self.term, "command": self.command}

    @staticmethod
    def from_json(d: dict) -> "LogEntry":
        return LogEntry(term=d["term"], command=d["command"])


@dataclass
class Progress:
    next_index: int = 1
    match_index: int = 0


class RaftNode:
    """One consensus participant.  Thread-safe; all RPC handlers are pure
    state transitions under the node lock; timers run in daemon threads.

    ``send(peer_id, message: dict) -> dict | None`` is the transport;
    ``apply_fn(command: dict)`` is called exactly once per committed entry,
    in log order, on every node.
    """

    def __init__(
        self,
        node_id: str,
        peers: list[str],
        send,
        apply_fn=None,
        state_path: str = "",
        election_timeout: tuple[float, float] = (0.4, 0.8),
        heartbeat_interval: float = 0.12,
    ):
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.send = send
        self.apply_fn = apply_fn or (lambda cmd: None)
        self.state_path = state_path
        # fired (role, term) from a daemon thread on leadership gain/loss
        # only — the owner fences its control plane here (cancel waves on
        # depose, warm up before planning on elect)
        self.on_role_change = None

        self.lock = threading.RLock()
        self.term = 0
        self.voted_for: str | None = None
        self.log: list[LogEntry] = []  # log[i] has index i+1
        self.commit_index = 0
        self.last_applied = 0
        self.role = FOLLOWER
        self.leader_id: str | None = None
        self.progress: dict[str, Progress] = {}
        self.apply_results: dict[int, object] = {}  # log index -> apply value

        self._election_timeout = election_timeout
        self._heartbeat_interval = heartbeat_interval
        self._last_heard = time.monotonic()
        # check-quorum lease: a leader that cannot reach a majority for a
        # full election timeout steps down instead of split-brain-serving;
        # each peer's last answer is kept, and the lease counts from the
        # moment a majority was last heard
        self._peer_heard: dict[str, float] = {}
        self._lead_since = time.monotonic()
        # one append and one heartbeat in flight per follower: a slow one
        # is not sent a second round, and never holds up the others'
        self._inflight: dict[tuple[str, str], concurrent.futures.Future] = {}
        self._stop = threading.Event()
        self._commit_cv = threading.Condition(self.lock)
        # parallel peer RPC pool: one slow/dead peer must never serialize an
        # election or heartbeat round (it livelocks two live candidates)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2 * len(self.peers), 1),
            thread_name_prefix=f"master-raft-rpc-{node_id}",
        )
        self._threads: list[threading.Thread] = []
        # persistence outside the node lock: every state change bumps
        # _version under self.lock; a write skips a version older than the
        # one on disk, so an out-of-order writer never regresses the file
        self._persist_lock = threading.Lock()
        self._version = 0
        self._written = 0
        self._durable = 0  # log entries known flushed on this node
        self._truncations = 0  # a flush snapshot older than one is stale
        # applies run outside the node lock, one thread at a time
        self._apply_lock = threading.Lock()
        self._load_state()
        self._durable = len(self.log)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for name, fn in ((f"master-raft-elect-{self.id}", self._election_loop),
                         (f"master-raft-lead-{self.id}", self._leader_loop)):
            th = threading.Thread(target=fn, daemon=True, name=name)
            th.start()
            self._track(th)

    def _track(self, th: threading.Thread) -> None:
        with self.lock:
            self._threads = [t for t in self._threads if t.is_alive()] + [th]

    def stop(self) -> None:
        """Stop the loops and join every thread the node started; a
        role-change callback in progress sees the node stopped (its
        propose returns False) and ends."""
        self._stop.set()
        with self.lock:
            self._commit_cv.notify_all()
            threads = list(self._threads)
        me = threading.current_thread()
        for th in threads:
            if th is not me:
                th.join(timeout=30.0)
        self._pool.shutdown(wait=True, cancel_futures=True)

    # -- persistence ---------------------------------------------------------

    def _load_state(self) -> None:
        if not self.state_path or not os.path.exists(self.state_path):
            return
        try:
            with open(self.state_path) as f:
                d = json.load(f)
            self.term = d.get("term", 0)
            self.voted_for = d.get("voted_for")
            self.log = [LogEntry.from_json(e) for e in d.get("log", [])]
        except (OSError, ValueError, KeyError):
            pass

    def _state_doc(self) -> dict:
        return {
            "term": self.term,
            "voted_for": self.voted_for,
            "log": [e.to_json() for e in self.log],
        }

    def _persist(self) -> None:
        """Flush term, vote and log now; the caller holds self.lock."""
        self._version += 1
        self._write_state(self._version, self._state_doc())
        self._durable = len(self.log)

    def _write_state(self, version: int, doc: dict) -> None:
        if not self.state_path:
            return
        with self._persist_lock:
            if version <= self._written:
                return  # a newer state is on disk already
            tmp = self.state_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
                # raft's stable-storage requirement: term/vote must survive
                # a crash BEFORE any RPC response leaks them, or a node can
                # vote twice in one term after power loss
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.state_path)
            dir_fd = os.open(os.path.dirname(self.state_path) or ".",
                             os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
            self._written = version

    # -- log helpers ---------------------------------------------------------

    def _last_index(self) -> int:
        return len(self.log)

    def _term_at(self, index: int) -> int:
        if index == 0:
            return 0
        return self.log[index - 1].term

    # -- RPC handlers (called by the transport layer) ------------------------

    def handle(self, msg: dict) -> dict:
        kind = msg.get("type")
        if kind == "vote":
            return self.handle_request_vote(msg)
        if kind == "append":
            return self.handle_append_entries(msg)
        return {"error": f"unknown raft message {kind!r}"}

    def handle_request_vote(self, msg: dict) -> dict:
        with self.lock:
            term = msg["term"]
            if term > self.term:
                self._become_follower(term)
            granted = False
            if term == self.term and self.voted_for in (None, msg["candidate"]):
                # election restriction: candidate log must be >= ours
                up_to_date = (
                    msg["last_log_term"] > self._term_at(self._last_index())
                    or (
                        msg["last_log_term"] == self._term_at(self._last_index())
                        and msg["last_log_index"] >= self._last_index()
                    )
                )
                if up_to_date:
                    granted = True
                    self.voted_for = msg["candidate"]
                    self._persist()
                    self._last_heard = time.monotonic()
            return {"term": self.term, "granted": granted}

    def handle_append_entries(self, msg: dict) -> dict:
        out, flush = self._append_locked(msg)
        if flush is not None:
            # the flush runs outside the lock: heartbeats are answered
            # meanwhile, and these entries are acknowledged once durable
            version, doc, upto, truncations = flush
            self._write_state(version, doc)
            with self.lock:
                if self._truncations == truncations:
                    self._durable = max(self._durable, upto)
                out["match"] = min(out["match"], self._durable)
                # the flush is this node's time, not the leader's silence
                self._last_heard = time.monotonic()
        if out.get("success"):
            self._apply_committed(block=False)
        return out

    def _append_locked(self, msg: dict) -> tuple[dict, "tuple | None"]:
        with self.lock:
            term = msg["term"]
            if term < self.term:
                return {"term": self.term, "success": False}, None
            if term > self.term or self.role != FOLLOWER:
                self._become_follower(term)
            self.leader_id = msg["leader"]
            self._last_heard = time.monotonic()
            prev_index = msg["prev_log_index"]
            if prev_index > self._last_index() or (
                prev_index > 0
                and self._term_at(prev_index) != msg["prev_log_term"]
            ):
                return {"term": self.term, "success": False,
                        "hint": min(prev_index, self._last_index() + 1)}, None
            entries = [LogEntry.from_json(e) for e in msg.get("entries", [])]
            idx = prev_index
            changed = False
            for e in entries:
                idx += 1
                if idx <= self._last_index():
                    if self._term_at(idx) != e.term:
                        del self.log[idx - 1 :]  # conflict: truncate
                        self._truncations += 1
                        self._durable = min(self._durable, idx - 1)
                        self.log.append(e)
                        changed = True
                else:
                    self.log.append(e)
                    changed = True
            flush = None
            if changed:
                self._version += 1
                flush = (self._version, self._state_doc(), self._last_index(),
                         self._truncations)
            if msg["leader_commit"] > self.commit_index:
                self.commit_index = min(msg["leader_commit"], self._last_index())
            self._note_metrics()
            match = prev_index + len(entries)
            if flush is None:
                match = min(match, self._durable)
            return {"term": self.term, "success": True, "match": match}, flush

    # -- state transitions ---------------------------------------------------

    def _become_follower(self, term: int) -> None:
        was_leader = self.role == LEADER
        if term > self.term:
            # votedFor is PER TERM (Raft fig. 2): resetting it at the same
            # term would let this node vote twice in one term after a
            # candidate->follower or check-quorum step-down
            self.voted_for = None
        self.term = term
        self.role = FOLLOWER
        self._persist()
        self._note_metrics()
        if was_leader:
            glog.warning("raft %s: deposed at term %d", self.id, term)
            self._notify_role(FOLLOWER, term)

    def _become_leader(self) -> None:
        self.role = LEADER
        self.leader_id = self.id
        self._lead_since = time.monotonic()
        self._peer_heard = {}
        self._inflight = {}
        self.progress = {
            p: Progress(next_index=self._last_index() + 1) for p in self.peers
        }
        # replicate a no-op so entries from prior terms can commit
        # (Raft §5.4.2 commit-only-current-term rule needs a current entry)
        self.log.append(LogEntry(self.term, {"op": "noop"}))
        self._persist()
        self._note_metrics()
        glog.info("raft %s: elected leader at term %d", self.id, self.term)
        self._notify_role(LEADER, self.term)

    def _notify_role(self, role: str, term: int) -> None:
        from ..stats.metrics import RAFT_LEADER_CHANGES

        RAFT_LEADER_CHANGES.labels(self.id).inc()
        cb = self.on_role_change
        if cb is not None:
            # asynchronously: the callback fences executors/journals and
            # must never run under (or wait on) the raft lock
            if self._stop.is_set():
                return
            th = threading.Thread(
                target=cb, args=(role, term), daemon=True,
                name=f"master-raft-role-{self.id}",
            )
            th.start()
            self._track(th)

    def _note_metrics(self) -> None:
        from ..stats import metrics as m

        m.RAFT_TERM.labels(self.id).set(self.term)
        m.RAFT_ROLE.labels(self.id).set(_ROLE_CODE[self.role])
        m.RAFT_COMMIT_INDEX.labels(self.id).set(self.commit_index)
        m.RAFT_LOG_ENTRIES.labels(self.id).set(len(self.log))

    def _apply_committed(self, block: bool = True) -> None:
        """Apply the committed entries not applied yet, in log order and
        once each, outside the node lock (an apply may flush state of its
        own); the caller must not hold self.lock.  `block=False` leaves
        the work to a thread already applying (a follower's answer must
        not wait on it; the next append applies what it missed)."""
        if not self._apply_lock.acquire(blocking=block):
            return
        try:
            self._apply_locked()
        finally:
            self._apply_lock.release()

    def _apply_locked(self) -> None:
        while True:
            with self.lock:
                if self.last_applied >= self.commit_index:
                    self._commit_cv.notify_all()
                    return
                index = self.last_applied + 1
                cmd = self.log[index - 1].command
            applied, result = False, None
            if cmd.get("op") != "noop":
                try:
                    result = self.apply_fn(cmd)
                    applied = True
                except Exception as e:  # an apply failure risks
                    # replica divergence — it must at least be visible
                    glog.error("raft apply of entry %d failed: %s",
                               index, e)
            with self.lock:
                self.last_applied = index
                if applied:
                    # keep recent results so propose_and_get can read
                    # the value its own entry produced (bounded window)
                    self.apply_results[index] = result
                    if len(self.apply_results) > 1024:
                        for k in sorted(self.apply_results)[:-512]:
                            del self.apply_results[k]
                self._note_metrics()
                self._commit_cv.notify_all()

    # -- election ------------------------------------------------------------

    def _election_deadline(self) -> float:
        lo, hi = self._election_timeout
        return random.uniform(lo, hi)

    def _election_loop(self) -> None:
        deadline = self._election_deadline()
        while not self._stop.is_set():
            time.sleep(0.02)
            with self.lock:
                if self.role == LEADER:
                    self._last_heard = time.monotonic()
                    # check quorum: a partitioned leader cannot commit, so
                    # keeping the LEADER role only extends the split-brain
                    # window in which it hands out assigns and repair
                    # batches another leader will conflict with
                    silent = time.monotonic() - self._majority_heard()
                    if silent > self._election_timeout[1]:
                        glog.warning(
                            "raft %s: lost quorum contact for %.1fs, "
                            "stepping down", self.id, silent)
                        self._become_follower(self.term)
                    continue
                waited = time.monotonic() - self._last_heard
            if waited >= deadline:
                self._run_election()
                deadline = self._election_deadline()

    def _run_election(self) -> None:
        with self.lock:
            self.role = CANDIDATE
            self.term += 1
            self.voted_for = self.id
            self.leader_id = None
            self._persist()
            self._note_metrics()
            term = self.term
            req = {
                "type": "vote",
                "term": term,
                "candidate": self.id,
                "last_log_index": self._last_index(),
                "last_log_term": self._term_at(self._last_index()),
            }
            self._last_heard = time.monotonic()
        quorum = (len(self.peers) + 1) // 2 + 1
        votes = 1
        futures = list(self._submit_sends({p: req for p in self.peers}))
        try:
            for fut in concurrent.futures.as_completed(futures, timeout=2.0):
                resp = fut.result()
                if resp is None:
                    continue
                with self.lock:
                    if resp.get("term", 0) > self.term:
                        self._become_follower(resp["term"])
                        return
                    if self.term != term or self.role != CANDIDATE:
                        return  # stale election
                if resp.get("granted"):
                    votes += 1
                if votes >= quorum:
                    break  # don't wait for stragglers/dead peers
        except concurrent.futures.TimeoutError:
            pass
        with self.lock:
            if self.role == CANDIDATE and self.term == term and votes >= quorum:
                self._become_leader()

    # -- leader replication ---------------------------------------------------

    def _leader_loop(self) -> None:
        while not self._stop.is_set():
            with self.lock:
                is_leader = self.role == LEADER
            if is_leader:
                self._replicate_once()
                time.sleep(self._heartbeat_interval)
            else:
                time.sleep(0.02)

    def _majority_heard(self) -> float:
        """Monotonic time a majority (this node included) was last heard
        from: the (quorum - 1)-th most recent peer answer."""
        need = (len(self.peers) + 1) // 2  # peers besides this node
        if need == 0:
            return time.monotonic()
        heard = sorted((self._peer_heard.get(p, self._lead_since)
                        for p in self.peers), reverse=True)
        return heard[need - 1]

    def _replicate_once(self) -> None:
        """Send every follower with no append in flight one append (the
        entries past its progress, or a heartbeat), and every follower
        whose append is still in flight a heartbeat from its known match;
        wait up to a heartbeat interval for the answers, and take later
        ones when they come."""
        with self.lock:
            if self.role != LEADER:
                return
            term = self.term
            reqs = {}
            for p in self.peers:
                prog = self.progress[p]
                if self._inflight.get((p, "append")) is None:
                    kind, prev = "append", prog.next_index - 1
                    entries = [e.to_json()
                               for e in self.log[prog.next_index - 1 :]]
                    commit = self.commit_index
                elif self._inflight.get((p, "beat")) is None:
                    # the follower agrees with this log up to its match;
                    # it must not commit past it on a heartbeat's word
                    kind, prev, entries = "beat", prog.match_index, []
                    commit = min(self.commit_index, prog.match_index)
                else:
                    continue
                reqs[(p, kind)] = {
                    "type": "append",
                    "term": term,
                    "leader": self.id,
                    "prev_log_index": prev,
                    "prev_log_term": self._term_at(prev),
                    "entries": entries,
                    "leader_commit": commit,
                }
        futures = self._submit_sends(reqs)
        with self.lock:
            for fut, slot in futures.items():
                self._inflight[slot] = fut
        for fut, slot in futures.items():
            fut.add_done_callback(
                lambda f, slot=slot: self._on_append_reply(slot, term, f))
        concurrent.futures.wait(list(futures),
                                timeout=self._heartbeat_interval)

    def _on_append_reply(self, slot: tuple[str, str], term: int,
                         fut: concurrent.futures.Future) -> None:
        peer, kind = slot
        with self.lock:
            if self._inflight.get(slot) is fut:
                self._inflight[slot] = None
        try:
            resp = fut.result()
        except Exception:  # noqa: BLE001 — cancelled at stop
            return
        if resp is None:
            return
        with self.lock:
            if resp.get("term", 0) > self.term:
                self._become_follower(resp["term"])
                return
            if self.role != LEADER or self.term != term:
                return
            # any live answer is quorum contact
            self._peer_heard[peer] = time.monotonic()
            prog = self.progress[peer]
            if resp.get("success"):
                prog.match_index = max(prog.match_index, resp.get("match", 0))
                if kind == "append":
                    prog.next_index = prog.match_index + 1
            elif kind == "append":
                prog.next_index = max(1, resp.get(
                    "hint", prog.next_index - 1))
        self._advance_commit()

    def _advance_commit(self) -> None:
        with self.lock:
            if self.role != LEADER:
                return
            for n in range(self._last_index(), self.commit_index, -1):
                if self._term_at(n) != self.term:
                    break  # only commit entries from the current term
                # this node counts once its own copy is durable
                count = int(self._durable >= n) + sum(
                    1 for p in self.peers if self.progress[p].match_index >= n
                )
                if count >= (len(self.peers) + 1) // 2 + 1:
                    self.commit_index = n
                    self._note_metrics()
                    break
        self._apply_committed()

    def _send_to(self, peer: str, msg: dict) -> dict | None:
        from ..stats.metrics import RAFT_RPC

        kind = msg.get("type", "?")
        try:
            # drop / delay / one-way partitions arm here by ctx substring
            faultpoint.inject(FP_SEND, ctx=f"{self.id}->{peer}:{kind}")
        except Exception:
            RAFT_RPC.labels(kind, "dropped").inc()
            return None
        try:
            resp = self.send(peer, msg)
        except Exception:
            RAFT_RPC.labels(kind, "error").inc()
            return None
        RAFT_RPC.labels(kind, "ok").inc()
        return resp

    def _submit_sends(self, reqs: dict) -> dict:
        """Submit parallel peer sends; {} once the node is stopping (the
        pool rejects new futures after shutdown)."""
        if self._stop.is_set():
            return {}
        try:
            # a key is a peer, or (peer, kind) for a leader's round
            return {
                self._pool.submit(self._send_to, key[0] if isinstance(
                    key, tuple) else key, req): key
                for key, req in reqs.items()
            }
        except RuntimeError:  # pool shut down concurrently
            return {}

    # -- client API ----------------------------------------------------------

    def is_leader(self) -> bool:
        with self.lock:
            return self.role == LEADER

    def leader_epoch(self) -> int:
        """Fencing epoch = the term this node leads under; 0 off-throne.
        Terms are monotonic across failovers, so any rpc stamped with an
        older epoch is provably from a deposed leader."""
        with self.lock:
            return self.term if self.role == LEADER else 0

    def propose(self, command: dict, timeout: float = 5.0) -> bool:
        """Leader-only: append, replicate, wait for commit+apply."""
        ok, _ = self.propose_and_get(command, timeout)
        return ok

    def propose_and_get(self, command: dict,
                        timeout: float = 5.0) -> tuple[bool, object]:
        """Like propose, but returns (ok, value-returned-by-apply_fn).

        Commands whose outcome depends on prior state (e.g. "increment the
        max volume id") MUST compute it inside apply_fn — apply runs in log
        order on every replica, so a freshly elected leader that hasn't yet
        applied the old leader's tail cannot hand out a stale value."""
        with self.lock:
            if self.role != LEADER:
                return False, None
            appended_term = self.term
            self.log.append(LogEntry(appended_term, command))
            index = self._last_index()
            self._version += 1
            version, doc = self._version, self._state_doc()
        # the followers take the entry while this node flushes it: the
        # node lock stays free, so heartbeats never wait on the disk
        self._replicate_once()
        self._write_state(version, doc)
        with self.lock:
            if index <= self._last_index() \
                    and self._term_at(index) == appended_term:
                self._durable = max(self._durable, index)
        self._advance_commit()
        deadline = time.monotonic() + timeout
        with self.lock:
            while self.last_applied < index:
                if self.role != LEADER or self._stop.is_set():
                    return False, None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False, None
                self._commit_cv.wait(min(remaining, 0.05))
            # the committed entry at our index must still be OURS: after a
            # depose/re-elect cycle another leader's entry may occupy it,
            # and returning its apply value would hand out duplicate state
            if (index > self._last_index()
                    or self._term_at(index) != appended_term):
                return False, None
            return True, self.apply_results.get(index)
