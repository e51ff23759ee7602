"""Crash-safe lifecycle job journal — the port's copy of
seaweedfs_tpu/maintenance/journal.py.

Append-only JSONL: every job state change is one fsynced line
`{"key": "<vid>:<transition>", ...job fields...}`, and the latest line
per key wins on replay.  A master that dies mid-transition therefore
restarts with the exact job set it was executing — `running` jobs are
demoted back to `pending` (every underlying RPC is idempotent or
two-phase, so re-running them is safe), `done`/`failed` records survive
as the duplicate-suppression memory that keeps a re-evaluation from
re-emitting a finished transition.

The file is compacted (atomic tmp+rename, latest-record-per-key) once
the line count outgrows the live key set, so the journal stays bounded
no matter how long the master lives.

Fault point `lifecycle.journal.write` fires before every append — an
injected error there must fail the job loudly (never run work the
journal didn't record).

In a master quorum the `proposer` hook routes every mutation through the
raft log; records land on every member through `apply_replicated` /
`apply_drop`, and a freshly elected leader demotes the `running` records
it inherited with `resume_stale_running`.
"""

from __future__ import annotations

import json
import os
import threading
import time

from ..util import faultpoint, glog

FP_JOURNAL_WRITE = faultpoint.register("lifecycle.journal.write")

JOURNAL_NAME = "lifecycle.journal.jsonl"

# states a job moves through; "running" replays as "pending"
ACTIVE_STATES = ("pending", "running")
FINAL_STATES = ("done", "failed", "parked")


def job_key(volume_id: int, transition: str) -> str:
    return f"{volume_id}:{transition}"


class JobJournal:
    """Keyed job store with an append-only JSONL persistence layer.

    `path=None` keeps everything in memory (duplicate suppression still
    works for the life of the process; no crash safety)."""

    COMPACT_SLACK = 1024  # compact when lines exceed keys by this many

    def __init__(self, path: str | None):
        self.path = path
        self._lock = threading.Lock()
        self._jobs: dict[str, dict] = {}
        self._lines = 0
        # raft replication: when the master wires a proposer
        # (`proposer(op, payload) -> bool`, op "put"|"drop"), every
        # mutation is proposed through the raft log instead of written
        # here, and lands via apply_replicated()/apply_drop() — in log
        # order, on every quorum member — so a freshly elected leader
        # holds the exact committed job set.  A failed propose (deposed,
        # quorum lost) raises: a job the quorum didn't record must not run.
        self.proposer = None
        if path:
            self._replay()

    # -- persistence ------------------------------------------------------

    def _replay(self) -> None:
        try:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail write: later lines still count
                    if "key" in rec:
                        self._jobs[rec["key"]] = rec
                        self._lines += 1
        except FileNotFoundError:
            return
        resumed = 0
        for rec in self._jobs.values():
            if rec.get("state") == "running":
                # died mid-execution: the RPCs are idempotent, re-run it
                rec["state"] = "pending"
                rec["resumed"] = rec.get("resumed", 0) + 1
                resumed += 1
        if resumed:
            glog.warning("lifecycle journal: resuming %d in-flight job(s) "
                         "from %s", resumed, self.path)

    def _append_locked(self, rec: dict) -> None:
        faultpoint.inject(FP_JOURNAL_WRITE, ctx=rec.get("key", ""))
        if not self.path:
            return
        line = json.dumps(rec, sort_keys=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._lines += 1
        if self._lines > len(self._jobs) + self.COMPACT_SLACK:
            self._compact_locked()

    def _compact_locked(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for rec in self._jobs.values():
                f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._lines = len(self._jobs)

    # -- job API ----------------------------------------------------------

    def get(self, key: str) -> dict | None:
        with self._lock:
            rec = self._jobs.get(key)
            return dict(rec) if rec else None

    def put(self, job: dict) -> None:
        """Record a job (new or state change).  Raises on journal-write
        failure BEFORE mutating memory — a job the journal didn't record
        must not exist."""
        rec = dict(job)
        rec["updated_ms"] = int(time.time() * 1000)
        if self.proposer is not None:
            self._propose("put", rec)
            return
        with self._lock:
            self._append_locked(rec)
            self._jobs[rec["key"]] = rec

    def update(self, key: str, **changes) -> dict | None:
        if self.proposer is not None:
            # merge on the proposing leader, replicate the FULL record
            with self._lock:
                rec = self._jobs.get(key)
                if rec is None:
                    return None
                new = {**rec, **changes,
                       "updated_ms": int(time.time() * 1000)}
            self._propose("put", new)
            return dict(new)
        with self._lock:
            rec = self._jobs.get(key)
            if rec is None:
                return None
            new = {**rec, **changes,
                   "updated_ms": int(time.time() * 1000)}
            self._append_locked(new)
            self._jobs[key] = new
            return dict(new)

    def drop(self, key: str) -> None:
        if self.proposer is not None:
            self._propose("drop", {"key": key})
            return
        with self._lock:
            if self._jobs.pop(key, None) is not None and self.path:
                self._compact_locked()

    def _propose(self, op: str, payload: dict) -> None:
        # same loud-failure discipline as a local append: the write
        # faultpoint fires first, and an uncommitted propose raises so
        # the caller never runs work the quorum didn't record
        faultpoint.inject(FP_JOURNAL_WRITE, ctx=payload.get("key", ""))
        if not self.proposer(op, payload):
            raise RuntimeError(
                f"journal {op} {payload.get('key', '')!r} not committed "
                "(not the leader, or quorum unavailable)")

    def apply_replicated(self, rec: dict) -> None:
        """Raft apply_fn target: upsert one committed record into the
        local mirror (every quorum member, leader included, in log
        order).  Bypasses the write faultpoint — the fault already had
        its chance at propose time on the leader."""
        with self._lock:
            if self.path:
                line = json.dumps(rec, sort_keys=True)
                with open(self.path, "a") as f:
                    f.write(line + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                self._lines += 1
            self._jobs[rec["key"]] = dict(rec)
            if (self.path
                    and self._lines > len(self._jobs) + self.COMPACT_SLACK):
                self._compact_locked()

    def apply_drop(self, key: str) -> None:
        with self._lock:
            if self._jobs.pop(key, None) is not None and self.path:
                self._compact_locked()

    def resume_stale_running(self) -> int:
        """Failover resume: `running` records inherited from a deposed
        leader demote to `pending` with a bumped `resumed` marker —
        through the proposer when replicated, so every mirror agrees the
        job is runnable exactly once."""
        resumed = 0
        for rec in self.jobs(("running",)):
            new = self.update(rec["key"], state="pending",
                              resumed=rec.get("resumed", 0) + 1)
            if new is not None:
                resumed += 1
        if resumed:
            glog.warning("lifecycle journal: failover — demoted %d "
                         "running job(s) to pending", resumed)
        return resumed

    def jobs(self, states: tuple = ()) -> list[dict]:
        with self._lock:
            out = [dict(r) for r in self._jobs.values()
                   if not states or r.get("state") in states]
        out.sort(key=lambda r: r.get("created_ms", 0))
        return out

    def active(self) -> list[dict]:
        return self.jobs(ACTIVE_STATES)

    def counts(self) -> dict:
        with self._lock:
            out: dict[str, int] = {}
            for r in self._jobs.values():
                out[r.get("state", "?")] = out.get(r.get("state", "?"), 0) + 1
            return out
