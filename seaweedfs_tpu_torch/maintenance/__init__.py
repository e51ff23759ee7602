"""The master's maintenance plane — the port's copy of
seaweedfs_tpu/maintenance/.

A master-resident controller turns per-collection declarative policies
into journaled, idempotent background jobs:

    hot volume -> seal -> EC-encode (on the volume servers' cards) -> tier
                  vacuum / rebalance / ttl-expire

and a mass-repair orchestrator turns a dead volume server into one
planned batch of rebuilds on the survivors.  Policies are evaluated
against heartbeat-fed topology state, jobs are persisted to a crash-safe
journal (replayed on master restart, duplicate-suppressed by (volume,
transition) key), and execution is paced by a cluster-wide bytes/s token
bucket plus the executor saturation gauges, so background traffic never
starves foreground I/O.  The tier stage keeps the source volume through
its encode (`keep_source`) and then moves the sealed `.dat` to the
policy's remote backend (storage/backend_s3.py).
"""

from .controller import LifecycleController, TRANSITIONS
from .journal import JobJournal
from .mass_repair import MassRepairOrchestrator
from .policy import LifecyclePolicy, PolicySet

__all__ = [
    "JobJournal",
    "LifecycleController",
    "LifecyclePolicy",
    "MassRepairOrchestrator",
    "PolicySet",
    "TRANSITIONS",
]
