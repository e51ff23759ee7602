"""Filer fleet — the port's copy of the part of seaweedfs_tpu/filer/fleet
that one filer needs: `tenant` (per-tenant namespaces with quotas and
weighted-fair-queueing admission on the filer's serving executors).

Not ported yet (ROADMAP A-7): the consistent-hash `ring`, the gateway's
`router` and `fleet_client`, which shard the namespace over many filers.
"""

from .tenant import (
    AdmissionController,
    QuotaExceededError,
    SlowDownError,
    TenantManager,
    tenant_for_path,
)

__all__ = [
    "AdmissionController",
    "QuotaExceededError",
    "SlowDownError",
    "TenantManager",
    "tenant_for_path",
]
