"""Assign a file id (and target volume server) from the master.

Reference: weed/operation/assign_file_id.go.

The port's copy of seaweedfs_tpu/operation/assign.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..pb import master_pb2
from ..pb import rpc as rpclib
from ..util import failsafe, faultpoint

FP_ASSIGN = faultpoint.register("operation.assign")


@dataclass
class AssignResult:
    fid: str
    url: str
    public_url: str
    count: int
    auth: str = ""

    def fid_url(self) -> str:
        return f"http://{self.url}/{self.fid}"


def assign(
    master_grpc: str,
    count: int = 1,
    collection: str = "",
    replication: str = "",
    ttl: str = "",
    data_center: str = "",
    rack: str = "",
    timeout: float = 30.0,
) -> AssignResult:
    resp = rpclib.master_stub(master_grpc, timeout=timeout).Assign(
        master_pb2.AssignRequest(
            count=count,
            collection=collection,
            replication=replication,
            ttl=ttl,
            data_center=data_center,
            rack=rack,
        )
    )
    if resp.error:
        raise RuntimeError(f"assign: {resp.error}")
    return AssignResult(
        fid=resp.fid,
        url=resp.url,
        public_url=resp.public_url or resp.url,
        count=int(resp.count or count),
        auth=resp.auth,
    )


def assign_any(master_grpcs: list[str], **kwargs) -> AssignResult:
    """Try each master in turn (leader chasing for one-shot callers),
    under the shared failover policy: breaker-gated per master, jittered
    backoff between full rounds.  Assign is idempotent (an orphaned fid
    costs one needle slot, never corrupts data), so everything transient
    retries."""

    def attempt(master: str) -> AssignResult:
        faultpoint.inject(FP_ASSIGN, ctx=master)
        return assign(master, **kwargs)

    try:
        return failsafe.call_with_failover(
            list(master_grpcs), attempt, op="assign",
            retry_type="operation", policy=failsafe.RPC_POLICY,
            idempotent=True,
        )
    except Exception as e:
        raise RuntimeError(f"assign failed on all masters: {e}") from e
