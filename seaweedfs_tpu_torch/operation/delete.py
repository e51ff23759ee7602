"""Batched blob deletion across volume servers.

Reference: weed/operation/delete_content.go — group file ids by volume,
resolve locations, fan out BatchDelete rpcs per server.

The port's copy of seaweedfs_tpu/operation/delete.py.
"""

from __future__ import annotations

import grpc

from ..pb import rpc as rpclib
from ..pb import volume_server_pb2 as vs
from ..util import failsafe


def delete_file_id(lookup, fid: str, jwt: str = "") -> bool:
    """Delete one file id; lookup(vid) -> [Location]."""
    results = delete_file_ids(lookup, [fid])
    return results.get(fid, False)


def delete_file_ids(lookup, fids: list[str]) -> dict[str, bool]:
    """Delete many file ids; returns fid -> deleted?

    ``lookup`` is a callable vid -> [Location]; one BatchDelete rpc goes to
    the first holder of each volume (the server fans out to replicas).
    """
    by_server: dict[str, list[str]] = {}
    results: dict[str, bool] = {}
    for fid in fids:
        try:
            vid = int(fid.split(",", 1)[0])
        except ValueError:
            results[fid] = False
            continue
        locs = lookup(vid)
        if not locs:
            results[fid] = False
            continue
        grpc_addr = _grpc_address(locs[0].url)
        by_server.setdefault(grpc_addr, []).append(fid)
    for server, server_fids in by_server.items():
        # deletes are idempotent (a re-deleted needle answers not-found),
        # so transient rpc failures retry under the shared policy
        try:
            resp = failsafe.call(
                lambda s=server, f=server_fids: rpclib.volume_server_stub(
                    s, timeout=30).BatchDelete(
                        vs.BatchDeleteRequest(file_ids=f)),
                op="batch_delete", retry_type="operation",
                policy=failsafe.RPC_POLICY, peer=server, idempotent=True,
            )
            for r in resp.results:
                results[r.file_id] = not r.error
        except (grpc.RpcError, failsafe.CircuitOpenError, OSError):
            for fid in server_fids:
                results[fid] = False
    return results


def _grpc_address(http_url: str) -> str:
    host, port = http_url.rsplit(":", 1)
    return f"{host}:{int(port) + 10000}"
