"""gRPC plumbing without generated service stubs — the port's copy of
seaweedfs_tpu/pb/rpc.py for the master (`master_pb.Seaweed`) and volume
server (`volume_server_pb.VolumeServer`) services.

No grpc codegen plugin is needed: each service is declared once (method
name -> kind + message classes) and wired through grpc's generic-handler
API on the server and `channel.unary_unary/...` on the client.  Service
and method names are the reference's, so a reference stub talks to a port
server and a port stub to a reference server.

The channel cache is the port's own (one channel per address), and
`close_channels(address)` releases the channels to an address whose
server stopped.  Not ported yet: the filer, messaging and etcd services,
which come with their slices, and mTLS (`configure_security`), which
comes with the security slice.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable

import grpc

from ..telemetry import trace as _trace
from ..util import failsafe as _failsafe
from . import master_pb2, volume_server_pb2

UU, US, SU, SS = "uu", "us", "su", "ss"  # unary/stream request x response
MAX_MESSAGE_BYTES = 128 * 1024 * 1024


@dataclass(frozen=True)
class Method:
    kind: str
    request: type
    response: type


@dataclass(frozen=True)
class Service:
    name: str  # fully-qualified, e.g. "master_pb.Seaweed"
    methods: dict


def _m(kind, req, resp):
    return Method(kind, req, resp)


_M = master_pb2
MASTER = Service("master_pb.Seaweed", {
    "SendHeartbeat": _m(SS, _M.Heartbeat, _M.HeartbeatResponse),
    "KeepConnected": _m(SS, _M.KeepConnectedRequest, _M.VolumeLocation),
    "LookupVolume": _m(UU, _M.LookupVolumeRequest, _M.LookupVolumeResponse),
    "Assign": _m(UU, _M.AssignRequest, _M.AssignResponse),
    "Statistics": _m(UU, _M.StatisticsRequest, _M.StatisticsResponse),
    "CollectionList": _m(UU, _M.CollectionListRequest, _M.CollectionListResponse),
    "CollectionDelete": _m(UU, _M.CollectionDeleteRequest, _M.CollectionDeleteResponse),
    "VolumeList": _m(UU, _M.VolumeListRequest, _M.VolumeListResponse),
    "LookupEcVolume": _m(UU, _M.LookupEcVolumeRequest, _M.LookupEcVolumeResponse),
    "VacuumVolume": _m(UU, _M.VacuumVolumeRequest, _M.VacuumVolumeResponse),
    "GetMasterConfiguration": _m(UU, _M.GetMasterConfigurationRequest, _M.GetMasterConfigurationResponse),
    "ListMasterClients": _m(UU, _M.ListMasterClientsRequest, _M.ListMasterClientsResponse),
    "LeaseAdminToken": _m(UU, _M.LeaseAdminTokenRequest, _M.LeaseAdminTokenResponse),
    "ReleaseAdminToken": _m(UU, _M.ReleaseAdminTokenRequest, _M.ReleaseAdminTokenResponse),
    "Lifecycle": _m(UU, _M.LifecycleRequest, _M.LifecycleResponse),
})

_V = volume_server_pb2
VOLUME_SERVER = Service("volume_server_pb.VolumeServer", {
    "BatchDelete": _m(UU, _V.BatchDeleteRequest, _V.BatchDeleteResponse),
    "VacuumVolumeCheck": _m(UU, _V.VacuumVolumeCheckRequest, _V.VacuumVolumeCheckResponse),
    "VacuumVolumeCompact": _m(UU, _V.VacuumVolumeCompactRequest, _V.VacuumVolumeCompactResponse),
    "VacuumVolumeCommit": _m(UU, _V.VacuumVolumeCommitRequest, _V.VacuumVolumeCommitResponse),
    "VacuumVolumeCleanup": _m(UU, _V.VacuumVolumeCleanupRequest, _V.VacuumVolumeCleanupResponse),
    "DeleteCollection": _m(UU, _V.DeleteCollectionRequest, _V.DeleteCollectionResponse),
    "AllocateVolume": _m(UU, _V.AllocateVolumeRequest, _V.AllocateVolumeResponse),
    "VolumeSyncStatus": _m(UU, _V.VolumeSyncStatusRequest, _V.VolumeSyncStatusResponse),
    "VolumeIncrementalCopy": _m(US, _V.VolumeIncrementalCopyRequest, _V.VolumeIncrementalCopyResponse),
    "VolumeMount": _m(UU, _V.VolumeMountRequest, _V.VolumeMountResponse),
    "VolumeUnmount": _m(UU, _V.VolumeUnmountRequest, _V.VolumeUnmountResponse),
    "VolumeDelete": _m(UU, _V.VolumeDeleteRequest, _V.VolumeDeleteResponse),
    "VolumeMarkReadonly": _m(UU, _V.VolumeMarkReadonlyRequest, _V.VolumeMarkReadonlyResponse),
    "VolumeMarkWritable": _m(UU, _V.VolumeMarkWritableRequest, _V.VolumeMarkWritableResponse),
    "VolumeConfigure": _m(UU, _V.VolumeConfigureRequest, _V.VolumeConfigureResponse),
    "VolumeStatus": _m(UU, _V.VolumeStatusRequest, _V.VolumeStatusResponse),
    "VolumeCopy": _m(UU, _V.VolumeCopyRequest, _V.VolumeCopyResponse),
    "ReadVolumeFileStatus": _m(UU, _V.ReadVolumeFileStatusRequest, _V.ReadVolumeFileStatusResponse),
    "CopyFile": _m(US, _V.CopyFileRequest, _V.CopyFileResponse),
    "ReadNeedleBlob": _m(UU, _V.ReadNeedleBlobRequest, _V.ReadNeedleBlobResponse),
    "WriteNeedleBlob": _m(UU, _V.WriteNeedleBlobRequest, _V.WriteNeedleBlobResponse),
    "ReadAllNeedles": _m(US, _V.ReadAllNeedlesRequest, _V.ReadAllNeedlesResponse),
    "VolumeTailSender": _m(US, _V.VolumeTailSenderRequest, _V.VolumeTailSenderResponse),
    "VolumeTailReceiver": _m(UU, _V.VolumeTailReceiverRequest, _V.VolumeTailReceiverResponse),
    "VolumeEcShardsGenerate": _m(UU, _V.VolumeEcShardsGenerateRequest, _V.VolumeEcShardsGenerateResponse),
    "VolumeEcShardsRebuild": _m(UU, _V.VolumeEcShardsRebuildRequest, _V.VolumeEcShardsRebuildResponse),
    "VolumeEcShardsBatchRebuild": _m(UU, _V.VolumeEcShardsBatchRebuildRequest, _V.VolumeEcShardsBatchRebuildResponse),
    "VolumeEcShardsCopy": _m(UU, _V.VolumeEcShardsCopyRequest, _V.VolumeEcShardsCopyResponse),
    "VolumeEcShardsDelete": _m(UU, _V.VolumeEcShardsDeleteRequest, _V.VolumeEcShardsDeleteResponse),
    "VolumeEcShardsMount": _m(UU, _V.VolumeEcShardsMountRequest, _V.VolumeEcShardsMountResponse),
    "VolumeEcShardsUnmount": _m(UU, _V.VolumeEcShardsUnmountRequest, _V.VolumeEcShardsUnmountResponse),
    "VolumeEcShardRead": _m(US, _V.VolumeEcShardReadRequest, _V.VolumeEcShardReadResponse),
    "VolumeEcShardPartialApply": _m(US, _V.VolumeEcShardPartialApplyRequest, _V.VolumeEcShardPartialApplyResponse),
    "VolumeEcBlobDelete": _m(UU, _V.VolumeEcBlobDeleteRequest, _V.VolumeEcBlobDeleteResponse),
    "VolumeEcShardsToVolume": _m(UU, _V.VolumeEcShardsToVolumeRequest, _V.VolumeEcShardsToVolumeResponse),
    "VolumeTierMoveDatToRemote": _m(US, _V.VolumeTierMoveDatToRemoteRequest, _V.VolumeTierMoveDatToRemoteResponse),
    "VolumeTierMoveDatFromRemote": _m(US, _V.VolumeTierMoveDatFromRemoteRequest, _V.VolumeTierMoveDatFromRemoteResponse),
    "VolumeServerStatus": _m(UU, _V.VolumeServerStatusRequest, _V.VolumeServerStatusResponse),
    "VolumeServerLeave": _m(UU, _V.VolumeServerLeaveRequest, _V.VolumeServerLeaveResponse),
    "Query": _m(US, _V.QueryRequest, _V.QueriedStripe),
    "VolumeNeedleStatus": _m(UU, _V.VolumeNeedleStatusRequest, _V.VolumeNeedleStatusResponse),
    "VolumeScrub": _m(UU, _V.VolumeScrubRequest, _V.VolumeScrubResponse),
})


# ---------------------------------------------------------------------------
# Server side
# ---------------------------------------------------------------------------

# request-metric `type` label per service (the gRPC surface of each
# server, kept distinct from its HTTP surface's type label)
_GRPC_TYPE = {
    "master_pb.Seaweed": "masterGrpc",
    "volume_server_pb.VolumeServer": "volumeServerGrpc",
}


def _traced_unary(server_type: str, method: str, fn: Callable) -> Callable:
    """Wrap a unary-unary servicer fn with trace adoption + request
    metrics: the caller's `traceparent` rides in as gRPC metadata."""
    from ..telemetry.middleware import record_op

    def handler(request, context):
        md = {k: v for k, v in (context.invocation_metadata() or ())}
        with _trace.remote_context(md.get(_trace.TRACEPARENT)):
            with record_op(server_type, method):
                return fn(request, context)

    return handler


def _counted_stream(server_type: str, method: str, fn: Callable) -> Callable:
    """Streaming rpcs are counted but not timed (a stream's lifetime is
    not a request latency) and not spanned (the generator body outlives
    the handler call, so a scoped span would lie)."""
    from ..stats.metrics import REQUEST_COUNTER

    def handler(request_or_iterator, context):
        REQUEST_COUNTER.labels(server_type, method).inc()
        return fn(request_or_iterator, context)

    return handler


def generic_handler(service: Service, impl: object) -> grpc.GenericRpcHandler:
    """Build a GenericRpcHandler from an object with methods named like the
    service's rpcs.  Unimplemented rpcs answer UNIMPLEMENTED."""
    from ..stats.metrics import GRPC_BYTES

    handlers = {}
    server_type = _GRPC_TYPE.get(service.name, service.name)
    for name, m in service.methods.items():
        fn: Callable | None = getattr(impl, name, None)
        if fn is None:
            fn = _unimplemented(name)
        # serialized-byte accounting at the codec boundary: the exact
        # wire payload of every rpc, per method and direction.  Children
        # are created lazily on first traffic, so rpcs never called do
        # not crowd the heartbeat's stats snapshot with zeros
        rx_cell: list = []
        tx_cell: list = []

        def deser(data, _from=m.request.FromString, _cell=rx_cell,
                  _st=server_type, _n=name):
            if not _cell:
                _cell.append(GRPC_BYTES.labels(_st, _n, "rx"))
            _cell[0].inc(len(data))
            return _from(data)

        def ser(msg, _to=m.response.SerializeToString, _cell=tx_cell,
                _st=server_type, _n=name):
            blob = _to(msg)
            if not _cell:
                _cell.append(GRPC_BYTES.labels(_st, _n, "tx"))
            _cell[0].inc(len(blob))
            return blob
        if m.kind == UU:
            handlers[name] = grpc.unary_unary_rpc_method_handler(
                _traced_unary(server_type, name, fn), deser, ser)
        elif m.kind == US:
            handlers[name] = grpc.unary_stream_rpc_method_handler(
                _counted_stream(server_type, name, fn), deser, ser)
        elif m.kind == SU:
            handlers[name] = grpc.stream_unary_rpc_method_handler(
                _counted_stream(server_type, name, fn), deser, ser)
        else:
            handlers[name] = grpc.stream_stream_rpc_method_handler(
                _counted_stream(server_type, name, fn), deser, ser)
    return grpc.method_handlers_generic_handler(service.name, handlers)


def _unimplemented(name: str):
    def handler(request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, f"{name} not implemented")

    return handler


def serve(
    service_impls: "list[tuple[Service, object]]",
    port: int,
    host: str = "0.0.0.0",
    max_workers: int = 16,
    thread_name_prefix: str = "",
) -> grpc.Server:
    """Start a grpc server hosting the given services; returns it started.
    Raises RuntimeError when the port cannot be bound.  The server's
    worker pool is `server.pool`: a caller that must leave no thread
    behind shuts it down after `server.stop(...).wait()`."""
    from concurrent import futures

    pool = futures.ThreadPoolExecutor(
        max_workers=max_workers, thread_name_prefix=thread_name_prefix)
    server = grpc.server(
        pool,
        options=[
            ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
            ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
        ],
    )
    for service, impl in service_impls:
        server.add_generic_rpc_handlers((generic_handler(service, impl),))
    server.add_insecure_port(f"{host}:{port}")
    server.start()
    server.pool = pool
    return server


# ---------------------------------------------------------------------------
# Client side: a stub facade over a cached channel
# ---------------------------------------------------------------------------

_channel_lock = threading.Lock()
_channels: "dict[str, grpc.Channel]" = {}


def get_channel(address: str) -> grpc.Channel:
    with _channel_lock:
        ch = _channels.get(address)
        if ch is None:
            ch = grpc.insecure_channel(address, options=[
                ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
                ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
            ])
            _channels[address] = ch
        return ch


def close_channels(address: str) -> None:
    """Close and forget the cached channel to `address` (its server
    stopped): a later server on the same address gets a fresh channel,
    not one stuck in a reconnect backoff."""
    with _channel_lock:
        ch = _channels.pop(address, None)
    if ch is not None:
        ch.close()


class Stub:
    """Callable rpc facade: stub.MethodName(request) / (request_iterator)."""

    def __init__(self, service: Service, address: str,
                 timeout: "float | None" = None):
        self._service = service
        self._channel = get_channel(address)
        self._timeout = timeout

    def __getattr__(self, name: str):
        m = self._service.methods.get(name)
        if m is None:
            raise AttributeError(name)
        path = f"/{self._service.name}/{name}"
        kw = dict(
            request_serializer=m.request.SerializeToString,
            response_deserializer=m.response.FromString,
        )
        if m.kind == UU:
            call = self._channel.unary_unary(path, **kw)
        elif m.kind == US:
            call = self._channel.unary_stream(path, **kw)
        elif m.kind == SU:
            call = self._channel.stream_unary(path, **kw)
        else:
            call = self._channel.stream_stream(path, **kw)
        timeout = self._timeout
        unary_response = m.kind in (UU, SU)

        def _call_with_trace(args, kwargs):
            # the header is captured INSIDE any client span so the
            # server's span parents to it, not to the enclosing span
            metadata = list(kwargs.pop("metadata", ()) or ())
            hdr = _trace.traceparent_header()
            if hdr is not None:
                metadata.append((_trace.TRACEPARENT, hdr))
            return call(*args, metadata=metadata, **kwargs)

        def invoke(*args, **kwargs):
            if "timeout" not in kwargs:
                # deadline propagation: an ambient failsafe.Deadline caps
                # every nested rpc so a caller's total budget holds across
                # hops
                effective = timeout
                dl = _failsafe.current_deadline()
                if dl is not None:
                    rem = dl.remaining()
                    if rem <= 0.0:
                        # firing a guaranteed-to-fail 1ms rpc would charge
                        # a DEADLINE_EXCEEDED to a healthy peer's breaker
                        raise _failsafe.DeadlineExceeded(
                            f"deadline exceeded before {path}")
                    effective = rem if effective is None else min(effective, rem)
                if effective is not None:
                    kwargs["timeout"] = effective
            if unary_response and _trace.current_context() is not None:
                # client-side span: only when already inside a trace (a
                # root span per background heartbeat would flood the
                # ring), and only for unary responses (a returned stream
                # outlives the call)
                with _trace.start_span(f"grpc{path}"):
                    return _call_with_trace(args, kwargs)
            return _call_with_trace(args, kwargs)

        return invoke


def master_stub(address: str, timeout: "float | None" = None) -> Stub:
    return Stub(MASTER, address, timeout)


def volume_server_stub(address: str, timeout: "float | None" = None) -> Stub:
    return Stub(VOLUME_SERVER, address, timeout)
