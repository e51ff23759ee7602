"""Volume-server gRPC service — the port of
seaweedfs_tpu/volume/grpc_handlers.py.

Covers the admin surface incl. the erasure-coding rpcs (reference:
weed/server/volume_grpc_erasure_coding.go, volume_grpc_vacuum.go,
volume_grpc_admin.go, volume_grpc_copy.go).  EC generate/rebuild dispatch
into the codec named per request (`codec` field) or the server's default,
`cuda`: on the card through the hand-written GF(2^8) kernel, through the
shared codec service's batched launch when the probe finds a card.

`Query` filters a needle's JSON lines or CSV rows (query/engine.py); a
needle of an EC volume is read through `read_needle`, so a lost interval
is decoded on the server's codec, the card on a `cuda` server.

`VolumeTierMoveDatToRemote` / `VolumeTierMoveDatFromRemote` move a
volume's `.dat` to and from a registered remote tier (volume_grpc_tier.go;
storage/backend_s3.py), streaming progress per part.
"""

from __future__ import annotations

import os

import grpc

from ..pb import rpc as rpclib
from ..pb import volume_server_pb2 as vs
from ..storage import types as t
from ..storage.ec import constants as ecc
from ..storage.needle import Needle, actual_size

COPY_CHUNK = 1024 * 1024

# typed rejection prefix for epoch fencing — clients/tests match on it
STALE_EPOCH_DETAIL = "stale leader epoch"


class VolumeGrpcService:
    def __init__(self, server):
        self.server = server  # VolumeServer
        self.store = server.store

    def _check_epoch(self, request, context, method: str) -> None:
        """Epoch fence on master-driven mutating rpcs: a request stamped
        with a leader epoch OLDER than the highest this node has learned
        from heartbeat acks came from a deposed leader — reject it before
        it mutates anything.  Epoch 0 (shell operators, single-master
        deployments) is unfenced and always passes."""
        epoch = getattr(request, "leader_epoch", 0)
        known = getattr(self.server, "_leader_epoch", 0)
        if epoch and known and epoch < known:
            from ..stats.metrics import STALE_EPOCH_REJECTED

            STALE_EPOCH_REJECTED.labels(method).inc()
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"{STALE_EPOCH_DETAIL} {epoch} < {known}")

    # -- volume lifecycle -------------------------------------------------

    def AllocateVolume(self, request, context):
        self.store.add_volume(
            request.volume_id,
            request.collection,
            replication=request.replication or "000",
            ttl=request.ttl,
            preallocate=request.preallocate,
            disk_type=request.disk_type,
        )
        return vs.AllocateVolumeResponse()

    def VolumeMount(self, request, context):
        if not self.store.mount_volume(request.volume_id):
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        return vs.VolumeMountResponse()

    def VolumeUnmount(self, request, context):
        if not self.store.unmount_volume(request.volume_id):
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        return vs.VolumeUnmountResponse()

    def VolumeDelete(self, request, context):
        self._check_epoch(request, context, "VolumeDelete")
        self.store.delete_volume(request.volume_id)
        return vs.VolumeDeleteResponse()

    def VolumeMarkReadonly(self, request, context):
        self._check_epoch(request, context, "VolumeMarkReadonly")
        if not self.store.mark_readonly(request.volume_id):
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        return vs.VolumeMarkReadonlyResponse()

    def VolumeMarkWritable(self, request, context):
        if not self.store.mark_writable(request.volume_id):
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        return vs.VolumeMarkWritableResponse()

    def VolumeStatus(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        return vs.VolumeStatusResponse(is_read_only=v.read_only)

    def VolumeConfigure(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            return vs.VolumeConfigureResponse(error="volume not found")
        from ..storage.replica_placement import ReplicaPlacement

        new_placement = ReplicaPlacement.parse(request.replication)
        # persist FIRST (the placement byte lives in the 8-byte super
        # block at the head of the .dat, super_block.go WriteSuperBlock
        # discipline), THEN mutate memory — a failed write (e.g. the .dat
        # is remote-tiered and read-only) must not leave the node
        # heartbeating a placement that never reached disk.  Under v._lock:
        # tier transitions and vacuum commits swap v._dat.
        old = v.super_block.replica_placement
        with v._lock:
            try:
                v.super_block.replica_placement = new_placement
                v._dat.write_at(0, v.super_block.to_bytes())
            except Exception as e:  # noqa: BLE001 — report, don't diverge
                v.super_block.replica_placement = old
                return vs.VolumeConfigureResponse(
                    error=f"cannot persist super block: {e}")
        return vs.VolumeConfigureResponse()

    def DeleteCollection(self, request, context):
        for loc in self.store.locations:
            for vid, v in list(loc.volumes.items()):
                if v.collection == request.collection:
                    self.store.delete_volume(vid)
        return vs.DeleteCollectionResponse()

    # -- needle ops -------------------------------------------------------

    def BatchDelete(self, request, context):
        from ..storage.file_id import FileId

        resp = vs.BatchDeleteResponse()
        for fid_str in request.file_ids:
            r = resp.results.add(file_id=fid_str)
            try:
                fid = FileId.parse(fid_str)
                if not request.skip_cookie_check:
                    n = self.store.read_needle(fid.volume_id, fid.key)
                    if n.cookie != fid.cookie:
                        r.status, r.error = 403, "cookie mismatch"
                        continue
                size = self.store.delete_needle(fid.volume_id, fid.key)
                r.status, r.size = 202, size
            except KeyError:
                r.status, r.error = 404, "not found"
            except Exception as e:  # pragma: no cover
                r.status, r.error = 500, str(e)
        return resp

    def ReadNeedleBlob(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        with v._lock:
            blob = v._dat.read_at(
                request.offset, actual_size(request.size, v.version)
            )
        return vs.ReadNeedleBlobResponse(needle_blob=blob)

    def WriteNeedleBlob(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        n = Needle.from_bytes(request.needle_blob, v.version, verify=False)
        v.append_needle(n)
        self.store.invalidate_needle(request.volume_id, n.id)
        return vs.WriteNeedleBlobResponse()

    def ReadAllNeedles(self, request, context):
        for vid in request.volume_ids:
            v = self.store.find_volume(vid)
            if v is None:
                continue
            for nv in list(v.needle_map.items_ascending()):
                n = v.read_needle(nv.key)
                yield vs.ReadAllNeedlesResponse(
                    volume_id=vid,
                    needle_id=nv.key,
                    cookie=n.cookie,
                    needle_blob=n.data,
                )

    # -- vacuum (4-phase protocol) ----------------------------------------

    def VacuumVolumeCheck(self, request, context):
        self._check_epoch(request, context, "VacuumVolumeCheck")
        ratio = self.store.check_compact_volume(request.volume_id)
        return vs.VacuumVolumeCheckResponse(garbage_ratio=ratio)

    def VacuumVolumeCompact(self, request, context):
        self._check_epoch(request, context, "VacuumVolumeCompact")
        self.store.compact_volume(request.volume_id)
        return vs.VacuumVolumeCompactResponse()

    def VacuumVolumeCommit(self, request, context):
        self._check_epoch(request, context, "VacuumVolumeCommit")
        self.store.commit_compact_volume(request.volume_id)
        v = self.store.find_volume(request.volume_id)
        return vs.VacuumVolumeCommitResponse(
            is_read_only=bool(v and v.read_only)
        )

    def VacuumVolumeCleanup(self, request, context):
        self._check_epoch(request, context, "VacuumVolumeCleanup")
        self.store.cleanup_compact_volume(request.volume_id)
        return vs.VacuumVolumeCleanupResponse()

    # -- status / sync ----------------------------------------------------

    def VolumeSyncStatus(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        return vs.VolumeSyncStatusResponse(
            volume_id=v.volume_id,
            collection=v.collection,
            replication=str(v.super_block.replica_placement),
            ttl=str(v.super_block.ttl),
            tail_offset=v.content_size,
            compact_revision=v.super_block.compaction_revision,
            idx_file_size=os.path.getsize(v.file_name() + ".idx")
            if os.path.exists(v.file_name() + ".idx")
            else 0,
        )

    def ReadVolumeFileStatus(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        base = v.file_name()
        return vs.ReadVolumeFileStatusResponse(
            volume_id=v.volume_id,
            idx_file_size=os.path.getsize(base + ".idx")
            if os.path.exists(base + ".idx")
            else 0,
            dat_file_size=v.content_size,
            file_count=v.file_count(),
            compaction_revision=v.super_block.compaction_revision,
            collection=v.collection,
        )

    # -- bulk file copy ---------------------------------------------------

    def CopyFile(self, request, context):
        if request.is_ec_volume:
            base = self.store._ec_base(request.volume_id, request.collection)
        else:
            v = self.store.find_volume(request.volume_id)
            if v is None:
                context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
            v.flush()  # the on-disk .dat/.idx must include buffered appends
            base = v.file_name()
        path = base + request.ext
        if not os.path.exists(path):
            if request.ignore_source_file_not_found:
                return
            context.abort(grpc.StatusCode.NOT_FOUND, f"{path} not found")
        stop = request.stop_offset or os.path.getsize(path)
        with open(path, "rb") as f:
            sent = 0
            while sent < stop:
                chunk = f.read(min(COPY_CHUNK, stop - sent))
                if not chunk:
                    break
                sent += len(chunk)
                yield vs.CopyFileResponse(file_content=chunk)

    def VolumeCopy(self, request, context):
        """Pull a whole volume (.dat/.idx/.vif) from another volume server.
        `disk_type` places the copy on that tier (volume.tier.move)."""
        self._check_epoch(request, context, "VolumeCopy")
        loc = self.store.has_free_location(request.disk_type)
        if loc is None:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, "no free slot")
        base = loc.base_name(request.volume_id, request.collection)
        src = rpclib.volume_server_stub(request.source_data_node)
        for ext in (".dat", ".idx", ".vif"):
            stream = src.CopyFile(
                vs.CopyFileRequest(
                    volume_id=request.volume_id,
                    collection=request.collection,
                    ext=ext,
                    ignore_source_file_not_found=(ext == ".vif"),
                )
            )
            _write_stream(base + ext, stream)
        self.store.mount_volume(request.volume_id)
        v = self.store.find_volume(request.volume_id)
        return vs.VolumeCopyResponse(
            last_append_at_ns=0 if v is None else v.needle_map.maximum_key
        )

    # -- erasure coding ---------------------------------------------------

    def _log_ec_dispatch(self, op: str, vid: int, codec: str) -> None:
        """One glog line naming the codec and codec-service mode this EC
        rpc will run under — the operator-facing answer to "did my
        request actually reach the card, and is it going through the
        batching service or direct dispatch?"."""
        from ..ops import codec_service
        from ..util import glog

        name = codec or self.store.codec_name
        svc = codec_service.service_for_codec(name)
        glog.info("rpc %s vol=%d codec=%s dispatch=%s", op, vid,
                  codec or f"{name} (server default)",
                  svc.mode + "-service" if svc is not None else "direct")

    def VolumeEcShardsGenerate(self, request, context):
        self._check_epoch(request, context, "VolumeEcShardsGenerate")
        self._log_ec_dispatch(
            "VolumeEcShardsGenerate", request.volume_id, request.codec)
        try:
            self.store.generate_ec_shards(
                request.volume_id,
                request.collection,
                codec_name=request.codec or None,
            )
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return vs.VolumeEcShardsGenerateResponse()

    def VolumeEcShardsRebuild(self, request, context):
        self._check_epoch(request, context, "VolumeEcShardsRebuild")
        self._log_ec_dispatch(
            "VolumeEcShardsRebuild", request.volume_id, request.codec)
        try:
            rebuilt = self.store.rebuild_ec_shards(
                request.volume_id,
                request.collection,
                codec_name=request.codec or None,
            )
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except ValueError as e:
            # too few reachable source shards: a precondition, not a crash
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        except OSError as e:
            # a source died mid-rebuild; partial outputs were removed, so
            # the caller can safely retry against surviving holders
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        return vs.VolumeEcShardsRebuildResponse(rebuilt_shard_ids=rebuilt)

    def VolumeEcShardsBatchRebuild(self, request, context):
        """Rebuild MANY volumes' globally-missing shards on this node in
        one rpc — the master's mass-repair orchestrator sends each
        rebuild-target node its whole slice of a dead-node batch.  Every
        volume sources remote columns through ONE shared
        MassPartialSession (cross-volume aggregated rpcs per source
        server) and mounts its rebuilt shards locally; per-volume errors
        come back in the response instead of failing the batch."""
        self._check_epoch(request, context, "VolumeEcShardsBatchRebuild")
        self._log_ec_dispatch(
            "VolumeEcShardsBatchRebuild",
            request.jobs[0].volume_id if request.jobs else 0, request.codec)
        results = self.server.mass_rebuild(
            [(j.volume_id, j.collection, j.shard_size)
             for j in request.jobs],
            codec=request.codec)
        resp = vs.VolumeEcShardsBatchRebuildResponse()
        for r in results:
            resp.results.add(
                volume_id=r["volume_id"],
                rebuilt_shard_ids=r.get("rebuilt", []),
                error=r.get("error", ""),
                used_partial=r.get("used_partial", False))
        return resp

    def VolumeEcShardsCopy(self, request, context):
        """Pull shard files from the source node (server-side pull protocol)."""
        self._check_epoch(request, context, "VolumeEcShardsCopy")
        loc = self.store.has_free_location() or self.store.locations[0]
        base = loc.base_name(request.volume_id, request.collection)
        src = rpclib.volume_server_stub(request.copy_from_data_node)

        def pull(ext: str, ignore_missing: bool = False):
            stream = src.CopyFile(
                vs.CopyFileRequest(
                    volume_id=request.volume_id,
                    collection=request.collection,
                    ext=ext,
                    is_ec_volume=True,
                    ignore_source_file_not_found=ignore_missing,
                )
            )
            _write_stream(base + ext, stream, drop_empty=ignore_missing)

        for sid in request.shard_ids:
            pull(ecc.to_ext(sid))
        if request.copy_ecx_file:
            pull(".ecx")
        if request.copy_ecj_file:
            pull(".ecj", ignore_missing=True)
        if request.copy_vif_file:
            pull(".vif", ignore_missing=True)
        return vs.VolumeEcShardsCopyResponse()

    def VolumeEcShardsDelete(self, request, context):
        self.store.delete_ec_shards(
            request.volume_id, request.collection, list(request.shard_ids)
        )
        return vs.VolumeEcShardsDeleteResponse()

    def VolumeEcShardsMount(self, request, context):
        try:
            self.store.mount_ec_shards(
                request.volume_id, request.collection, list(request.shard_ids)
            )
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return vs.VolumeEcShardsMountResponse()

    def VolumeEcShardsUnmount(self, request, context):
        self.store.unmount_ec_shards(request.volume_id, list(request.shard_ids))
        return vs.VolumeEcShardsUnmountResponse()

    def VolumeEcShardRead(self, request, context):
        ev = self.store.find_ec_volume(request.volume_id)
        if ev is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "ec volume not found")
        sh = ev.shards.get(request.shard_id)
        if sh is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "ec shard not found")
        if request.file_key:
            entry = ev._search_ecx(request.file_key)
            if entry is not None and t.size_is_deleted(entry[2]):
                # reference returns immediately after is_deleted; streaming
                # interval bytes afterwards would read as valid data
                yield vs.VolumeEcShardReadResponse(is_deleted=True)
                return
        remaining = request.size
        offset = request.offset
        while remaining > 0:
            chunk = sh.read_at(offset, min(COPY_CHUNK, remaining))
            if not chunk:
                break
            yield vs.VolumeEcShardReadResponse(data=chunk)
            offset += len(chunk)
            remaining -= len(chunk)

    def VolumeEcShardPartialApply(self, request, context):
        """Partial-sum repair source: multiply the requested LOCAL shard
        intervals by the decode-plan coefficient rows (on the host-mode
        codec service, so concurrent repairs batch), fold in any
        delegated same-rack partials, and stream ONE combined GF(2^8)
        sum — the rebuilder pulls rows x size bytes instead of every
        raw interval.  size=0 is a probe answered with the shard size.

        Served bytes are charged to the node's shared background-I/O
        bucket and back off while the executors' saturation gauges
        fire, so a rebuild storm never starves foreground reads."""
        from ..storage.ec.partial import batch_response_frames, serve_partial
        from ..storage.scrub import _saturation

        import time as _time

        server = self.server
        scrubber = getattr(server, "scrubber", None)
        backoff_depth = getattr(scrubber, "backoff_depth", 8) or 8

        def throttle(n: int) -> None:
            # bounded saturation backoff (deep foreground pools mean
            # this node is busy serving clients) + the shared
            # bucket: repair reads and tier/scrub traffic drain ONE
            # per-node budget, so a rebuild storm cannot starve reads
            deadline = 2.0
            while _saturation() >= backoff_depth and deadline > 0:
                _time.sleep(0.05)
                deadline -= 0.05
            if scrubber is not None:
                scrubber.throttle_background(n)

        me = f"{server.ip}:{server.port}" if server else ""

        if len(request.batch):
            # cross-volume aggregation (mass repair): one rpc carries
            # coefficient columns for MANY volumes; per-volume eof/error
            # frames let the rebuilder degrade exactly the volumes a
            # dead shard breaks, never the whole batch
            def read_interval_for(vid: int, _collection: str):
                bev = self.store.find_ec_volume(vid)
                if bev is None:
                    return None

                def read_interval(sid: int, offset: int, length: int):
                    sh = bev.shards.get(sid)
                    if sh is None:
                        return None
                    buf = sh.read_at(offset, length)
                    return buf if len(buf) == length else None

                return read_interval

            yield from batch_response_frames(
                request, read_interval_for,
                stub_for=lambda addr: rpclib.volume_server_stub(
                    addr, timeout=30),
                ctx=me, throttle=throttle)
            return

        ev = self.store.find_ec_volume(request.volume_id)
        if ev is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "ec volume not found")
        if request.size == 0:  # probe: shard size only
            try:
                size = ev.shard_size
            except (OSError, IOError):
                size = 0
            yield vs.VolumeEcShardPartialApplyResponse(shard_size=size)
            return

        def read_interval(sid: int, offset: int, length: int):
            sh = ev.shards.get(sid)
            if sh is None:
                return None
            buf = sh.read_at(offset, length)
            return buf if len(buf) == length else None

        try:
            acc = serve_partial(
                request, read_interval,
                stub_for=lambda addr: rpclib.volume_server_stub(
                    addr, timeout=30),
                ctx=me, throttle=throttle)
        except (IOError, ValueError) as e:
            # a missing local shard / dead delegate means the combined
            # partial would be silently wrong — fail loudly so the
            # rebuilder degrades to full fetches
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        blob = acc.tobytes()
        for at in range(0, len(blob), COPY_CHUNK):
            yield vs.VolumeEcShardPartialApplyResponse(
                data=blob[at:at + COPY_CHUNK])

    def VolumeEcBlobDelete(self, request, context):
        ev = self.store.find_ec_volume(request.volume_id)
        if ev is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "ec volume not found")
        ev.delete_needle(request.file_key)
        self.store.invalidate_needle(request.volume_id, request.file_key)
        return vs.VolumeEcBlobDeleteResponse()

    def VolumeEcShardsToVolume(self, request, context):
        try:
            self.store.ec_shards_to_volume(request.volume_id, request.collection)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return vs.VolumeEcShardsToVolumeResponse()

    # -- replica catch-up: incremental copy + tail sync -------------------
    # (reference: volume_grpc_copy_incremental.go, volume_grpc_tail.go)

    def _offset_since(self, v, since_ns: int) -> int:
        """First .dat offset whose record was appended after since_ns;
        falls back to EOF when everything predates it."""
        from ..tools.offline import scan_dat_file

        v.flush()
        if since_ns == 0:
            return v.super_block.block_size()
        for offset, n in scan_dat_file(v.file_name() + ".dat"):
            if n.append_at_ns > since_ns:
                return offset
        return v.content_size

    def VolumeIncrementalCopy(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        start = self._offset_since(v, request.since_ns)
        end = v.content_size
        with open(v.file_name() + ".dat", "rb") as f:
            f.seek(start)
            while start < end:
                chunk = f.read(min(COPY_CHUNK, end - start))
                if not chunk:
                    break
                yield vs.VolumeIncrementalCopyResponse(file_content=chunk)
                start += len(chunk)

    def VolumeTailSender(self, request, context):
        """Stream needles appended after since_ns; keep watching for new
        appends until idle_timeout_seconds passes without growth."""
        import time as _time

        from ..storage import types as _t
        from ..storage.needle import body_length

        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        pos = self._offset_since(v, request.since_ns)
        idle_deadline = _time.monotonic() + (request.idle_timeout_seconds or 2)
        dat_path = v.file_name() + ".dat"
        while _time.monotonic() < idle_deadline and context.is_active():
            v.flush()
            end = v.content_size
            if pos >= end:
                _time.sleep(0.1)
                continue
            with open(dat_path, "rb") as f:
                f.seek(pos)
                while pos < end:
                    header = f.read(_t.NEEDLE_HEADER_SIZE)
                    if len(header) < _t.NEEDLE_HEADER_SIZE:
                        break
                    n = Needle.parse_header(header)
                    body = f.read(
                        body_length(n.size if n.size > 0 else 0, v.version)
                    )
                    yield vs.VolumeTailSenderResponse(
                        needle_header=header, needle_body=body
                    )
                    pos += len(header) + len(body)
            idle_deadline = _time.monotonic() + (
                request.idle_timeout_seconds or 2
            )
        yield vs.VolumeTailSenderResponse(is_last_chunk=True)

    def _last_append_ns(self, v) -> int:
        from ..tools.offline import tail_watermark_ns

        v.flush()
        return tail_watermark_ns(v.file_name() + ".dat")

    def VolumeTailReceiver(self, request, context):
        """Pull missing appends from a replica peer into the local volume
        (volume_grpc_tail.go receiver side).  since_ns=0 means "from my own
        last append" — re-streaming records the replica already holds would
        duplicate them at EOF and balloon the .dat on every sync."""
        from .server import GRPC_PORT_OFFSET

        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        since_ns = request.since_ns or self._last_append_ns(v)
        host, _, port = request.source_volume_server.partition(":")
        source_grpc = f"{host}:{int(port) + GRPC_PORT_OFFSET}"
        stub = rpclib.volume_server_stub(source_grpc, timeout=120)
        for resp in stub.VolumeTailSender(
            vs.VolumeTailSenderRequest(
                volume_id=request.volume_id,
                since_ns=since_ns,
                idle_timeout_seconds=request.idle_timeout_seconds or 1,
            )
        ):
            if resp.is_last_chunk:
                break
            if not resp.needle_header:
                continue
            n = Needle.parse_header(bytes(resp.needle_header))
            full = Needle.from_bytes(
                bytes(resp.needle_header) + bytes(resp.needle_body),
                v.version, verify=False,
            )
            if n.size > 0:
                # replicas can hold the same needle under different append
                # timestamps (fan-out re-stamps); re-appending an extant
                # IDENTICAL record would balloon the .dat on every resync
                # and leave the replicas byte-diverged forever.  Size alone
                # is not identity — a same-length overwrite must still
                # land — so matched candidates compare content.
                existing = v.needle_map.get(n.id)
                if existing is not None and existing.size == n.size:
                    try:
                        local = v.read_needle(n.id)
                        if (local.cookie == full.cookie
                                and local.checksum == full.checksum):
                            continue
                    except Exception:  # unreadable local copy: replace it
                        pass
                v.append_needle(full)
                self.store.invalidate_needle(request.volume_id, n.id)
            else:
                # carry the origin's tombstone timestamp — a local stamp
                # would poison since_ns watermarks under clock skew
                v.delete_needle(n.id, at_ns=full.append_at_ns)
                self.store.invalidate_needle(request.volume_id, n.id)
        return vs.VolumeTailReceiverResponse()

    # -- SQL-on-blob query (volume_grpc_query.go:12 + weed/query/) ---------

    # -- remote tier -------------------------------------------------------

    def VolumeTierMoveDatToRemote(self, request, context):
        """Upload a volume's .dat to the named remote tier backend and
        record it in the .vif (volume_grpc_tier.go; shell command
        volume.tier.upload).  The stream carries one final message, as
        the reference's does; every uploaded byte is charged to the
        node's shared background bucket (the scrubber's) as each part
        goes, so a tier move and a scrub pass together stay within one
        budget."""
        self._check_epoch(request, context, "VolumeTierMoveDatToRemote")
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        total = max(v.content_size, 1)
        sent: list[int] = [0]
        scrubber = getattr(self.server, "scrubber", None)

        def progress(n):
            delta = n - sent[0]
            sent[0] = n
            if scrubber is not None:
                scrubber.throttle_background(delta)

        try:
            v.tier_to_remote(request.destination_backend_name,
                             keep_local=request.keep_local_dat_file,
                             progress=progress)
        except (IOError, PermissionError) as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        yield vs.VolumeTierMoveDatToRemoteResponse(
            processed=sent[0] or total, processedPercentage=100.0)

    def VolumeTierMoveDatFromRemote(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, "volume not found")
        try:
            got = v.tier_to_local()
        except IOError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        yield vs.VolumeTierMoveDatFromRemoteResponse(
            processed=got, processedPercentage=100.0)

    def Query(self, request, context):
        from ..query import query_csv_lines, query_json_lines
        from ..storage.file_id import FileId

        filt = request.filter
        for fid_str in request.from_file_ids:
            fid = FileId.parse(fid_str)
            try:
                n = self.store.read_needle(fid.volume_id, fid.key)
            except KeyError:
                context.abort(grpc.StatusCode.NOT_FOUND,
                              f"{fid_str} not found")
            if n.cookie != fid.cookie:
                context.abort(grpc.StatusCode.PERMISSION_DENIED,
                              f"cookie mismatch for {fid_str}")
            data = bytes(n.data)
            ins = request.input_serialization
            if ins.HasField("json_input"):
                records = query_json_lines(
                    data, list(request.selections),
                    field=filt.field, op=filt.operand, value=filt.value,
                    document=(ins.json_input.type.upper() == "DOCUMENT"),
                )
            elif ins.HasField("csv_input"):
                records = query_csv_lines(
                    data, list(request.selections),
                    field=filt.field, op=filt.operand, value=filt.value,
                    header=ins.csv_input.file_header_info,
                    delimiter=ins.csv_input.field_delimiter or ",",
                    comment=ins.csv_input.comments or "#",
                )
            else:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              "need csv_input or json_input")
            yield vs.QueriedStripe(records=records)

    def VolumeScrub(self, request, context):
        """On-demand integrity scan (shell `volume.scrub`): one volume /
        EC volume, or the whole node when volume_id=0; an optional
        per-call rate override on the scrubber's token bucket."""
        scrubber = self.server.scrubber
        rate = request.rate_mbps or None
        try:
            if request.volume_id:
                r = scrubber.scrub_volume(request.volume_id, rate_mbps=rate)
            else:
                r = scrubber.scrub_once(rate_mbps=rate)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        findings = [
            (f"vol={f['volume_id']} kind={f['kind']} shard={f['shard_id']} "
             f"needle={f['needle_id']:x} {f['detail']}")
            for f in scrubber.recent_findings(request.volume_id or None)
        ]
        return vs.VolumeScrubResponse(
            scanned=r.get("scanned",
                          r.get("volumes", 0) + r.get("ec_volumes", 0)),
            scanned_bytes=r.get("bytes", r.get("scanned_bytes", 0)),
            corrupt_needles=r.get("corrupt_needles", 0),
            corrupt_shards=r.get("corrupt_shards", 0),
            index_repairs=r.get("index_repairs", 0),
            findings=findings[-32:],
        )

    def VolumeNeedleStatus(self, request, context):
        try:
            n = self.store.read_needle(request.volume_id, request.needle_id)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return vs.VolumeNeedleStatusResponse(
            needle_id=request.needle_id,
            cookie=n.cookie,
            size=len(n.data),
            last_modified=n.last_modified,
            crc=n.checksum & 0xFFFFFFFF,
            ttl=str(n.ttl) if n.ttl else "",
        )

    # -- server status / membership ---------------------------------------

    def VolumeServerStatus(self, request, context):
        resp = vs.VolumeServerStatusResponse()
        for loc in self.store.locations:
            # one statvfs wrapper for the whole process: the health
            # machine's poll refreshes its state + gauges on the way
            loc.health.poll()
            snap = loc.health.snapshot()
            all_b = snap["total_bytes"]
            free_b = snap["free_bytes"]
            used_b = all_b - free_b
            resp.disk_statuses.add(
                dir=loc.directory,
                all=all_b,
                used=used_b,
                free=free_b,
                percent_free=100.0 * free_b / all_b if all_b else 0.0,
                percent_used=100.0 * used_b / all_b if all_b else 0.0,
            )
        return resp

    def VolumeServerLeave(self, request, context):
        """Graceful exit from the cluster: stop heartbeating so the master
        unregisters this node (volume_server.proto:93)."""
        self.server.stop_heartbeat()
        return vs.VolumeServerLeaveResponse()


def _write_stream(path: str, stream, drop_empty: bool = False) -> None:
    wrote = False
    try:
        with open(path, "wb") as f:
            for resp in stream:
                if resp.file_content:
                    f.write(resp.file_content)
                    wrote = True
    except grpc.RpcError:
        if os.path.exists(path):
            os.remove(path)
        raise
    if drop_empty and not wrote:
        os.remove(path)
