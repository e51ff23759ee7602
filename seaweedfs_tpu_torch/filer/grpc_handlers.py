"""Filer gRPC service (filer_pb.SeaweedFiler, 19 rpcs).

The port's copy of seaweedfs_tpu/filer/grpc_handlers.py.

Reference: weed/server/filer_grpc_server*.go.
"""

from __future__ import annotations

import threading

import grpc

from ..pb import filer_pb2
from .filer import join_path
from .fleet.tenant import QuotaExceededError


class FilerGrpcService:
    def __init__(self, filer_server):
        self.fs = filer_server

    @property
    def filer(self):
        return self.fs.filer

    # -- metadata ----------------------------------------------------------

    def LookupDirectoryEntry(self, request, context):
        # the Filer path (not the raw store) so hardlink stubs come back
        # merged with their shared KV meta (filerstore_hardlink.go)
        entry = self.filer._maybe_read_hardlink(
            self.filer.store.find_entry(request.directory, request.name))
        if entry is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"{join_path(request.directory, request.name)} not found")
        resp = filer_pb2.LookupDirectoryEntryResponse()
        resp.entry.CopyFrom(entry)
        return resp

    def ListEntries(self, request, context):
        limit = request.limit or 1024
        for e in self.filer.list_directory(
            request.directory,
            start_from=request.start_from_file_name,
            inclusive=request.inclusive_start_from,
            prefix=request.prefix,
            limit=limit,
        ):
            resp = filer_pb2.ListEntriesResponse()
            resp.entry.CopyFrom(e)
            yield resp

    def _maybe_manifestize(self, directory, entry) -> None:
        """Fold over-long chunk lists before the store write
        (filer_grpc_server.go MaybeManifestize)."""
        folded = self.fs.manifestize_chunks(
            list(entry.chunks), path=join_path(directory, entry.name)
        )
        if len(folded) != len(entry.chunks):
            del entry.chunks[:]
            entry.chunks.extend(folded)

    def CreateEntry(self, request, context):
        try:
            self._maybe_manifestize(request.directory, request.entry)
            self.filer.create_entry(
                request.directory, request.entry, o_excl=request.o_excl,
                signatures=list(request.signatures),
            )
            return filer_pb2.CreateEntryResponse()
        except FileExistsError as e:
            return filer_pb2.CreateEntryResponse(error=str(e))
        except QuotaExceededError as e:
            # the "quota exceeded" prefix is the wire contract the S3
            # gateway maps to 403 QuotaExceeded XML
            return filer_pb2.CreateEntryResponse(error=str(e))

    def UpdateEntry(self, request, context):
        try:
            self._maybe_manifestize(request.directory, request.entry)
            self.filer.update_entry(request.directory, request.entry,
                                    signatures=list(request.signatures))
        except FileNotFoundError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except QuotaExceededError as e:
            context.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))
        return filer_pb2.UpdateEntryResponse()

    def AppendToEntry(self, request, context):
        try:
            self.filer.append_chunks(
                request.directory, request.entry_name, list(request.chunks)
            )
        except QuotaExceededError as e:
            context.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))
        entry = self.filer.store.find_entry(request.directory,
                                            request.entry_name)
        if entry is not None and len(entry.chunks) > self.fs.manifest_batch:
            self._maybe_manifestize(request.directory, entry)
            self.filer.update_entry(request.directory, entry)
        return filer_pb2.AppendToEntryResponse()

    def DeleteEntry(self, request, context):
        try:
            self.filer.delete_entry(
                request.directory,
                request.name,
                is_recursive=request.is_recursive,
                ignore_recursive_error=request.ignore_recursive_error,
                is_delete_data=request.is_delete_data,
                signatures=list(request.signatures),
            )
            return filer_pb2.DeleteEntryResponse()
        except FileNotFoundError as e:
            # distinguishable marker: callers (S3 multi-delete) treat a
            # missing key as already-deleted, AWS-style
            return filer_pb2.DeleteEntryResponse(error=f"not found: {e}")
        except IsADirectoryError as e:
            return filer_pb2.DeleteEntryResponse(error=str(e))

    def AtomicRenameEntry(self, request, context):
        try:
            self.filer.rename_entry(
                request.old_directory, request.old_name,
                request.new_directory, request.new_name,
            )
        except (FileNotFoundError, FileExistsError) as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        return filer_pb2.AtomicRenameEntryResponse()

    # -- cluster proxies ---------------------------------------------------

    def AssignVolume(self, request, context):
        collection = request.collection or self.filer.bucket_collection(
            request.path
        )
        # filer.conf path rules fill whatever the client left unset
        from .server import _ttl_seconds

        collection, replication, rule_ttl = self.fs.apply_path_conf(
            request.path, collection, request.replication,
            "set" if request.ttl_sec else "")
        try:
            result = self.fs.assign(
                count=request.count or 1,
                collection=collection,
                replication=replication,
                ttl_sec=request.ttl_sec or _ttl_seconds(rule_ttl),
                data_center=request.data_center,
                rack=request.rack,
            )
        except Exception as e:
            return filer_pb2.AssignVolumeResponse(error=str(e))
        return filer_pb2.AssignVolumeResponse(
            file_id=result.fid,
            url=result.url,
            public_url=result.public_url,
            count=result.count,
            auth=result.auth,
            collection=collection,
            replication=request.replication,
        )

    def LookupVolume(self, request, context):
        resp = filer_pb2.LookupVolumeResponse()
        for vid_s in request.volume_ids:
            try:
                vid = int(vid_s.split(",", 1)[0])
            except ValueError:
                continue
            locs = filer_pb2.Locations()
            for l in self.fs.master_client.lookup_volume(vid):
                locs.locations.append(
                    filer_pb2.Location(url=l.url, public_url=l.public_url)
                )
            resp.locations_map[vid_s].CopyFrom(locs)
        return resp

    def CollectionList(self, request, context):
        resp = filer_pb2.CollectionListResponse()
        seen = set()
        for e in self.filer.list_directory("/buckets", limit=10000):
            if e.is_directory and e.name not in seen:
                seen.add(e.name)
                resp.collections.add(name=e.name)
        return resp

    def DeleteCollection(self, request, context):
        self.fs.delete_collection(request.collection)
        return filer_pb2.DeleteCollectionResponse()

    def Statistics(self, request, context):
        return filer_pb2.StatisticsResponse(
            total_size=0, used_size=0, file_count=0
        )

    def GetFilerConfiguration(self, request, context):
        return filer_pb2.GetFilerConfigurationResponse(
            masters=self.fs.masters,
            max_mb=self.fs.max_mb,
            dir_buckets="/buckets",
            collection="",
            replication="",
            signature=self.fs.signature,
            cipher=self.fs.cipher,
        )

    # -- metadata subscription ---------------------------------------------

    @staticmethod
    def _subscribe_log(log, request, context):
        stop = threading.Event()
        context.add_callback(stop.set)
        for ev in log.subscribe(
            request.since_ns, request.path_prefix, stop_event=stop
        ):
            if request.signature and request.signature in ev.event_notification.signatures:
                continue  # skip events this subscriber itself caused
            yield ev

    def SubscribeMetadata(self, request, context):
        """The merged stream.  The reference reads its MetaAggregator's
        log when filer peers are configured; the port has no peers yet
        (ROADMAP A-7), so this is the local log."""
        yield from self._subscribe_log(self.filer.meta_log, request,
                                       context)

    def SubscribeLocalMetadata(self, request, context):
        """Only THIS filer's own mutations (filer.proto:58) — what peer
        MetaAggregators tail; never includes replayed peer events, which
        is what keeps replication loop-free.

        The in-memory log is bounded and dies with the process (the
        reference replays from its persisted /topics/.system/log files);
        when the subscriber asks for history older than the log can
        serve, the CURRENT STORE is streamed first as synthetic create
        events — replays are idempotent upserts, so a follower converges
        on the full namespace even across restarts/eviction.  Deletions
        that happened entirely inside the lost window stay unreplicated
        (documented divergence from the persisted-log design)."""
        log = self.filer.meta_log
        if request.since_ns < log.history_start_ns():
            yield from self._snapshot_events(request.path_prefix)
        yield from self._subscribe_log(log, request, context)

    def _snapshot_events(self, path_prefix: str):
        """BFS of the store as create events, emitted in STRICTLY
        INCREASING ts order (base: each entry's mtime) — consumers
        (MetaAggregator.ingest gate, resume watermarks) assume a
        monotonic stream."""
        store = self.filer.store
        collected: list[tuple[int, str, filer_pb2.Entry]] = []
        queue = ["/"]
        while queue:
            d = queue.pop(0)
            start = ""
            while True:
                batch = list(store.list_entries(d, start_from=start,
                                                limit=1024))
                if not batch:
                    break
                for e in batch:
                    child = d.rstrip("/") + "/" + e.name
                    if e.is_directory:
                        queue.append(child)
                    if path_prefix and not (
                        child.startswith(path_prefix)
                        or path_prefix.startswith(child + "/")
                    ):
                        continue
                    ts = (e.attributes.mtime or 1) * 1_000_000_000
                    collected.append((ts, d, e))
                start = batch[-1].name
        last_ts = 0
        for ts, d, e in sorted(collected, key=lambda x: (x[0], x[1])):
            ts = max(ts, last_ts + 1)
            last_ts = ts
            resp = filer_pb2.SubscribeMetadataResponse(
                directory=d, ts_ns=ts)
            resp.event_notification.new_entry.CopyFrom(e)
            yield resp

    def KeepConnected(self, request_iterator, context):
        for req in request_iterator:
            yield filer_pb2.KeepConnectedResponse()

    def LocateBroker(self, request, context):
        return self.fs.locate_broker(request.resource)

    # -- KV ----------------------------------------------------------------

    def KvGet(self, request, context):
        value = self.filer.store.kv_get(bytes(request.key))
        if value is None:
            return filer_pb2.KvGetResponse(error="not found")
        return filer_pb2.KvGetResponse(value=value)

    def KvPut(self, request, context):
        self.filer.store.kv_put(bytes(request.key), bytes(request.value))
        return filer_pb2.KvPutResponse()
