"""FilerServer: HTTP + gRPC front over the Filer core, talking to the
cluster through a MasterClient — the port's copy of
seaweedfs_tpu/filer/server.py.

Reference: weed/server/filer_server.go + filer_server_handlers_write*.go.
Uploads are auto-chunked: each max_mb slice gets its own Assign + direct
volume-server upload, then one CreateEntry records the chunk list
(filer_server_handlers_write_autochunk.go:24-69).

Differences from the reference, on purpose: the planes that talk to other
filers or clusters are not ported yet, and asking for one raises
ValueError naming ROADMAP A-7 (as the master does for `peer_clusters`):
`peers` (the meta aggregator), `cluster_id` and `geo_peers` (geo
replication) and a `notification` publisher.  `stop()` joins every thread
`start()` and the constructor started: the master client's KeepConnected
loop, the chunk pool, the deferred-deletion worker, the HTTP, metrics and
gRPC front ends and the gRPC worker pool; the reference leaves its
daemons running.  The metadata log starts no thread.
"""

from __future__ import annotations

import random
import struct
import time

from ..operation import delete_file_ids, download, upload_data
from ..telemetry import trace
from ..util import failsafe, faultpoint, glog
from ..operation.assign import AssignResult, assign_any
from ..pb import filer_pb2
from ..pb import rpc as rpclib
from ..util.chunk_cache import TieredChunkCache
from ..util.executors import MeteredThreadPoolExecutor
from ..wdclient import MasterClient
from . import filechunk_manifest, filechunks
from .filer import Filer, split_path
from .filerstore import make_store
from .grpc_handlers import FilerGrpcService
from .http_handlers import serve_http

from ..util.http_util import netloc as _netloc

GRPC_PORT_OFFSET = 10000

FP_CHUNK_FETCH = faultpoint.register("filer.chunk.fetch")

# total budget for one chunk read INCLUDING all failover rounds: clamps
# every nested lookup rpc and download attempt via the ambient deadline
CHUNK_READ_DEADLINE_S = 30.0
# the chunk cache's memory tier (reader_at.go's default); chunks bigger
# than -maxMB are not cached.  The disk tier comes with mount (A-7b).
CHUNK_CACHE_MEM_MB = 32


class FilerServer:
    def __init__(
        self,
        masters: list[str],  # master gRPC addresses
        ip: str = "127.0.0.1",
        port: int = 8888,
        store: str = "sqlite",
        store_path: str = "./filer.db",
        max_mb: int = 4,
        metrics_port: int = 0,
        notification=None,  # notification.Publisher, or None
        peers: list[str] | None = None,  # peer filer HTTP addresses
        cipher: bool = False,  # AES-GCM encrypt chunk blobs (cipher.go)
        cluster_id: int = 0,  # geo: this cluster's identity (nonzero = geo on)
        geo_peers: list[str] | None = None,  # remote cluster filer http addrs
        meta_log_dir: str = "",  # durable event log dir; "" = derived
    ):
        _refuse_left_out(peers=peers, cluster_id=cluster_id,
                         geo_peers=geo_peers, notification=notification)
        self.masters = list(masters)
        self.ip = ip
        self.port = port
        self.grpc_port = port + GRPC_PORT_OFFSET
        self.max_mb = max_mb
        self.cipher = cipher
        self.metrics_port = metrics_port
        self.master_client = MasterClient(
            f"filer@{ip}:{port}", self.masters,
            client_type="filer", http_address=f"{ip}:{port}")
        # durable metadata event log: sequence-numbered segments beside
        # the store, so followers resume across restarts with gap
        # detection.  Memory stores stay memory-logged unless a dir is
        # forced.  No fsync per append: the reference pays it for
        # geo-enabled filers only, which the port has not (the log
        # survives a process SIGKILL through the page cache; host power
        # loss degrades to torn-tail truncation + gap-driven resync).
        log_dir = meta_log_dir or None
        if log_dir is None and store != "memory":
            log_dir = f"{store_path}.metalog"
        backend = (make_store("memory") if store == "memory"
                   else make_store(store, path=store_path))
        self.filer = Filer(backend, self._delete_chunks,
                           resolve_chunks_fn=self.resolve_chunks,
                           meta_log_dir=log_dir, meta_log_fsync=False)
        # tenant plane (fleet): quotas checked in the Filer mutation
        # path, WFQ admission consulted by the HTTP serving layer.
        # Config/usage persist in this shard's own store KV.
        from .fleet.tenant import AdmissionController, TenantManager

        self.tenants = TenantManager(self.filer.store)
        self.filer.tenants = self.tenants
        self.admission = AdmissionController(self.tenants)
        # the store signature identifies THIS store across restarts
        # (meta_aggregator.go: "filer.store.id"); peers replicate only
        # from stores whose signature differs from their own
        sig_raw = self.filer.store.kv_get(b"filer.store.id")
        if sig_raw and len(sig_raw) == 4:
            self.signature = struct.unpack(">i", sig_raw)[0]
        else:
            self.signature = random.randint(1, 2**31 - 1)
            self.filer.store.kv_put(b"filer.store.id",
                                    struct.pack(">i", self.signature))
        self._brokers: dict[str, list[str]] = {}
        self._grpc_server = None
        self._httpd = None
        # chunk fan-out (parallel chunk uploads + chunk-view reads):
        # saturation visible as seaweedfs_executor_*{executor="filer_chunk"}
        self._pool = MeteredThreadPoolExecutor(
            max_workers=8, name="filer_chunk",
            thread_name_prefix="filer-chunk")
        # tiered read cache + manifest batching (reader_at.go:88-104,
        # filechunk_manifest.go)
        self.chunk_cache = TieredChunkCache(
            mem_limit_bytes=CHUNK_CACHE_MEM_MB << 20,
            mem_max_entry=max_mb << 20,
        )
        self.manifest_batch = filechunk_manifest.MANIFEST_BATCH
        # per-path storage rules at /etc/seaweedfs/filer.conf
        # (filer_conf.go); consulted on every write without explicit
        # collection/replication/ttl
        from .filer_conf import FilerConfHolder

        def _read_conf(path: str) -> bytes | None:
            d, n = split_path(path)
            entry = self.filer.store.find_entry(d, n)
            if entry is None:
                return None
            if entry.content:
                return bytes(entry.content)
            return self.read_entry_range(
                entry, 0, filechunks.total_size(entry.chunks))

        self.filer_conf = FilerConfHolder(_read_conf)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        from ..stats.metrics import serve_metrics

        self.master_client.start()
        # flight-recorder plane: always-on low-hz stack sampler feeding
        # /debug/profile/history (kill-switch + hz env knobs respected)
        from ..util import profiler as _profiler

        _profiler.ensure_continuous()
        self._grpc_server = rpclib.serve(
            [(rpclib.FILER, FilerGrpcService(self))], self.grpc_port,
            thread_name_prefix="filer-grpc")
        self._httpd = serve_http(self, "0.0.0.0", self.port)
        if self.metrics_port:
            self._metricsd = serve_metrics(self.metrics_port)
        glog.info("filer started http=%d grpc=%d store=%s", self.port,
                  self.grpc_port, self.filer.store.name)

    def stop(self) -> None:
        """Stop serving and join every thread this filer started."""
        self.master_client.stop()
        for srv in (self._httpd, getattr(self, "_metricsd", None)):
            if srv is not None:
                srv.shutdown()
                srv.server_close()
                srv.serve_thread.join(timeout=10.0)
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=0.5).wait()
            self._grpc_server.pool.shutdown(wait=True)
        rpclib.close_channels(f"{self.ip}:{self.grpc_port}")
        self._pool.shutdown(wait=True)
        self.tenants.close()  # checkpoint usage before the store closes
        self.filer.close()

    # -- cluster helpers ---------------------------------------------------

    def assign(self, count: int = 1, collection: str = "",
               replication: str = "", ttl_sec: int = 0,
               data_center: str = "", rack: str = "") -> AssignResult:
        ttl = f"{max(1, ttl_sec // 60)}m" if ttl_sec else ""
        return assign_any(
            self._master_order(),
            count=count,
            collection=collection,
            replication=replication,
            ttl=ttl,
            data_center=data_center,
            rack=rack,
        )

    def _master_order(self) -> list[str]:
        cur = self.master_client.current_master
        if cur:
            return [cur, *[m for m in self.masters if m != cur]]
        return list(self.masters)

    def _delete_chunks(self, file_ids: list[str]) -> None:
        delete_file_ids(self.master_client.lookup_volume, file_ids)

    # -- write path --------------------------------------------------------

    def write_file(self, path: str, data: bytes, mime: str = "",
                   collection: str = "", replication: str = "",
                   ttl: str = "",
                   signatures: list[int] | None = None,
                   extended: dict | None = None) -> filer_pb2.Entry:
        """Auto-chunking upload: split, assign+upload each chunk, CreateEntry."""
        directory, name = split_path(path)
        # quota pre-check BEFORE the chunk uploads: create_entry re-runs
        # the authoritative gate, but failing here keeps an over-quota
        # write from parking orphan chunks on the volume servers first
        self._precheck_quota(directory, name, len(data))
        collection, replication, ttl = self.apply_path_conf(
            path, collection, replication, ttl)
        chunk_size = self.max_mb << 20
        ttl_sec = _ttl_seconds(ttl)
        chunks = []
        offsets = range(0, max(len(data), 1), chunk_size)
        upload_one = lambda off: self._upload_chunk(  # noqa: E731
            data[off : off + chunk_size], off, name, mime,
            collection, replication, ttl,
        )
        if len(offsets) > 1:
            # wrap_context: the pool workers must upload under THIS
            # request's trace, not as orphan roots
            chunks = list(self._pool.map(trace.wrap_context(upload_one),
                                         offsets))
        elif data:
            chunks = [upload_one(0)]
        entry = filer_pb2.Entry(name=name)
        for k, v in (extended or {}).items():
            # caller-supplied extended attrs (the geo applier passes the
            # ORIGIN's HLC stamp through here so LWW compares origin
            # write time, not relay time)
            entry.extended[k] = v
        entry.chunks.extend(self.manifestize_chunks(chunks, path=path))
        entry.attributes.file_size = len(data)
        entry.attributes.mime = mime
        entry.attributes.mtime = int(time.time())
        entry.attributes.crtime = int(time.time())
        entry.attributes.file_mode = 0o644
        entry.attributes.collection = collection
        entry.attributes.replication = replication
        entry.attributes.ttl_sec = ttl_sec
        self.filer.create_entry(directory, entry, signatures=signatures)
        return entry

    def apply_path_conf(self, path: str, collection: str,
                        replication: str, ttl: str) -> tuple[str, str, str]:
        """Fill unset storage knobs from the matching filer.conf rule.

        /etc/ is exempt: the conf file itself (and the IAM identity
        json) must never land on a TTL'd or deletable-collection volume
        a broad rule selects — that would self-destruct the config."""
        if path.startswith("/etc/"):
            return collection, replication, ttl
        if collection and replication and ttl:
            return collection, replication, ttl
        rule = self.filer_conf.match(path)
        if rule is None:
            return collection, replication, ttl
        return (collection or rule.get("collection", ""),
                replication or rule.get("replication", ""),
                ttl or rule.get("ttl", ""))

    def _upload_chunk(self, blob: bytes, offset: int, name: str, mime: str,
                      collection: str, replication: str, ttl: str
                      ) -> filer_pb2.FileChunk:
        """Assign + upload one chunk.  When the assigned volume server
        cannot take the write even after upload_data's own retries, the
        chunk is RE-ASSIGNED — the master hands out a different target
        and the stale fid is abandoned (it was never recorded anywhere,
        so it costs nothing)."""
        from ..util.cipher import maybe_seal

        from ..operation.upload import VolumeFullError

        stored, cipher_key = maybe_seal(blob, self.cipher)
        last: Exception | None = None
        round_no, rounds = 0, 3
        while round_no < rounds:
            round_no += 1
            result = assign_any(
                self._master_order(), count=1, collection=collection,
                replication=replication, ttl=ttl,
            )
            try:
                up = upload_data(
                    result.fid_url(), stored, filename=name, mime=mime,
                    jwt=result.auth,
                )
            except Exception as e:  # noqa: BLE001 - re-assign and retry
                last = e
                reason = "reassign"
                if isinstance(e, VolumeFullError):
                    # typed 409: the target disk is full.  The volume
                    # server forced a heartbeat, so the master excludes
                    # it within ~one pulse — a short pause + extra
                    # rounds beats failing a healthy cluster's write
                    # during that propagation window
                    reason = "volume_full"
                    rounds = max(rounds, 6)
                    time.sleep(0.2)
                failsafe.RETRY_COUNTER.labels(
                    "filer", "upload_chunk", reason).inc()
                glog.warning(
                    "chunk upload to %s failed (%s); re-assigning trace=%s",
                    result.url, e, trace.current_trace_id() or "-")
                continue
            chunk = filechunks.make_chunk(
                result.fid, offset, len(blob), time.time_ns(), e_tag=up.etag
            )
            chunk.cipher_key = cipher_key
            return chunk
        raise IOError(f"chunk upload failed after re-assigns: {last}")

    def _precheck_quota(self, directory: str, name: str,
                        new_bytes: int, append: bool = False) -> None:
        from .filer import _entry_bytes
        from .fleet.tenant import tenant_for_path

        tenant = tenant_for_path(f"{directory}/{name}")
        if not tenant:
            return
        old = self.filer.store.find_entry(directory, name)
        old_is_file = old is not None and not old.is_directory
        d_bytes = new_bytes if append else (
            new_bytes - (_entry_bytes(old) if old_is_file else 0))
        self.tenants.check_quota(
            tenant, 0 if old_is_file else 1, d_bytes)

    def append_file(self, path: str, data: bytes, mime: str = "",
                    collection: str = "", replication: str = "",
                    ttl: str = "") -> filer_pb2.Entry:
        """Append bytes as a new chunk (AppendToEntry semantics over HTTP;
        used by log-style writers like the message broker)."""
        directory, name = split_path(path)
        self._precheck_quota(directory, name, len(data), append=True)
        collection, replication, ttl = self.apply_path_conf(
            path, collection, replication, ttl)
        chunk = self._upload_chunk(
            data, 0, name, mime, collection or self.filer.bucket_collection(path),
            replication, ttl,
        )
        self.filer.append_chunks(directory, name, [chunk])
        return self.filer.store.find_entry(directory, name)

    # -- read path ---------------------------------------------------------

    def read_entry_range(self, entry: filer_pb2.Entry, offset: int,
                         size: int) -> bytes:
        if entry.content:  # inline small-file content
            return bytes(entry.content[offset : offset + size])
        chunks = self.resolve_chunks(list(entry.chunks))
        views = filechunks.view_from_chunks(chunks, offset, size)
        if not views:
            return b""
        if len(views) == 1:
            return self._fetch_view(views[0])
        parts = list(self._pool.map(trace.wrap_context(self._fetch_view),
                                    views))
        # assemble honoring logical offsets (holes read as zeros)
        out = bytearray(size)
        for v, blob in zip(views, parts):
            lo = v.logical_offset - offset
            out[lo : lo + len(blob)] = blob
        return bytes(out)

    def resolve_chunks(self, chunks: list) -> list:
        """Expand manifest chunks (cached) into the real chunk list."""
        if not filechunk_manifest.has_chunk_manifest(chunks):
            return chunks
        return filechunk_manifest.resolve_chunk_manifest(
            self._fetch_whole, chunks
        )

    def _download_failover(self, file_id: str,
                           range_header: str | None = None) -> bytes:
        """Fetch chunk bytes with replica failover + EC degraded-read
        fallback.

        Round 0 walks the cached locations (breaker-gated, connection-
        refused locations evicted from the vid cache).  Round 1 forces a
        fresh master lookup — after a volume moved, lost its last live
        replica, or was EC-encoded, the master's answer names the servers
        that can still produce the bytes (EC shard holders rebuild the
        needle on the fly), so a 5xx only surfaces once even the rebuilt
        path is gone."""
        vid = int(file_id.split(",", 1)[0])

        def urls_for(round_no: int) -> list[str]:
            return self.master_client.lookup_file_id(
                file_id, refresh=round_no > 0)

        def fetch(url: str) -> bytes:
            faultpoint.inject(FP_CHUNK_FETCH, ctx=url)
            # single attempt per location: rotation IS the retry here
            return download(url, range_header=range_header, retries=1,
                            use_breaker=False)

        def on_failure(url: str, exc: BaseException) -> None:
            if failsafe.is_connection_refused(exc):
                self.master_client.invalidate_location(vid, url)

        try:
            with failsafe.deadline_scope(CHUNK_READ_DEADLINE_S):
                return failsafe.call_with_failover(
                    urls_for, fetch, op="chunk_read", retry_type="filer",
                    policy=failsafe.RetryPolicy(
                        max_attempts=2, base_delay=0.05, max_delay=0.5),
                    idempotent=True, on_peer_failure=on_failure,
                    peer_key=_netloc,
                )
        except failsafe.CircuitOpenError:
            raise IOError(f"no locations for chunk {file_id}")
        except Exception as e:
            raise IOError(f"chunk {file_id} unreadable: {e}") from e

    def _fetch_whole(self, file_id: str) -> bytes:
        """Whole-chunk fetch through the tiered cache."""
        cached = self.chunk_cache.get(file_id)
        if cached is not None:
            return cached
        blob = self._download_failover(file_id)
        self.chunk_cache.set(file_id, blob)
        return blob

    def _fetch_view(self, view: filechunks.ChunkView) -> bytes:
        if view.cipher_key:
            # GCM cannot be ranged: fetch the whole stored blob (cached
            # as ciphertext), decrypt, then slice the logical view
            from ..util.cipher import decrypt

            blob = decrypt(self._fetch_whole(view.file_id),
                           bytes(view.cipher_key))
            return blob[view.offset : view.offset + view.size]
        cached = self.chunk_cache.get(view.file_id)
        if cached is not None:
            return cached[view.offset : view.offset + view.size]
        # small chunks: fetch whole + cache; large: ranged read, no cache
        if view.chunk_size and view.chunk_size <= (self.max_mb << 20):
            blob = self._fetch_whole(view.file_id)
            return blob[view.offset : view.offset + view.size]
        rng = f"bytes={view.offset}-{view.offset + view.size - 1}"
        return self._download_failover(view.file_id, range_header=rng)

    def manifestize_chunks(self, chunks: list, path: str = "") -> list:
        """Fold an over-long chunk list into manifest chunks before the
        entry hits the metadata store (filer_grpc_server.go MaybeManifestize
        on create/update)."""

        def save(blob: bytes) -> filer_pb2.FileChunk:
            result = assign_any(
                self._master_order(), count=1,
                collection=self.filer.bucket_collection(path),
            )
            upload_data(result.fid_url(), blob, jwt=result.auth)
            return filechunks.make_chunk(result.fid, 0, len(blob),
                                         time.time_ns())

        return filechunk_manifest.maybe_manifestize(
            save, chunks, self.manifest_batch
        )

    # -- collections / brokers --------------------------------------------

    def delete_collection(self, collection: str) -> None:
        from ..pb import master_pb2

        self.filer.delete_collection_entries(collection)
        for m in self._master_order():
            try:
                rpclib.master_stub(m, timeout=30).CollectionDelete(
                    master_pb2.CollectionDeleteRequest(name=collection)
                )
                return
            except Exception:
                continue

    def register_broker(self, resource: str, grpc_address: str) -> None:
        self._brokers.setdefault(resource, [])
        if grpc_address not in self._brokers[resource]:
            self._brokers[resource].append(grpc_address)

    def locate_broker(self, resource: str) -> filer_pb2.LocateBrokerResponse:
        resp = filer_pb2.LocateBrokerResponse(found=resource in self._brokers)
        for addr in self._brokers.get(resource, ()):
            resp.resources.add(grpc_addresses=addr, resource_count=1)
        return resp


def _refuse_left_out(peers, cluster_id, geo_peers, notification) -> None:
    """The planes the port has not yet: raise ValueError naming A-7."""
    left_out = []
    if [p for p in (peers or []) if p.strip()]:
        left_out.append("peers (the meta aggregator, filer/"
                        "meta_aggregator.py, ROADMAP A-7c)")
    if cluster_id or [p for p in (geo_peers or []) if p.strip()]:
        left_out.append("cluster_id / geo_peers (replication/geo.py, "
                        "ROADMAP A-7c)")
    if notification is not None:
        left_out.append("a notification publisher (notification/, "
                        "ROADMAP A-7b)")
    if left_out:
        raise ValueError(f"filer: {'; '.join(left_out)} not ported yet")


def _ttl_seconds(ttl: str) -> int:
    if not ttl:
        return 0
    units = {"s": 1, "m": 60, "h": 3600, "d": 86400, "w": 604800}
    try:
        if ttl[-1] in units:
            return int(ttl[:-1]) * units[ttl[-1]]
        return int(ttl)
    except ValueError:
        return 0
