"""Filer core: path namespace over a FilerStore, with chunk lifecycle.

The port's copy of seaweedfs_tpu/filer/filer.py.

Reference: weed/filer/filer.go:30-45 plus filer_delete_entry.go /
filer_deletion.go (recursive delete + async blob deletion queue) and
filer_notify.go (metadata event log).  Paths are absolute ("/a/b/c");
an entry lives at (directory="/a/b", name="c").  Buckets live under
/buckets/<name> and map to collections.
"""

from __future__ import annotations

import os
import queue
import threading
import time

from ..pb import filer_pb2
from ..util import faultpoint, glog
from . import filechunks
from .filerstore import FilerStore
from .fleet.tenant import tenant_for_path
from .meta_log import (
    GEO_HLC_KEY,
    MetaLogBuffer,
    decode_hlc,
    encode_hlc,
    tombstone_key,
)

ROOT = "/"
DIR_BUCKETS = "/buckets"

FP_STORE_INSERT = faultpoint.register("filer.store.insert")


def _entry_bytes(entry: filer_pb2.Entry) -> int:
    """Logical size of a file entry for tenant accounting."""
    return (filechunks.total_size(entry.chunks)
            or entry.attributes.file_size or len(entry.content))


def split_path(path: str) -> tuple[str, str]:
    path = "/" + path.strip("/")
    if path == "/":
        return "/", ""
    directory, name = path.rsplit("/", 1)
    return directory or "/", name


def join_path(directory: str, name: str) -> str:
    if not name:
        return directory
    return (directory.rstrip("/") or "") + "/" + name


class Filer:
    def __init__(self, store: FilerStore, delete_chunks_fn=None,
                 resolve_chunks_fn=None, meta_log_dir: str | None = None,
                 meta_log_fsync: bool | None = None):
        """``delete_chunks_fn(file_ids: list[str])`` deletes blobs; when
        None, chunk deletion is a no-op (offline/metadata-only use).

        ``resolve_chunks_fn(chunks) -> chunks`` expands manifest chunks;
        garbage-collection diffs run over EXPANDED lists on both sides so
        a chunk folded into a manifest is never mistaken for garbage
        (reference: MinusChunks with a lookup fn, filechunk_manifest.go).

        ``meta_log_dir`` makes the metadata event log durable (fsynced
        segment files, monotonic gap-detectable sequence numbers) — the
        substrate the geo replication plane tails.
        """
        self.store = store
        self.meta_log = MetaLogBuffer(dir=meta_log_dir,
                                      fsync=meta_log_fsync)
        # striped per-path locks serializing every stamped mutation of
        # one path against the geo applier's LWW check-then-write
        # (replication/geo.py): without them a concurrent newer local
        # write landing between the applier's stamp read and its store
        # write would be silently overwritten by an older remote event
        self._path_locks = [threading.RLock()
                            for _ in range(256)]  # power of two: masked
        # geo plane: when enabled, every mutation stamps the entry with a
        # hybrid-logical-clock (ts_ns, cluster_id) pair and deletes leave
        # tombstones, so active-active peers can resolve last-writer-wins
        self.cluster_id = 0
        self.geo_stamp = False
        # fleet.TenantManager when the sharded metadata plane is on:
        # quota checks + usage accounting run HERE, in the local
        # mutation path only — meta_aggregator replays write straight to
        # the store, so each tenant is accounted exactly once fleet-wide
        # (on the shard that owns its bucket)
        self.tenants = None
        self._append_lock = threading.Lock()
        # serializes hardlink KV counter read-modify-writes: two
        # concurrent unlinks must not both read counter=2/write 1 and
        # leak the shared chunks forever
        self._hardlink_lock = threading.Lock()
        self._delete_fn = delete_chunks_fn
        self._resolve_fn = resolve_chunks_fn
        self._deletion_q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._deleter = threading.Thread(target=self._deletion_loop,
                                         name="filer-deleter", daemon=True)
        self._deleter.start()

    def close(self) -> None:
        """Stop the deferred-deletion worker (joined: the port leaves no
        thread behind), then close the log and the store."""
        self._stop.set()
        self._deletion_q.put(None)
        self._deleter.join(timeout=30.0)
        self.meta_log.close()
        self.store.close()

    # -- hardlinks (filerstore_hardlink.go:12-40) --------------------------
    #
    # A hardlinked file's shared truth (attributes + chunks + counter)
    # lives in the store's KV space keyed by the 17-byte hard_link_id;
    # directory entries are stubs carrying the id.  Reads merge the KV
    # meta back in; unlink decrements the counter and reclaims the data
    # chunks only when the LAST link dies.

    @staticmethod
    def _encode_hardlink_meta(entry: filer_pb2.Entry) -> bytes:
        meta = filer_pb2.Entry(
            hard_link_id=entry.hard_link_id,
            hard_link_counter=entry.hard_link_counter,
        )
        meta.attributes.CopyFrom(entry.attributes)
        meta.chunks.extend(entry.chunks)
        for k, v in entry.extended.items():
            meta.extended[k] = v
        return meta.SerializeToString()

    def _set_hardlink(self, entry: filer_pb2.Entry) -> None:
        if entry.hard_link_id:
            with self._hardlink_lock:
                self.store.kv_put(bytes(entry.hard_link_id),
                                  self._encode_hardlink_meta(entry))

    def _maybe_read_hardlink(
        self, entry: filer_pb2.Entry | None
    ) -> filer_pb2.Entry | None:
        if entry is None or not entry.hard_link_id:
            return entry
        blob = self.store.kv_get(bytes(entry.hard_link_id))
        if not blob:
            return entry  # dangling link: serve the stub as-is
        meta = filer_pb2.Entry.FromString(blob)
        entry.attributes.CopyFrom(meta.attributes)
        del entry.chunks[:]
        entry.chunks.extend(meta.chunks)
        entry.hard_link_counter = meta.hard_link_counter
        for k, v in meta.extended.items():
            entry.extended[k] = v
        return entry

    def _delete_hardlink(self, hard_link_id: bytes,
                         is_delete_data: bool) -> None:
        """Decrement the link counter; on the last unlink drop the KV meta
        and reclaim the shared chunks (the per-entry stub's chunk list is
        never trusted for deletion — the KV meta is the owner)."""
        key = bytes(hard_link_id)
        with self._hardlink_lock:
            blob = self.store.kv_get(key)
            if not blob:
                return
            meta = filer_pb2.Entry.FromString(blob)
            meta.hard_link_counter -= 1
            if meta.hard_link_counter <= 0:
                if is_delete_data and meta.chunks:
                    self.queue_chunk_deletion(self._all_fids(meta.chunks))
                self.store.kv_delete(key)
                return
            self.store.kv_put(key, meta.SerializeToString())

    # -- geo stamping ------------------------------------------------------

    def _stripe_index(self, path: str) -> int:
        return hash(path) & (len(self._path_locks) - 1)

    def path_mutation_lock(self, path: str) -> threading.RLock:
        """The stripe lock covering ``path``: reentrant, so the geo
        applier can hold it across its LWW check + write-through while
        create/delete below re-acquire it."""
        return self._path_locks[self._stripe_index(path)]

    def _geo_ts(self, entry: filer_pb2.Entry | None = None,
                relay: bool = False) -> int | None:
        """HLC-stamp a mutation (geo mode only): stamps ``entry``'s
        extended map and returns the clock value so the metadata event
        carries the SAME ts as the stored stamp.  A RELAY (``relay=``:
        the mutation carries replication signatures — geo applies,
        within-cluster sink/aggregator writes) keeps an existing stamp:
        LWW must compare origin write time, not relay time — it returns
        None so the EVENT still stamps fresh and monotonic.  A direct
        client mutation that happens to echo a stored stamp back (a
        read-modify-write UpdateEntry: chmod, touch) is a NEW write and
        is re-stamped — honoring the echoed stamp would make the update
        compare equal to the overwritten version everywhere and never
        replicate."""
        if not self.geo_stamp:
            return None
        if entry is not None and GEO_HLC_KEY in entry.extended:
            stamp = decode_hlc(bytes(entry.extended[GEO_HLC_KEY]))
            if relay and stamp is not None:
                self.meta_log.observe(stamp[0])
                return None
            del entry.extended[GEO_HLC_KEY]
        ts = self.meta_log.next_ts()
        if entry is not None:
            entry.extended[GEO_HLC_KEY] = encode_hlc(ts, self.cluster_id)
        return ts

    # -- create/update -----------------------------------------------------

    def create_entry(self, directory: str, entry: filer_pb2.Entry,
                     o_excl: bool = False, signatures=None) -> None:
        with self.path_mutation_lock(join_path(directory, entry.name)):
            self._create_entry_locked(directory, entry, o_excl,
                                      signatures)

    def _create_entry_locked(self, directory: str,
                             entry: filer_pb2.Entry,
                             o_excl: bool = False,
                             signatures=None) -> None:
        # read the old entry MERGED so a hardlinked file's true (shared)
        # chunk list is what the rewrite diff below runs against —
        # diffing the stub would leak every shadowed chunk forever
        old = self._maybe_read_hardlink(
            self.store.find_entry(directory, entry.name))
        if old is not None and o_excl:
            raise FileExistsError(join_path(directory, entry.name))
        self._ensure_parents(directory, signatures=signatures)
        if not entry.attributes.crtime:
            entry.attributes.crtime = int(time.time())
        if not entry.attributes.mtime:
            entry.attributes.mtime = int(time.time())
        # quota gate BEFORE any mutation: a rejection must leave the
        # store (including hardlink KV counters) untouched
        tenant, d_objects, d_bytes = self._tenant_delta(
            directory, entry, old)
        geo_ts = self._geo_ts(entry, relay=bool(signatures))
        self._set_hardlink(entry)
        broke_link = (old is not None and old.hard_link_id
                      and old.hard_link_id != entry.hard_link_id)
        if broke_link:
            # overwrite breaks the old link (handleUpdateToHardLinks);
            # the counter logic owns the shared chunks' lifetime here —
            # other links may still reference them, so no rewrite diff
            self._delete_hardlink(old.hard_link_id, is_delete_data=True)
        faultpoint.inject(FP_STORE_INSERT,
                          ctx=join_path(directory, entry.name))
        self.store.insert_entry(directory, entry)
        if tenant:
            self.tenants.record(tenant, d_objects, d_bytes)
        # blobs shadowed by the rewrite get deleted asynchronously; runs
        # for plain entries AND for a hardlinked entry rewritten in place
        # (same id: every link now sees the new chunks via the KV meta)
        if not broke_link and old is not None and old.chunks:
            self.queue_chunk_deletion(
                self._garbage_fids(old.chunks, entry.chunks)
            )
        self.meta_log.append(directory, old, entry, signatures=signatures,
                             ts=geo_ts)

    def update_entry(self, directory: str, entry: filer_pb2.Entry,
                     signatures=None) -> None:
        with self.path_mutation_lock(join_path(directory, entry.name)):
            self._update_entry_locked(directory, entry, signatures)

    def _update_entry_locked(self, directory: str,
                             entry: filer_pb2.Entry,
                             signatures=None) -> None:
        old = self._maybe_read_hardlink(
            self.store.find_entry(directory, entry.name))
        if old is None:
            raise FileNotFoundError(join_path(directory, entry.name))
        tenant, d_objects, d_bytes = self._tenant_delta(
            directory, entry, old)
        geo_ts = self._geo_ts(entry, relay=bool(signatures))
        self._set_hardlink(entry)
        if (old.hard_link_id
                and old.hard_link_id != entry.hard_link_id):
            self._delete_hardlink(old.hard_link_id, is_delete_data=True)
            self.store.update_entry(directory, entry)
        else:
            self.store.update_entry(directory, entry)
            if old.chunks:
                self.queue_chunk_deletion(
                    self._garbage_fids(old.chunks, entry.chunks)
                )
        if tenant:
            self.tenants.record(tenant, d_objects, d_bytes)
        self.meta_log.append(directory, old, entry, signatures=signatures,
                             ts=geo_ts)

    def _tenant_delta(self, directory: str, entry: filer_pb2.Entry,
                      old: filer_pb2.Entry | None) -> tuple[str, int, int]:
        """-> (tenant, d_objects, d_bytes) for writing ``entry`` over
        ``old``, AFTER passing the quota gate (raises QuotaExceededError
        when the delta would overflow the tenant's bounds).  Directories
        carry no usage; untenanted paths return ("", 0, 0)."""
        if self.tenants is None or entry.is_directory:
            return "", 0, 0
        tenant = tenant_for_path(join_path(directory, entry.name))
        if not tenant:
            return "", 0, 0
        old_is_file = old is not None and not old.is_directory
        d_objects = 0 if old_is_file else 1
        d_bytes = _entry_bytes(entry) - (
            _entry_bytes(old) if old_is_file else 0)
        self.tenants.check_quota(tenant, d_objects, d_bytes)
        return tenant, d_objects, d_bytes

    def _garbage_fids(self, old_chunks, new_chunks) -> list[str]:
        """fids in old but not new, with manifests EXPANDED on both sides
        so a chunk folded into a manifest is never mistaken for garbage.
        A resolution failure skips collection (leak beats corruption)."""
        try:
            garbage = filechunks.minus_chunks(
                self._expanded(old_chunks), self._expanded(new_chunks)
            )
        except Exception:
            glog.warning("manifest unresolvable; skipping GC of a rewrite")
            return []
        return [c.file_id for c in garbage]

    def _expanded(self, chunks) -> list:
        """Chunk list + everything reachable through its manifests."""
        chunks = list(chunks)
        if self._resolve_fn is None or not any(
            c.is_chunk_manifest for c in chunks
        ):
            return chunks
        return chunks + [
            c for c in self._resolve_fn(chunks) if not c.is_chunk_manifest
        ]

    def _all_fids(self, chunks) -> list[str]:
        """Every fid a file's deletion must reclaim: the chunks themselves
        plus everything inside their manifests (resolve-before-delete,
        filer_delete_entry.go).  Unresolvable manifests delete what is
        known rather than failing the metadata removal."""
        try:
            return [c.file_id for c in self._expanded(chunks)]
        except Exception:
            glog.warning("manifest unresolvable; inner chunks may leak")
            return [c.file_id for c in chunks]

    def append_chunks(self, directory: str, name: str, chunks) -> None:
        # serialize the read-modify-write: two concurrent appenders would
        # otherwise both read the same chunk list and one would lose
        # chunks (the path stripe additionally fences the geo applier;
        # lock order append->stripe is safe: no holder of a stripe ever
        # takes the append lock)
        with self._append_lock, \
                self.path_mutation_lock(join_path(directory, name)):
            # merged read: appending to a hardlinked file must extend the
            # SHARED chunk list, not the stub's stale copy
            entry = self._maybe_read_hardlink(
                self.store.find_entry(directory, name))
            existed = entry is not None
            if entry is None:
                self._ensure_parents(directory)
                entry = filer_pb2.Entry(name=name)
                entry.attributes.crtime = int(time.time())
            offset = filechunks.total_size(entry.chunks)
            added = 0
            for c in chunks:
                c2 = filer_pb2.FileChunk()
                c2.CopyFrom(c)
                c2.offset = offset
                offset += c2.size
                added += c2.size
                entry.chunks.append(c2)
            entry.attributes.mtime = int(time.time())
            entry.attributes.file_size = offset
            tenant = ""
            if self.tenants is not None:
                tenant = tenant_for_path(join_path(directory, name))
                if tenant:
                    self.tenants.check_quota(
                        tenant, 0 if existed else 1, added)
            # a geo append is a fresh local write (appends never relay an
            # origin stamp), so drop any stale stamp before re-stamping
            entry.extended.pop(GEO_HLC_KEY, None)
            geo_ts = self._geo_ts(entry)
            self._set_hardlink(entry)
            self.store.insert_entry(directory, entry)
            if tenant:
                self.tenants.record(tenant, 0 if existed else 1, added)
            self.meta_log.append(directory, None, entry, ts=geo_ts)

    def _ensure_parents(self, directory: str, signatures=None,
                        stamp: bytes | None = None) -> None:
        """mkdir -p the ancestor chain (filer.go ensures parent dirs).
        The dir-creation events inherit the mutation's signatures so
        bidirectional sync filters them like the triggering write.

        ``stamp`` (a geo apply relaying a remote mkdir) pins the created
        dirs to the ORIGIN's HLC: without it they would stamp as local
        apply-time, and a backlog-drained delete/rename of the dir —
        carrying the origin's older hlc — would lose LWW to the dir's
        own arrival time and never apply."""
        if directory in ("/", ""):
            return
        parent, name = split_path(directory)
        existing = self.store.find_entry(parent, name)
        if existing is not None:
            return
        self._ensure_parents(parent, signatures=signatures, stamp=stamp)
        d = filer_pb2.Entry(name=name, is_directory=True)
        d.attributes.crtime = int(time.time())
        d.attributes.mtime = d.attributes.crtime
        d.attributes.file_mode = 0o40755  # dir bit
        if stamp:
            d.extended[GEO_HLC_KEY] = stamp
        self.store.insert_entry(parent, d)
        self.meta_log.append(parent, None, d, signatures=signatures)

    # -- read --------------------------------------------------------------

    def find_entry(self, path: str) -> filer_pb2.Entry | None:
        directory, name = split_path(path)
        if name == "":
            root = filer_pb2.Entry(name="/", is_directory=True)
            return root
        return self._maybe_read_hardlink(
            self.store.find_entry(directory, name))

    def list_directory(self, directory: str, start_from: str = "",
                       inclusive: bool = False, prefix: str = "",
                       limit: int = 1024):
        for e in self.store.list_entries(
            directory, start_from, inclusive, prefix, limit
        ):
            yield self._maybe_read_hardlink(e)

    # -- delete ------------------------------------------------------------

    def delete_entry(self, directory: str, name: str,
                     is_recursive: bool = False,
                     ignore_recursive_error: bool = False,
                     is_delete_data: bool = True,
                     signatures=None,
                     tombstone: bytes | None = None) -> None:
        with self.path_mutation_lock(join_path(directory, name)):
            self._delete_entry_locked(
                directory, name, is_recursive, ignore_recursive_error,
                is_delete_data, signatures, tombstone)

    def _delete_entry_locked(self, directory: str, name: str,
                             is_recursive: bool = False,
                             ignore_recursive_error: bool = False,
                             is_delete_data: bool = True,
                             signatures=None,
                             tombstone: bytes | None = None) -> None:
        entry = self.store.find_entry(directory, name)
        if entry is None:
            raise FileNotFoundError(join_path(directory, name))
        if entry.is_directory:
            path = join_path(directory, name)
            children = list(self.store.list_entries(path, limit=2))
            if children and not is_recursive:
                raise IsADirectoryError(f"{path} is not empty")
            try:
                self._delete_tree(path, is_delete_data)
            except Exception:
                if not ignore_recursive_error:
                    raise
        elif entry.hard_link_id:
            # unlink: the KV meta owns the shared chunks' lifetime
            self._delete_hardlink(entry.hard_link_id, is_delete_data)
        elif is_delete_data and entry.chunks:
            self.queue_chunk_deletion(self._all_fids(entry.chunks))
        geo_ts = None
        if self.geo_stamp:
            # tombstone: a late-arriving older geo create must not
            # resurrect this path (replication/geo.py LWW compare).  A
            # relay (geo apply) passes ``tombstone=`` carrying the
            # ORIGIN's stamp: it must be in the KV BEFORE the event is
            # appended below, or a tailing replicator relaying the
            # delete onward could read a fresh local stamp and inflate
            # the fence around a 3+-cluster mesh
            if tombstone is None:
                geo_ts = self.meta_log.next_ts()
                tombstone = encode_hlc(geo_ts, self.cluster_id)
            self.store.kv_put(tombstone_key(join_path(directory, name)),
                              tombstone)
        self.store.delete_entry(directory, name)
        if self.tenants is not None and not entry.is_directory:
            tenant = tenant_for_path(join_path(directory, name))
            if tenant:
                self.tenants.record(tenant, -1, -_entry_bytes(entry))
        self.meta_log.append(
            directory, entry, None, delete_chunks=is_delete_data,
            signatures=signatures, ts=geo_ts,
        )

    def _delete_tree(self, path: str, is_delete_data: bool) -> None:
        """Collect chunk fids of the whole subtree, then drop the metadata."""
        tenant = (tenant_for_path(path)
                  if self.tenants is not None else "")
        stack = [path]
        while stack:
            d = stack.pop()
            start = ""
            while True:
                batch = list(self.store.list_entries(d, start_from=start, limit=1024))
                if not batch:
                    break
                for e in batch:
                    if e.is_directory:
                        stack.append(join_path(d, e.name))
                    elif e.hard_link_id:
                        self._delete_hardlink(e.hard_link_id, is_delete_data)
                    elif is_delete_data and e.chunks:
                        self.queue_chunk_deletion(self._all_fids(e.chunks))
                    if tenant and not e.is_directory:
                        self.tenants.record(tenant, -1, -_entry_bytes(e))
                start = batch[-1].name
        self.store.delete_folder_children(path)

    # -- rename ------------------------------------------------------------

    def rename_entry(self, old_dir: str, old_name: str,
                     new_dir: str, new_name: str) -> None:
        """AtomicRenameEntry (filer_grpc_server_rename.go): move the entry
        and, for directories, re-root all children."""
        # both endpoint stripes, in index order (deadlock-free vs a
        # concurrent rename crossing the same pair the other way)
        stripes = sorted({
            self._stripe_index(join_path(old_dir, old_name)),
            self._stripe_index(join_path(new_dir, new_name))})
        for i in stripes:
            self._path_locks[i].acquire()
        try:
            self._rename_entry_locked(old_dir, old_name, new_dir,
                                      new_name)
        finally:
            for i in reversed(stripes):
                self._path_locks[i].release()

    def _rename_entry_locked(self, old_dir: str, old_name: str,
                             new_dir: str, new_name: str) -> None:
        entry = self.store.find_entry(old_dir, old_name)
        if entry is None:
            raise FileNotFoundError(join_path(old_dir, old_name))
        if self.store.find_entry(new_dir, new_name) is not None:
            raise FileExistsError(join_path(new_dir, new_name))
        self._ensure_parents(new_dir)
        moved = filer_pb2.Entry()
        moved.CopyFrom(entry)
        moved.name = new_name
        # a rename is a fresh write at the new path: re-stamp (and
        # tombstone the old path so geo peers don't resurrect it)
        moved.extended.pop(GEO_HLC_KEY, None)
        geo_ts = self._geo_ts(moved)
        if geo_ts is not None:
            self.store.kv_put(tombstone_key(join_path(old_dir, old_name)),
                              encode_hlc(geo_ts, self.cluster_id))
        self.store.insert_entry(new_dir, moved)
        if entry.is_directory:
            old_path = join_path(old_dir, old_name)
            new_path = join_path(new_dir, new_name)
            self._move_children(old_path, new_path)
        self.store.delete_entry(old_dir, old_name)
        if self.tenants is not None and not entry.is_directory:
            # cross-tenant rename moves the usage with the file; renames
            # of whole directories across tenants are not produced by
            # any gateway path and stay advisory
            t_old = tenant_for_path(join_path(old_dir, old_name))
            t_new = tenant_for_path(join_path(new_dir, new_name))
            if t_old != t_new:
                size = _entry_bytes(entry)
                if t_old:
                    self.tenants.record(t_old, -1, -size)
                if t_new:
                    self.tenants.record(t_new, 1, size)
        self.meta_log.append(
            old_dir, entry, moved, new_parent_path=new_dir, ts=geo_ts,
        )

    def _move_children(self, old_path: str, new_path: str) -> None:
        start = ""
        while True:
            batch = list(self.store.list_entries(old_path, start_from=start, limit=1024))
            if not batch:
                break
            for e in batch:
                child = filer_pb2.Entry()
                child.CopyFrom(e)
                self.store.insert_entry(new_path, child)
                if e.is_directory:
                    self._move_children(
                        join_path(old_path, e.name), join_path(new_path, e.name)
                    )
                self.store.delete_entry(old_path, e.name)
            start = batch[-1].name

    # -- buckets / collections --------------------------------------------

    def bucket_collection(self, path: str) -> str:
        """Files under /buckets/<b>/ go to collection <b> (filer.go
        DirBucketsPath convention)."""
        path = "/" + path.strip("/")
        if path.startswith(DIR_BUCKETS + "/"):
            rest = path[len(DIR_BUCKETS) + 1 :]
            return rest.split("/", 1)[0]
        return ""

    def delete_collection_entries(self, collection: str) -> None:
        """Drop /buckets/<collection> metadata (blobs die with the
        collection on the volume servers)."""
        try:
            self.delete_entry(DIR_BUCKETS, collection, is_recursive=True,
                              is_delete_data=False)
        except FileNotFoundError:
            pass

    # -- async blob deletion ----------------------------------------------

    def queue_chunk_deletion(self, file_ids: list[str]) -> None:
        if file_ids:
            self._deletion_q.put(list(file_ids))

    def _deletion_loop(self) -> None:
        while not self._stop.is_set():
            item = self._deletion_q.get()
            if item is None:
                return
            if self._delete_fn is None:
                continue
            try:
                self._delete_fn(item)
            except Exception as e:  # orphaned blobs are an operator
                # problem; losing the error hides them forever
                glog.warning("deferred blob deletion failed: %s", e)

    def drain_deletions(self, timeout: float = 5.0) -> None:
        """Testing hook: wait for queued blob deletions to be processed."""
        deadline = time.monotonic() + timeout
        while not self._deletion_q.empty() and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.05)
