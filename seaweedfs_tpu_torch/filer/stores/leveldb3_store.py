"""leveldb3-class FilerStore: adaptive per-bucket partitioning.

The port's copy of seaweedfs_tpu/filer/stores/leveldb3_store.py.

Reference: weed/filer/leveldb3/leveldb3_store.go:30-160 — one `_main` DB
for the general namespace plus one lazily-created DB per S3 bucket:
paths under ``/buckets/<bucket>/...`` route to the bucket's own DB and
are stored with the bucket prefix stripped (short path), so a bucket's
metadata lives in its own directory tree on disk.  Deleting the bucket's
subtree (`DeleteFolderChildren("/buckets/<bucket>")`) drops the whole DB
directory in O(1) instead of iterating entries — the property that makes
this the reference's preferred store for heavy S3 use.

Each partition is the framework's embedded bitcask-style store
(leveldb_store.py), living in ``dir/_main`` / ``dir/<bucket>`` exactly
like the reference's folder layout.  KV pairs always live in `_main`.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Iterator

from ...pb import filer_pb2
from ..filerstore import FilerStore, register_store
from .leveldb_store import LevelDbStore

DEFAULT = "_main"
_BUCKETS_PREFIX = "/buckets/"


@register_store("leveldb3")
class LevelDb3Store(FilerStore):
    name = "leveldb3"

    def __init__(self, path: str = "./filerldb3", **kw):
        self.dir = path
        self._kw = kw
        self._lock = threading.Lock()
        os.makedirs(path, exist_ok=True)
        self._dbs: dict[str, LevelDbStore] = {}
        # adopt bucket DBs left by a previous run
        for name in sorted(os.listdir(path)):
            if os.path.isdir(os.path.join(path, name)):
                self._dbs[name] = self._load(name)
        if DEFAULT not in self._dbs:
            self._dbs[DEFAULT] = self._load(DEFAULT)

    def _load(self, name: str) -> LevelDbStore:
        return LevelDbStore(path=os.path.join(self.dir, name), **self._kw)

    def _find_db(
        self, fullpath: str, for_children: bool = False
    ) -> tuple[LevelDbStore, str, str]:
        """-> (db, bucket, short_path); mirrors findDB
        (leveldb3_store.go:93-140).  Routing is by the ENTRY's full path —
        so `/buckets/b1/obj` (an object at bucket top level) lands in the
        b1 DB as `/obj` — while the bucket entry `/buckets/b1` itself
        stays in `_main` as a child of `/buckets`."""
        if not fullpath.startswith(_BUCKETS_PREFIX):
            return self._dbs[DEFAULT], DEFAULT, fullpath
        rest = fullpath[len(_BUCKETS_PREFIX):]
        t = rest.find("/")
        if t < 0 and not for_children:
            # `/buckets/<bucket>` as an ENTRY lives in its parent's
            # partition (_main); as a listing target it is the bucket root
            return self._dbs[DEFAULT], DEFAULT, fullpath
        bucket = rest if t < 0 else rest[:t]
        short = "/" if t < 0 else rest[t:]
        with self._lock:
            db = self._dbs.get(bucket)
            if db is None:
                db = self._dbs[bucket] = self._load(bucket)
        return db, bucket, short

    @staticmethod
    def _join(directory: str, name: str) -> str:
        return (directory.rstrip("/") or "") + "/" + name

    @staticmethod
    def _split(short: str) -> tuple[str, str]:
        i = short.rfind("/")
        return (short[:i] or "/", short[i + 1:])

    # -- entries -----------------------------------------------------------

    def insert_entry(self, directory: str, entry: filer_pb2.Entry) -> None:
        db, _, short = self._find_db(self._join(directory, entry.name))
        sdir, _ = self._split(short)
        db.insert_entry(sdir, entry)

    def update_entry(self, directory: str, entry: filer_pb2.Entry) -> None:
        db, _, short = self._find_db(self._join(directory, entry.name))
        sdir, _ = self._split(short)
        db.update_entry(sdir, entry)

    def find_entry(self, directory: str, name: str) -> filer_pb2.Entry | None:
        db, _, short = self._find_db(self._join(directory, name))
        sdir, sname = self._split(short)
        return db.find_entry(sdir, sname)

    def delete_entry(self, directory: str, name: str) -> None:
        db, _, short = self._find_db(self._join(directory, name))
        sdir, sname = self._split(short)
        db.delete_entry(sdir, sname)

    def delete_folder_children(self, directory: str) -> None:
        norm = directory.rstrip("/") or "/"
        if norm in ("/", "/buckets"):
            # the subtree covers EVERY bucket: drop all bucket DBs, not
            # just the _main stubs — otherwise recreating a bucket would
            # lazily re-open its old DB and resurrect deleted objects
            with self._lock:
                buckets = [b for b in self._dbs if b != DEFAULT]
                dbs = [self._dbs.pop(b) for b in buckets]
            for db in dbs:
                db.close()
            for b in buckets:
                shutil.rmtree(os.path.join(self.dir, b),
                              ignore_errors=True)
            self._dbs[DEFAULT].delete_folder_children(directory)
            return
        db, bucket, short = self._find_db(directory, for_children=True)
        if bucket != DEFAULT and short == "/":
            # whole-bucket delete: drop the DB directory in O(1)
            # (leveldb3_store.go:248-261)
            with self._lock:
                db = self._dbs.pop(bucket, None)
            if db is not None:
                db.close()
            shutil.rmtree(os.path.join(self.dir, bucket),
                          ignore_errors=True)
            return
        db.delete_folder_children(short)

    def list_entries(
        self,
        directory: str,
        start_from: str = "",
        inclusive: bool = False,
        prefix: str = "",
        limit: int = 1024,
    ) -> Iterator[filer_pb2.Entry]:
        db, _, short = self._find_db(directory, for_children=True)
        return db.list_entries(
            short, start_from=start_from, inclusive=inclusive,
            prefix=prefix, limit=limit)

    # -- kv ----------------------------------------------------------------

    def kv_get(self, key: bytes) -> bytes | None:
        return self._dbs[DEFAULT].kv_get(key)

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._dbs[DEFAULT].kv_put(key, value)

    def close(self) -> None:
        with self._lock:
            dbs, self._dbs = list(self._dbs.values()), {}
        for db in dbs:
            db.close()
