"""leveldb2-class FilerStore: the embedded store, hash-partitioned 8 ways.

The port's copy of seaweedfs_tpu/filer/stores/leveldb2_store.py.

Reference: weed/filer/leveldb2/leveldb2_store.go — same metadata model as
leveldb but the keyspace is split across 8 independent DB instances, with
the LAST md5 byte of the directory choosing the partition
(leveldb2_store.go hashToBytes), so compactions and locks shard with
directory locality and the write path scales across instances.

Here each partition is one of the framework's bitcask-style embedded
stores (leveldb_store.py) living in a numbered subdirectory, exactly the
reference's `dir/00 .. dir/07` layout.  KV pairs route by the same hash of
the key's text form.
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterator

from ...pb import filer_pb2
from ..filerstore import FilerStore, register_store
from .leveldb_store import LevelDbStore


@register_store("leveldb2")
class LevelDb2Store(FilerStore):
    name = "leveldb2"

    def __init__(self, path: str = "./filerldb2", db_count: int = 8, **kw):
        self.dir = path
        self.db_count = db_count
        self._dbs = [
            LevelDbStore(path=os.path.join(path, f"{i:02d}"), **kw)
            for i in range(db_count)
        ]

    def _db(self, directory: str) -> LevelDbStore:
        # last md5 byte picks the partition (leveldb2_store.go hashToBytes)
        x = hashlib.md5(directory.encode()).digest()[-1]
        return self._dbs[x % self.db_count]

    # -- entries -----------------------------------------------------------

    def insert_entry(self, directory: str, entry: filer_pb2.Entry) -> None:
        self._db(directory).insert_entry(directory, entry)

    def update_entry(self, directory: str, entry: filer_pb2.Entry) -> None:
        self._db(directory).update_entry(directory, entry)

    def find_entry(self, directory: str, name: str) -> filer_pb2.Entry | None:
        return self._db(directory).find_entry(directory, name)

    def delete_entry(self, directory: str, name: str) -> None:
        self._db(directory).delete_entry(directory, name)

    def delete_folder_children(self, directory: str) -> None:
        # children of one directory share a partition, but DESCENDANT
        # directories hash elsewhere — the subtree delete must visit all
        for db in self._dbs:
            db.delete_folder_children(directory)

    def list_entries(
        self,
        directory: str,
        start_from: str = "",
        inclusive: bool = False,
        prefix: str = "",
        limit: int = 1024,
    ) -> Iterator[filer_pb2.Entry]:
        return self._db(directory).list_entries(
            directory, start_from=start_from, inclusive=inclusive,
            prefix=prefix, limit=limit)

    # -- kv ----------------------------------------------------------------

    def _kv_db(self, key: bytes) -> LevelDbStore:
        x = hashlib.md5(key).digest()[-1]
        return self._dbs[x % self.db_count]

    def kv_get(self, key: bytes) -> bytes | None:
        return self._kv_db(key).kv_get(key)

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._kv_db(key).kv_put(key, value)

    def close(self) -> None:
        for db in self._dbs:
            db.close()
