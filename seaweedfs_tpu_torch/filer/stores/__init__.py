"""FilerStore backends; importing registers them — the port's copy of
seaweedfs_tpu/filer/stores for the embedded kinds: in-memory (tests),
sqlite (single-file, transactional, ordered listing; the CLI's default),
leveldb (bitcask-style log+snapshot store covering the reference's
embedded-leveldb default), leveldb2 (the same, md5-partitioned 8 ways;
upstream SeaweedFS's default filer.toml store) and leveldb3 (adaptive
per-bucket partitioning with O(1) bucket drops).

Not ported yet (ROADMAP A-7): the kinds with an external server (redis,
etcd, elastic7, mongodb, cassandra, mysql, postgres), their wire clients
and in-process fakes; `filerstore.make_store` of one raises ValueError
naming A-7.
"""

from . import (  # noqa: F401
    leveldb2_store,
    leveldb3_store,
    leveldb_store,
    memory_store,
    sqlite_store,
)
