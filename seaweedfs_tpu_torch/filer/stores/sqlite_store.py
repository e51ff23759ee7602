"""SQLite FilerStore: the embedded default.

The port's copy of seaweedfs_tpu/filer/stores/sqlite_store.py.

Reference analogue: the abstract_sql family (weed/filer/abstract_sql/,
mysql/, postgres/) — one `filemeta(dirhash, name, directory, meta)` table —
fused with leveldb's role as the zero-dependency default store
(weed/filer/leveldb/).  SQLite gives ordered listing, transactions, and a
single-file footprint from the stdlib.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Iterator

from ...pb import filer_pb2
from ..filerstore import FilerStore, register_store

def _glob_escape(s: str) -> str:
    """Escape GLOB metacharacters so path text matches literally."""
    return s.replace("[", "[[]").replace("*", "[*]").replace("?", "[?]")


_SCHEMA = """
CREATE TABLE IF NOT EXISTS filemeta (
    directory TEXT NOT NULL,
    name      TEXT NOT NULL,
    meta      BLOB NOT NULL,
    PRIMARY KEY (directory, name)
);
CREATE TABLE IF NOT EXISTS filer_kv (
    k BLOB PRIMARY KEY,
    v BLOB NOT NULL
);
"""


@register_store("sqlite")
class SqliteStore(FilerStore):
    name = "sqlite"

    def __init__(self, path: str = "filer.db", **_):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.executescript(_SCHEMA)
        self._lock = threading.RLock()
        # reads run on their OWN connection + lock: WAL already lets a
        # reader see the last committed snapshot while a writer commits,
        # but one shared connection serialized listings behind insert
        # fsyncs — the exact stall the sharded metadata plane exists to
        # remove.  :memory: has no WAL file to share, so it keeps the
        # single-connection behavior.
        if path == ":memory:":
            self._rconn = self._conn
            self._rlock = self._lock
        else:
            self._rconn = sqlite3.connect(path, check_same_thread=False)
            self._rconn.execute("PRAGMA query_only=ON")
            self._rlock = threading.RLock()

    def insert_entry(self, directory: str, entry: filer_pb2.Entry) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO filemeta (directory, name, meta) "
                "VALUES (?, ?, ?)",
                (directory, entry.name, entry.SerializeToString()),
            )
            self._conn.commit()

    update_entry = insert_entry

    def find_entry(self, directory: str, name: str) -> filer_pb2.Entry | None:
        with self._rlock:
            row = self._rconn.execute(
                "SELECT meta FROM filemeta WHERE directory=? AND name=?",
                (directory, name),
            ).fetchone()
        if row is None:
            return None
        return filer_pb2.Entry.FromString(row[0])

    def delete_entry(self, directory: str, name: str) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM filemeta WHERE directory=? AND name=?",
                (directory, name),
            )
            self._conn.commit()

    def delete_folder_children(self, directory: str) -> None:
        prefix = directory.rstrip("/") + "/"
        with self._lock:
            self._conn.execute(
                "DELETE FROM filemeta WHERE directory=? OR directory GLOB ?",
                (directory, _glob_escape(prefix) + "*"),
            )
            self._conn.commit()

    def list_entries(
        self,
        directory: str,
        start_from: str = "",
        inclusive: bool = False,
        prefix: str = "",
        limit: int = 1024,
    ) -> Iterator[filer_pb2.Entry]:
        op = ">=" if inclusive else ">"
        sql = (
            "SELECT meta FROM filemeta WHERE directory=? AND name "
            + op
            + " ? "
        )
        params: list = [directory, start_from]
        if prefix:
            sql += "AND name GLOB ? "
            params.append(_glob_escape(prefix) + "*")
        sql += "ORDER BY name LIMIT ?"
        params.append(limit)
        with self._rlock:
            rows = self._rconn.execute(sql, params).fetchall()
        for (meta,) in rows:
            yield filer_pb2.Entry.FromString(meta)

    def count_entries(self) -> int:
        """Shard size for the fleet's per-shard accounting surface."""
        with self._rlock:
            return self._rconn.execute(
                "SELECT COUNT(*) FROM filemeta").fetchone()[0]

    def kv_get(self, key: bytes) -> bytes | None:
        with self._rlock:
            row = self._rconn.execute(
                "SELECT v FROM filer_kv WHERE k=?", (key,)
            ).fetchone()
        return row[0] if row else None

    def kv_put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            if value:
                self._conn.execute(
                    "INSERT OR REPLACE INTO filer_kv (k, v) VALUES (?, ?)",
                    (key, value),
                )
            else:
                self._conn.execute("DELETE FROM filer_kv WHERE k=?", (key,))
            self._conn.commit()

    def close(self) -> None:
        if self._rconn is not self._conn:
            with self._rlock:
                self._rconn.close()
        with self._lock:
            self._conn.close()
