"""Embedded persistent FilerStore — the reference's default-store slot.

The port's copy of seaweedfs_tpu/filer/stores/leveldb_store.py.

Reference parity target: weed/filer/leveldb — the zero-dependency
embedded store a filer gets when nothing else is configured.  The design
here is NOT an LSM port: it is a bitcask-style log+snapshot store chosen
for Python's strengths —

  * all writes append to a WAL (`wal.log`), fsync'd in batches;
  * the in-RAM index maps (directory, name) -> (file, offset, length);
    entry VALUES stay on disk, so resident memory is bounded by key
    count, not metadata volume (the low-memory property the reference
    gets from leveldb);
  * when the WAL outgrows `compact_bytes`, live records are streamed
    into `snapshot.dat.tmp`, atomically renamed, and the WAL truncated
    (same shadow-file + rename discipline as volume vacuum).

Record framing (little-endian u32 lengths):
  [op u8][dlen u32][dir][nlen u32][name][vlen u32][value]
op: 1=put entry, 2=delete entry, 3=kv put (dir="", name=key), 4=delete
folder children (value empty).
"""

from __future__ import annotations

import bisect
import os
import struct
import threading
from typing import Iterator

from ...pb import filer_pb2
from ..filerstore import FilerStore, register_store

OP_PUT = 1
OP_DELETE = 2
OP_KV = 3
OP_DELETE_CHILDREN = 4

_SNAPSHOT = "snapshot.dat"
_WAL = "wal.log"


def _pack(op: int, directory: bytes, name: bytes, value: bytes) -> bytes:
    return b"".join((
        struct.pack("<BI", op, len(directory)), directory,
        struct.pack("<I", len(name)), name,
        struct.pack("<I", len(value)), value,
    ))


@register_store("leveldb")
class LevelDbStore(FilerStore):
    name = "leveldb"

    def __init__(self, path: str = "./filerldb",
                 compact_bytes: int = 64 << 20, **_):
        self.dir = path
        self.compact_bytes = compact_bytes
        os.makedirs(path, exist_ok=True)
        self._lock = threading.RLock()
        # (dir -> name -> (file_no, offset, length)) ; file 0 = snapshot,
        # 1 = wal.  offsets point at the VALUE bytes, not the record head.
        self._index: dict[str, dict[str, tuple[int, int, int]]] = {}
        self._names: dict[str, list[str]] = {}
        self._kv: dict[bytes, tuple[int, int, int]] = {}
        self._files = [None, None]  # read handles
        self._load()

    # -- loading / replay ---------------------------------------------------

    def _path(self, file_no: int) -> str:
        return os.path.join(self.dir, _SNAPSHOT if file_no == 0 else _WAL)

    def _load(self) -> None:
        for file_no in (0, 1):
            p = self._path(file_no)
            if not os.path.exists(p):
                open(p, "ab").close()
            self._replay(file_no)
            self._files[file_no] = open(p, "rb")
        self._wal = open(self._path(1), "ab")

    def _replay(self, file_no: int) -> None:
        """Replay records; a torn tail (crash mid-append) truncates the
        file at the last complete record instead of refusing to start —
        the same load-time healing discipline as volume torn-tail fix."""
        path = self._path(file_no)
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            record_start = 0
            while True:
                head = f.read(5)
                if len(head) < 5:
                    break
                op, dlen = struct.unpack("<BI", head)
                directory_b = f.read(dlen)
                nlen_b = f.read(4)
                if len(directory_b) < dlen or len(nlen_b) < 4:
                    break
                (nlen,) = struct.unpack("<I", nlen_b)
                name_b = f.read(nlen)
                vlen_b = f.read(4)
                if len(name_b) < nlen or len(vlen_b) < 4:
                    break
                (vlen,) = struct.unpack("<I", vlen_b)
                off = f.tell()
                if off + vlen > size:
                    break
                f.seek(vlen, os.SEEK_CUR)
                self._apply(op, directory_b.decode(), name_b,
                            (file_no, off, vlen))
                record_start = f.tell()
        if record_start < size:
            os.truncate(path, record_start)

    def _apply(self, op: int, directory: str, name_b: bytes, loc) -> None:
        name = name_b.decode()
        if op == OP_PUT:
            d = self._index.setdefault(directory, {})
            if name not in d:
                bisect.insort(self._names.setdefault(directory, []), name)
            d[name] = loc
        elif op == OP_DELETE:
            d = self._index.get(directory)
            if d and name in d:
                del d[name]
                names = self._names[directory]
                i = bisect.bisect_left(names, name)
                if i < len(names) and names[i] == name:
                    names.pop(i)
        elif op == OP_KV:
            if loc[2] == 0:
                self._kv.pop(name_b, None)
            else:
                self._kv[name_b] = loc
        elif op == OP_DELETE_CHILDREN:
            # the whole subtree: the directory itself plus descendants
            # (same contract as the sqlite store's prefix delete)
            child_prefix = directory.rstrip("/") + "/"
            for d in [k for k in self._index
                      if k == directory or k.startswith(child_prefix)]:
                self._index.pop(d, None)
                self._names.pop(d, None)

    # -- write path ---------------------------------------------------------

    def _append(self, op: int, directory: str, name_b: bytes,
                value: bytes) -> tuple[int, int, int]:
        rec = _pack(op, directory.encode(), name_b, value)
        off = self._wal.tell() + len(rec) - len(value)
        self._wal.write(rec)
        self._wal.flush()
        return (1, off, len(value))

    def _maybe_compact(self) -> None:
        # called AFTER the record is applied to the index: compaction
        # streams the index, so an unapplied record would be lost when
        # the WAL truncates
        if self._wal.tell() > self.compact_bytes:
            self._compact()

    def _read_value(self, loc: tuple[int, int, int]) -> bytes:
        file_no, off, length = loc
        f = self._files[file_no]
        f.seek(off)
        return f.read(length)

    def _compact(self) -> None:
        """Stream live records into a fresh snapshot; truncate the WAL."""
        tmp = self._path(0) + ".tmp"
        new_index: dict[str, dict[str, tuple[int, int, int]]] = {}
        new_kv: dict[bytes, tuple[int, int, int]] = {}
        with open(tmp, "wb") as out:
            for directory, names in self._index.items():
                nd = new_index.setdefault(directory, {})
                for name, loc in names.items():
                    value = self._read_value(loc)
                    rec = _pack(OP_PUT, directory.encode(), name.encode(),
                                value)
                    off = out.tell() + len(rec) - len(value)
                    out.write(rec)
                    nd[name] = (0, off, len(value))
            for key, loc in self._kv.items():
                value = self._read_value(loc)
                rec = _pack(OP_KV, b"", key, value)
                off = out.tell() + len(rec) - len(value)
                out.write(rec)
                new_kv[key] = (0, off, len(value))
            out.flush()
            os.fsync(out.fileno())
        for f in self._files:
            if f:
                f.close()
        self._wal.close()
        os.replace(tmp, self._path(0))
        os.truncate(self._path(1), 0)
        self._index = new_index
        self._kv = new_kv
        self._files = [open(self._path(0), "rb"), open(self._path(1), "rb")]
        self._wal = open(self._path(1), "ab")

    # -- FilerStore interface ----------------------------------------------

    def insert_entry(self, directory: str, entry: filer_pb2.Entry) -> None:
        with self._lock:
            name_b = entry.name.encode()
            loc = self._append(OP_PUT, directory, name_b,
                               entry.SerializeToString())
            self._apply(OP_PUT, directory, name_b, loc)
            self._maybe_compact()

    update_entry = insert_entry

    def find_entry(self, directory: str, name: str) -> filer_pb2.Entry | None:
        with self._lock:
            loc = self._index.get(directory, {}).get(name)
            if loc is None:
                return None
            return filer_pb2.Entry.FromString(self._read_value(loc))

    def delete_entry(self, directory: str, name: str) -> None:
        with self._lock:
            name_b = name.encode()
            self._append(OP_DELETE, directory, name_b, b"")
            self._apply(OP_DELETE, directory, name_b, (1, 0, 0))
            self._maybe_compact()

    def delete_folder_children(self, directory: str) -> None:
        with self._lock:
            self._append(OP_DELETE_CHILDREN, directory, b"", b"")
            self._apply(OP_DELETE_CHILDREN, directory, b"", (1, 0, 0))
            self._maybe_compact()

    def list_entries(
        self,
        directory: str,
        start_from: str = "",
        inclusive: bool = False,
        prefix: str = "",
        limit: int = 1024,
    ) -> Iterator[filer_pb2.Entry]:
        with self._lock:
            names = self._names.get(directory, [])
            i = bisect.bisect_left(names, start_from) if start_from else 0
            if start_from and not inclusive:
                if i < len(names) and names[i] == start_from:
                    i += 1
            picked = []
            while i < len(names) and len(picked) < limit:
                n = names[i]
                if not prefix or n.startswith(prefix):
                    picked.append(self._index[directory][n])
                elif prefix and n > prefix and not n.startswith(prefix):
                    break
                i += 1
            values = [self._read_value(loc) for loc in picked]
        for raw in values:
            yield filer_pb2.Entry.FromString(raw)

    # -- KV -----------------------------------------------------------------

    def kv_get(self, key: bytes) -> bytes | None:
        with self._lock:
            loc = self._kv.get(key)
            if loc is None:
                return None
            return self._read_value(loc)

    def kv_put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            loc = self._append(OP_KV, "", key, value)
            if not value:
                self._kv.pop(key, None)
            else:
                self._kv[key] = loc
            self._maybe_compact()

    def close(self) -> None:
        with self._lock:
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._wal.close()
            for f in self._files:
                if f:
                    f.close()
