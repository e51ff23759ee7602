"""In-memory FilerStore (tests, ephemeral filers).

The port's copy of seaweedfs_tpu/filer/stores/memory_store.py.
"""

from __future__ import annotations

import bisect
import threading
from typing import Iterator

from ...pb import filer_pb2
from ..filerstore import FilerStore, register_store


@register_store("memory")
class MemoryStore(FilerStore):
    name = "memory"

    def __init__(self, **_):
        self._dirs: dict[str, dict[str, bytes]] = {}
        self._names: dict[str, list[str]] = {}  # sorted name lists
        self._kv: dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    def insert_entry(self, directory: str, entry: filer_pb2.Entry) -> None:
        with self._lock:
            d = self._dirs.setdefault(directory, {})
            names = self._names.setdefault(directory, [])
            if entry.name not in d:
                bisect.insort(names, entry.name)
            d[entry.name] = entry.SerializeToString()

    update_entry = insert_entry

    def find_entry(self, directory: str, name: str) -> filer_pb2.Entry | None:
        with self._lock:
            raw = self._dirs.get(directory, {}).get(name)
        if raw is None:
            return None
        return filer_pb2.Entry.FromString(raw)

    def delete_entry(self, directory: str, name: str) -> None:
        with self._lock:
            d = self._dirs.get(directory)
            if d and name in d:
                del d[name]
                names = self._names[directory]
                i = bisect.bisect_left(names, name)
                if i < len(names) and names[i] == name:
                    names.pop(i)

    def count_entries(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._dirs.values())

    def delete_folder_children(self, directory: str) -> None:
        with self._lock:
            prefix = directory.rstrip("/") + "/"
            for d in [directory] + [
                k for k in self._dirs if k.startswith(prefix)
            ]:
                self._dirs.pop(d, None)
                self._names.pop(d, None)

    def list_entries(
        self,
        directory: str,
        start_from: str = "",
        inclusive: bool = False,
        prefix: str = "",
        limit: int = 1024,
    ) -> Iterator[filer_pb2.Entry]:
        with self._lock:
            names = list(self._names.get(directory, ()))
            d = dict(self._dirs.get(directory, {}))
        i = bisect.bisect_left(names, start_from) if start_from else 0
        if start_from and not inclusive:
            while i < len(names) and names[i] == start_from:
                i += 1
        count = 0
        for name in names[i:]:
            if count >= limit:
                return
            if prefix and not name.startswith(prefix):
                continue
            yield filer_pb2.Entry.FromString(d[name])
            count += 1

    def kv_get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._kv.get(key)

    def kv_put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            if value:
                self._kv[key] = value
            else:
                self._kv.pop(key, None)
