"""FilerStore: the pluggable metadata backend interface — the port's copy
of seaweedfs_tpu/filer/filerstore.py.

Reference: weed/filer/filerstore.go:18-41 — InsertEntry/UpdateEntry/
FindEntry/DeleteEntry/DeleteFolderChildren/ListDirectoryEntries + KV +
transactions.  Stores persist pb-serialized Entry bytes keyed by
(directory, name); backends register by name like the reference's
blank-import init() plugin pattern (weed/server/filer_server.go:23-36).
The port registers the embedded kinds; a kind with an external server is
refused, naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Iterator

from ..pb import filer_pb2

_REGISTRY: dict[str, Callable[..., "FilerStore"]] = {}

# the reference's store kinds with an external server (and its client and
# in-process fake), not ported yet
NOT_PORTED_KINDS = ("redis", "etcd", "elastic7", "mongodb", "cassandra",
                    "mysql", "postgres")


def register_store(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def make_store(name: str, **kwargs) -> "FilerStore":
    # import for registration side effects
    from . import stores  # noqa: F401

    if name in NOT_PORTED_KINDS:
        raise ValueError(
            f"filer store {name!r} is not ported yet (ROADMAP A-7a: the "
            f"external store kinds); have {sorted(_REGISTRY)}")
    try:
        return _REGISTRY[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown filer store {name!r}; have {sorted(_REGISTRY)}"
        ) from None


class FilerStore(ABC):
    name = "abstract"

    @abstractmethod
    def insert_entry(self, directory: str, entry: filer_pb2.Entry) -> None: ...

    @abstractmethod
    def update_entry(self, directory: str, entry: filer_pb2.Entry) -> None: ...

    @abstractmethod
    def find_entry(self, directory: str, name: str) -> filer_pb2.Entry | None: ...

    @abstractmethod
    def delete_entry(self, directory: str, name: str) -> None: ...

    @abstractmethod
    def delete_folder_children(self, directory: str) -> None: ...

    @abstractmethod
    def list_entries(
        self,
        directory: str,
        start_from: str = "",
        inclusive: bool = False,
        prefix: str = "",
        limit: int = 1024,
    ) -> Iterator[filer_pb2.Entry]: ...

    def count_entries(self) -> int | None:
        """Total entries in this store, or None when the backend cannot
        answer cheaply (fleet shard-size accounting is best-effort)."""
        return None

    # -- KV ----------------------------------------------------------------

    @abstractmethod
    def kv_get(self, key: bytes) -> bytes | None: ...

    @abstractmethod
    def kv_put(self, key: bytes, value: bytes) -> None: ...

    def kv_delete(self, key: bytes) -> None:
        self.kv_put(key, b"")

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        pass

    # transactions are no-ops for embedded stores
    def begin(self) -> None:
        pass

    def commit(self) -> None:
        pass

    def rollback(self) -> None:
        pass
