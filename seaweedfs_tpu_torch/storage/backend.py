"""Tiered storage backend: the seam between a Volume and its bytes — the
port's copy of seaweedfs_tpu/storage/backend.py.

Reference: weed/storage/backend/backend.go:15-48 — `BackendStorageFile`
(ReadAt/WriteAt/Truncate/Close/Name/Sync) is what a Volume reads and
writes through; `BackendStorage` is a named remote tier (an S3 tier,
backend_s3.py) that can hold a volume's `.dat` while the index stays
local.  A volume moved to a remote tier is read-only: reads go through
ranged requests (with a block cache), writes require `tier.download`
back to disk first.

Backends register under "<type>.<id>" names (backend.go:32-46); until one
registers, `get_backend` answers None and a Volume whose `.vif` places its
`.dat` on that tier fails to load, as SeaweedFS's does for an
unconfigured backend.
"""

from __future__ import annotations

import os
import threading
from abc import ABC, abstractmethod
from collections import OrderedDict


class BackendStorageFile(ABC):
    """Byte-addressed file the Volume reads/writes through."""

    name: str = ""

    @abstractmethod
    def read_at(self, offset: int, size: int) -> bytes: ...

    def pread(self, offset: int, size: int) -> bytes:
        """Positioned read safe for concurrent callers.  The default
        delegates to read_at; DiskFile overrides with a true lock-free
        os.pread so reads on one volume don't serialize."""
        return self.read_at(offset, size)

    @abstractmethod
    def write_at(self, offset: int, data: bytes) -> int: ...

    @abstractmethod
    def file_size(self) -> int: ...

    @abstractmethod
    def truncate(self, size: int) -> None: ...

    def sync(self) -> None:
        pass

    def close(self) -> None:
        pass

    @property
    def is_remote(self) -> bool:
        return False


class DiskFile(BackendStorageFile):
    """Plain local file (backend/disk_file.go)."""

    def __init__(self, path: str):
        self.name = path
        new = not os.path.exists(path)
        self._f = open(path, "w+b" if new else "r+b")
        self._lock = threading.Lock()

    def read_at(self, offset: int, size: int) -> bytes:
        with self._lock:
            self._f.seek(offset)
            return self._f.read(size)

    def pread(self, offset: int, size: int) -> bytes:
        """Lock-free positioned read: os.pread shares no file-position
        state, so concurrent GETs on one volume proceed in parallel.
        Racing handle swaps (vacuum commit, tier moves) surface as
        OSError/ValueError on the closed fd — Volume.read_needle falls back to the locked
        path, where it re-reads the fresh handle."""
        f = self._f
        if f.closed:
            raise ValueError(f"{self.name}: file closed")
        return os.pread(f.fileno(), size, offset)

    def fileno(self) -> int:
        """Raw fd for zero-copy serving (os.sendfile).  Callers that
        outlive the volume lock must os.dup() it so a racing handle swap
        (vacuum commit) can neither close it mid-send nor let the kernel
        recycle the number onto another file."""
        f = self._f
        if f.closed:
            raise ValueError(f"{self.name}: file closed")
        return f.fileno()

    def write_at(self, offset: int, data: bytes) -> int:
        """-> bytes actually written.  The `disk.write` faultpoint family
        fires here (storage/disk_health.py): error/enospc/partial raise a
        classified OSError (enospc/partial after landing a TORN half),
        short silently truncates — so every caller's rollback and the
        load-time torn-tail healer can be exercised without a real dying
        disk."""
        from .disk_health import inject_write_fault

        with self._lock:
            data = inject_write_fault(self.name, self._f, offset, data)
            self._f.seek(offset)
            self._f.write(data)
            self._f.flush()
            return len(data)

    def append(self, data: bytes) -> int:
        """-> offset the data landed at."""
        with self._lock:
            self._f.seek(0, os.SEEK_END)
            offset = self._f.tell()
            self._f.write(data)
            self._f.flush()
            return offset

    def file_size(self) -> int:
        with self._lock:
            self._f.seek(0, os.SEEK_END)
            return self._f.tell()

    def truncate(self, size: int) -> None:
        with self._lock:
            self._f.truncate(size)

    def sync(self) -> None:
        with self._lock:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


class BackendStorage(ABC):
    """A named remote tier (backend.go:48): upload/download/delete whole
    volume files plus ranged reads for serving."""

    def __init__(self, backend_type: str, backend_id: str):
        self.backend_type = backend_type
        self.backend_id = backend_id

    @property
    def name(self) -> str:
        return f"{self.backend_type}.{self.backend_id}"

    @abstractmethod
    def upload_file(self, local_path: str, key: str,
                    progress=None) -> int: ...

    @abstractmethod
    def download_file(self, key: str, local_path: str,
                      progress=None) -> int: ...

    @abstractmethod
    def delete_file(self, key: str) -> None: ...

    @abstractmethod
    def read_range(self, key: str, offset: int, size: int) -> bytes: ...

    def remote_file(self, key: str, size: int) -> "RemoteBackendFile":
        return RemoteBackendFile(self, key, size)


class RemoteBackendFile(BackendStorageFile):
    """Read-only view of a remote-tier object with an LRU block cache so
    needle reads don't pay one ranged request per header+body.  The cache
    is shared by concurrent readers, so every touch of it holds the lock
    (the ranged GET itself runs outside it)."""

    BLOCK = 1 << 20

    def __init__(self, backend: BackendStorage, key: str, size: int,
                 cache_blocks: int = 32):
        self.backend = backend
        self.key = key
        self.name = f"{backend.name}/{key}"
        self._size = size
        self._cache: OrderedDict[int, bytes] = OrderedDict()
        self._cache_blocks = cache_blocks
        self._lock = threading.Lock()

    @property
    def is_remote(self) -> bool:
        return True

    def _block(self, idx: int) -> bytes:
        with self._lock:
            blk = self._cache.get(idx)
            if blk is not None:
                self._cache.move_to_end(idx)
                return blk
        lo = idx * self.BLOCK
        n = min(self.BLOCK, self._size - lo)
        blk = self.backend.read_range(self.key, lo, n)
        with self._lock:
            self._cache[idx] = blk
            while len(self._cache) > self._cache_blocks:
                self._cache.popitem(last=False)
        return blk

    def read_at(self, offset: int, size: int) -> bytes:
        if offset >= self._size:
            return b""
        size = min(size, self._size - offset)
        out = bytearray()
        while size > 0:
            idx, within = divmod(offset, self.BLOCK)
            blk = self._block(idx)
            piece = blk[within:within + size]
            if not piece:
                break
            out += piece
            offset += len(piece)
            size -= len(piece)
        return bytes(out)

    def write_at(self, offset: int, data: bytes) -> int:
        raise PermissionError(f"{self.name}: remote-tier volumes are read-only")

    def file_size(self) -> int:
        return self._size

    def truncate(self, size: int) -> None:
        raise PermissionError(f"{self.name}: remote-tier volumes are read-only")


# -- registry ----------------------------------------------------------------

_BACKENDS: dict[str, BackendStorage] = {}
_REG_LOCK = threading.Lock()


def register_backend(backend: BackendStorage) -> None:
    with _REG_LOCK:
        _BACKENDS[backend.name] = backend


def get_backend(name: str) -> "BackendStorage | None":
    with _REG_LOCK:
        return _BACKENDS.get(name)


def configured_backends() -> list[str]:
    with _REG_LOCK:
        return sorted(_BACKENDS)
