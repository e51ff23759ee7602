"""Storage backend: the seam between a Volume and its bytes — the port's
copy of the local-disk part of seaweedfs_tpu/storage/backend.py.

Reference: weed/storage/backend/backend.go:15-48 — `BackendStorageFile`
(ReadAt/WriteAt/Truncate/Close/Name/Sync) is what a Volume reads and
writes through.  Remote tiers register under "<type>.<id>" names
(backend.go:32-46); the reference's `BackendStorage`, `RemoteBackendFile`
and backend_s3.py are not ported yet, so until one registers `get_backend`
answers None and a Volume whose `.vif` places its `.dat` on a tier fails
to load, as the reference's does for an unconfigured backend.
"""

from __future__ import annotations

import os
import threading
from abc import ABC, abstractmethod


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
        Racing handle swaps (vacuum commit) surface as OSError/ValueError
        on the closed fd — Volume.read_needle falls back to the locked
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


# -- registry ----------------------------------------------------------------

_BACKENDS: dict[str, object] = {}
_REG_LOCK = threading.Lock()


def register_backend(backend) -> None:
    """Register a remote tier under its "<type>.<id>" name (`.name`); its
    `remote_file(key, size)` opens a volume's `.dat` there."""
    with _REG_LOCK:
        _BACKENDS[backend.name] = backend


def get_backend(name: str):
    with _REG_LOCK:
        return _BACKENDS.get(name)
