"""Gateway-side filer access: gRPC for metadata, filer HTTP for bytes.

The port's copy of seaweedfs_tpu/s3api/filer_client.py.

Reference shape: weed/s3api/s3api_handlers.go (WithFilerClient) +
s3api_object_handlers.go putToFiler/proxy-to-filer — the s3 process keeps
no object state of its own; everything lives in the filer.
"""

from __future__ import annotations

import time
import urllib.error
import urllib.parse

import grpc

from ..filer.fleet.tenant import QuotaExceededError, SlowDownError
from ..pb import filer_pb2
from ..pb import rpc as rpclib
from ..util import connpool, failsafe
from ..util.http_util import trace_headers

GRPC_PORT_OFFSET = 10000


def _raise_if_rejected(e: urllib.error.HTTPError) -> None:
    """Translate a filer-side admission/quota rejection (marked with the
    X-Seaweed-Reject header) into its typed exception — BEFORE the retry
    machinery sees the 503, so a SlowDown is surfaced to the client
    instead of hammered three more times."""
    kind = (e.headers.get("X-Seaweed-Reject", "") if e.headers else "")
    if not kind:
        return
    e.read()
    if kind == "slowdown":
        try:
            retry_after = int(e.headers.get("Retry-After", "1") or 1)
        except ValueError:
            retry_after = 1
        raise SlowDownError("", retry_after=retry_after)
    if kind == "quota":
        raise QuotaExceededError("", "filer shard rejected the write")

# the gateway's edge to the filer: bounded retries, no breaker bypass —
# the filer is the gateway's only backend, so we keep probing it
_S3_POLICY = failsafe.RetryPolicy(max_attempts=3, base_delay=0.05,
                                  max_delay=1.0)


class FilerUnavailable(IOError):
    """The filer could not be reached / errored — NOT a missing entry.

    Callers must surface this as a 5xx, never as NoSuchKey: a sync client
    that sees 404 for an outage will happily delete its local copies."""


class FilerClient:
    def __init__(self, filer_http_address: str):
        self.http_address = filer_http_address
        host, _, port = filer_http_address.partition(":")
        self.grpc_address = f"{host}:{int(port) + GRPC_PORT_OFFSET}"

    def stub(self, timeout: float = 30.0) -> rpclib.Stub:
        return rpclib.filer_stub(self.grpc_address, timeout=timeout)

    # -- metadata ------------------------------------------------------------

    def find_entry(self, directory: str, name: str) -> filer_pb2.Entry | None:
        try:
            resp = failsafe.call(
                lambda: self.stub().LookupDirectoryEntry(
                    filer_pb2.LookupDirectoryEntryRequest(
                        directory=directory, name=name
                    )
                ),
                op="lookup_entry", retry_type="s3", policy=_S3_POLICY,
                idempotent=True,
            )
            return resp.entry
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.NOT_FOUND:
                return None
            raise FilerUnavailable(f"filer lookup failed: {e.code()}")

    def list_entries(
        self,
        directory: str,
        prefix: str = "",
        start_from: str = "",
        inclusive: bool = False,
        limit: int = 1024,
    ) -> list[filer_pb2.Entry]:
        try:
            return failsafe.call(
                lambda: [
                    r.entry
                    for r in self.stub(timeout=60).ListEntries(
                        filer_pb2.ListEntriesRequest(
                            directory=directory,
                            prefix=prefix,
                            start_from_file_name=start_from,
                            inclusive_start_from=inclusive,
                            limit=limit,
                        )
                    )
                ],
                op="list_entries", retry_type="s3", policy=_S3_POLICY,
                idempotent=True,
            )
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.NOT_FOUND:
                return []
            raise FilerUnavailable(f"filer list failed: {e.code()}")

    def iter_entries(self, directory: str, prefix: str = "",
                     page: int = 1024):
        """Yield every entry of one directory, paging through ListEntries."""
        start, inclusive = "", False
        while True:
            batch = self.list_entries(directory, prefix=prefix,
                                      start_from=start, inclusive=inclusive,
                                      limit=page)
            yield from batch
            if len(batch) < page:
                return
            start, inclusive = batch[-1].name, False

    def walk(self, directory: str):
        """Yield (directory, entry) for the whole subtree, breadth-first."""
        from collections import deque

        queue = deque([directory.rstrip("/") or "/"])
        while queue:
            d = queue.popleft()
            for entry in self.iter_entries(d):
                yield d, entry
                if entry.is_directory:
                    queue.append((d.rstrip("/") or "") + "/" + entry.name)

    def create_entry(self, directory: str, entry: filer_pb2.Entry) -> None:
        resp = self.stub().CreateEntry(
            filer_pb2.CreateEntryRequest(directory=directory, entry=entry)
        )
        if resp.error:
            raise IOError(resp.error)

    def update_entry(self, directory: str, entry: filer_pb2.Entry) -> None:
        self.stub().UpdateEntry(
            filer_pb2.UpdateEntryRequest(directory=directory, entry=entry)
        )

    def mkdir(self, directory: str, name: str, mode: int = 0o777) -> None:
        entry = filer_pb2.Entry(name=name, is_directory=True)
        entry.attributes.file_mode = mode | 0o40000
        entry.attributes.mtime = int(time.time())
        entry.attributes.crtime = int(time.time())
        self.create_entry(directory, entry)

    def delete_entry(
        self,
        directory: str,
        name: str,
        is_delete_data: bool = True,
        is_recursive: bool = False,
    ) -> str:
        try:
            resp = self.stub(timeout=60).DeleteEntry(
                filer_pb2.DeleteEntryRequest(
                    directory=directory,
                    name=name,
                    is_delete_data=is_delete_data,
                    is_recursive=is_recursive,
                    ignore_recursive_error=True,
                )
            )
            return resp.error
        except Exception as e:
            return str(e)

    # -- bytes ---------------------------------------------------------------

    def put_object(self, path: str, data: bytes, mime: str = "") -> None:
        # a filer PUT replaces the whole entry, so re-sending after an
        # ambiguous failure converges on the same result: idempotent
        def attempt() -> None:
            try:
                with connpool.request(
                        "PUT",
                        f"http://{self.http_address}"
                        f"{urllib.parse.quote(path)}",
                        body=data,
                        headers=trace_headers(
                            {"Content-Type":
                             mime or "application/octet-stream"}),
                        timeout=failsafe.attempt_timeout(120)) as r:
                    r.read()
            except urllib.error.HTTPError as e:
                _raise_if_rejected(e)
                raise

        failsafe.call(attempt, op="put_object", retry_type="s3",
                      policy=_S3_POLICY, idempotent=True)

    def put_object_stream(self, path: str, reader, length: int,
                          mime: str = "") -> None:
        """PUT from a file-like reader without buffering the whole body
        (http.client streams objects that expose .read).  The pool sends
        a non-seekable stream on a fresh dial — a half-consumed reader
        can't be replayed onto a stale keep-alive socket."""
        try:
            with connpool.request(
                    "PUT",
                    f"http://{self.http_address}{urllib.parse.quote(path)}",
                    body=reader,
                    headers=trace_headers({
                        "Content-Type": mime or "application/octet-stream",
                        "Content-Length": str(length),
                    }),
                    timeout=600) as r:
                r.read()
        except urllib.error.HTTPError as e:
            _raise_if_rejected(e)
            raise

    def open_object(self, path: str, range_header: str = ""):
        """Streaming GET: returns the live HTTP response (file-like with
        .status/.headers) — caller must close it.  Raises HTTPError on
        non-2xx so callers branch on .code."""
        headers = trace_headers()
        if range_header:
            headers["Range"] = range_header
        try:
            return connpool.request(
                "GET",
                f"http://{self.http_address}{urllib.parse.quote(path)}",
                headers=headers, timeout=600)
        except urllib.error.HTTPError as e:
            _raise_if_rejected(e)
            raise

    def get_object(self, path: str, range_header: str = "") -> tuple[int, dict, bytes]:
        """-> (status, headers, body); raises on network failure only."""
        headers = trace_headers()
        if range_header:
            headers["Range"] = range_header
        def attempt() -> tuple[int, dict, bytes]:
            try:
                with connpool.request(
                        "GET",
                        f"http://{self.http_address}"
                        f"{urllib.parse.quote(path)}",
                        headers=headers,
                        timeout=failsafe.attempt_timeout(120)) as r:
                    return r.status, dict(r.headers), r.read()
            except urllib.error.HTTPError as e:
                _raise_if_rejected(e)
                raise

        try:
            return failsafe.call(attempt, op="get_object", retry_type="s3",
                                 policy=_S3_POLICY, idempotent=True)
        except urllib.error.HTTPError as e:
            # non-2xx (after any 5xx retries): surface to the S3 layer
            return e.code, dict(e.headers), e.read()
