"""Upload / download blob content to/from volume servers over HTTP.

Reference: weed/operation/upload_content.go:69-191 — multipart POST with
optional gzip compression, retried; the server answers {name,size,eTag}.

Both directions run under the shared failsafe policy (util/failsafe.py):
uploads retry only idempotency-safe failures (connect errors and 5xx —
the body was provably not acknowledged), downloads retry any transient
failure, and both are breaker-gated per volume server.

The port's copy of seaweedfs_tpu/operation/upload.py.
"""

from __future__ import annotations

import gzip
import json
import urllib.error
import uuid
from dataclasses import dataclass

from ..telemetry import trace
from ..util import connpool, failsafe, faultpoint
from ..util.http_util import netloc as _peer_of
from ..util.http_util import trace_headers

_COMPRESSIBLE_PREFIXES = ("text/", "application/json", "application/xml")

FP_UPLOAD = faultpoint.register("operation.upload")
FP_DOWNLOAD = faultpoint.register("operation.download")


@dataclass
class UploadResult:
    name: str
    size: int
    etag: str
    mime: str = ""
    gzipped: bool = False


class VolumeFullError(RuntimeError):
    """Typed volume-full rejection (HTTP 409 from the volume server's
    disk-fault plane): the target cannot take this write and retrying
    it is pointless — the caller should RE-ASSIGN immediately (the
    master stops handing out the full volume within one heartbeat)."""


def _is_volume_full(exc: BaseException) -> bool:
    seen = 0
    while exc is not None and seen < 8:
        if isinstance(exc, urllib.error.HTTPError) and exc.code == 409:
            return True
        exc = exc.__cause__ or exc.__context__
        seen += 1
    return False


def upload_data(
    url: str,
    data: bytes,
    filename: str = "",
    mime: str = "",
    compress: bool = False,
    jwt: str = "",
    retries: int = 3,
    timeout: float = 30.0,
) -> UploadResult:
    """POST data as multipart/form-data to a volume-server fid url."""
    gzipped = False
    payload = data
    if compress and _is_compressible(mime, filename) and len(data) > 128:
        squeezed = gzip.compress(data, compresslevel=3)
        if len(squeezed) < len(data) * 0.9:
            payload = squeezed
            gzipped = True

    boundary = uuid.uuid4().hex
    head = (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="file"; '
        f'filename="{filename or "file"}"\r\n'
        f"Content-Type: {mime or 'application/octet-stream'}\r\n"
        + ("Content-Encoding: gzip\r\n" if gzipped else "")
        + "\r\n"
    ).encode()
    body = head + payload + f"\r\n--{boundary}--\r\n".encode()
    headers = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
    if jwt:
        headers["Authorization"] = f"BEARER {jwt}"

    def attempt() -> UploadResult:
        faultpoint.inject(FP_UPLOAD, ctx=url)
        with trace.child_span("http.upload", url=url, bytes=len(payload)):
            # traceparent captured inside the span: the volume
            # server's span must parent to http.upload, not above it
            with connpool.request(
                    "POST", url, body=body, headers=trace_headers(headers),
                    timeout=failsafe.attempt_timeout(timeout)) as resp:
                out = json.loads(resp.read() or b"{}")
        return UploadResult(
            name=out.get("name", filename),
            size=out.get("size", len(data)),
            etag=out.get("eTag", ""),
            mime=mime,
            gzipped=gzipped,
        )

    policy = failsafe.RetryPolicy(
        max_attempts=max(1, retries),
        base_delay=failsafe.UPLOAD_POLICY.base_delay,
        max_delay=failsafe.UPLOAD_POLICY.max_delay,
    )
    try:
        return failsafe.call(
            attempt, op="upload", retry_type="operation",
            policy=policy, peer=_peer_of(url), idempotent=False,
        )
    except Exception as e:
        if _is_volume_full(e):
            raise VolumeFullError(
                f"volume full at {url} (re-assign): {e}") from e
        raise RuntimeError(f"upload to {url} failed: {e}") from e


def download(url: str, timeout: float = 30.0,
             range_header: str | None = None, retries: int = 3,
             use_breaker: bool = True) -> bytes:
    """GET a blob; idempotent, so any transient failure retries.

    `use_breaker=False` skips the per-peer breaker gate — for callers
    that already gate the peer themselves (failover loops), where a
    second allow() on the same breaker would starve its own half-open
    probe."""

    def attempt() -> bytes:
        with trace.child_span("http.download", url=url):
            headers = trace_headers(
                {"Range": range_header} if range_header else {})
            with connpool.request(
                    "GET", url, headers=headers,
                    timeout=failsafe.attempt_timeout(timeout)) as resp:
                blob = resp.read()
        return faultpoint.inject(FP_DOWNLOAD, ctx=url, data=blob)

    policy = failsafe.RetryPolicy(
        max_attempts=max(1, retries),
        base_delay=failsafe.DOWNLOAD_POLICY.base_delay,
        max_delay=failsafe.DOWNLOAD_POLICY.max_delay,
    )
    return failsafe.call(
        attempt, op="download", retry_type="operation",
        policy=policy, peer=_peer_of(url) if use_breaker else None,
        idempotent=True,
    )


def _is_compressible(mime: str, filename: str) -> bool:
    if any(mime.startswith(p) for p in _COMPRESSIBLE_PREFIXES):
        return True
    return filename.endswith((".txt", ".csv", ".json", ".log", ".xml", ".html"))
