"""S3 remote tier: BackendStorage over any S3-compatible endpoint — the
port's copy of seaweedfs_tpu/storage/backend_s3.py.

Reference: weed/storage/backend/s3_backend/ (aws-sdk based).  Here the
client is a minimal SigV4-signing HTTP client built on the port's signing
primitives (s3api/auth.py), so the tier can target any S3 service: the
JAX package's gateway in the tests, a local endpoint in chip_smoke.py.
Objects above `part_size` go up as a multipart upload, each part signed
with its own payload hash; a failed part aborts the upload.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import urllib.error
import urllib.parse
import urllib.request

from ..s3api import auth as s3auth
from ..util import glog
from .backend import BackendStorage, register_backend


class S3Backend(BackendStorage):
    def __init__(self, backend_id: str, endpoint: str, bucket: str,
                 access_key: str = "", secret_key: str = "",
                 region: str = "us-east-1"):
        super().__init__("s3", backend_id)
        self.endpoint = endpoint.rstrip("/")  # e.g. http://127.0.0.1:8333
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    # -- signed request plumbing ------------------------------------------

    def _request(self, method: str, key: str, data: "bytes | None" = None,
                 headers: "dict | None" = None, query: str = "",
                 timeout: float = 60.0):
        path = f"/{self.bucket}/{urllib.parse.quote(key)}"
        url = f"{self.endpoint}{path}" + (f"?{query}" if query else "")
        headers = dict(headers or {})
        host = urllib.parse.urlparse(self.endpoint).netloc
        payload_hash = hashlib.sha256(data or b"").hexdigest()
        if self.access_key:
            now = datetime.datetime.now(datetime.timezone.utc)
            amz_date = now.strftime("%Y%m%dT%H%M%SZ")
            date = now.strftime("%Y%m%d")
            headers["x-amz-date"] = amz_date
            headers["x-amz-content-sha256"] = payload_hash
            signed = sorted(
                {"host", "x-amz-date", "x-amz-content-sha256"}
                | {k.lower() for k in headers
                   if k.lower().startswith("x-amz")})
            canon_headers = {k.lower(): v for k, v in headers.items()}
            canon_headers["host"] = host
            canon = s3auth.canonical_request(
                method, path, query, canon_headers, signed, payload_hash)
            sig = s3auth.sign_v4(
                self.secret_key, date, self.region, "s3", amz_date, canon)
            headers["Authorization"] = (
                f"AWS4-HMAC-SHA256 Credential={self.access_key}/{date}/"
                f"{self.region}/s3/aws4_request, "
                f"SignedHeaders={';'.join(signed)}, Signature={sig}")
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        return urllib.request.urlopen(req, timeout=timeout)

    # -- BackendStorage interface -----------------------------------------

    def upload_file(self, local_path: str, key: str, progress=None,
                    part_size: int = 8 << 20) -> int:
        """Whole-object PUT streamed from disk in memory-bounded parts via
        the endpoint's multipart API when the file is large."""
        total = os.path.getsize(local_path)
        with open(local_path, "rb") as f:
            if total <= part_size:
                with self._request("PUT", key, f.read()):
                    pass
                if progress:
                    progress(total)
                return total
            upload_id = self._initiate_multipart(key)
            etags = []
            sent = 0
            part = 1
            try:
                while True:
                    blob = f.read(part_size)
                    if not blob:
                        break
                    with self._request(
                            "PUT", key, blob,
                            query=f"partNumber={part}&uploadId={upload_id}",
                    ) as r:
                        etags.append(r.headers.get("ETag", "").strip('"'))
                    sent += len(blob)
                    part += 1
                    if progress:
                        progress(sent)
                self._complete_multipart(key, upload_id, etags)
            except Exception:
                try:
                    with self._request("DELETE", key,
                                       query=f"uploadId={upload_id}"):
                        pass
                except urllib.error.URLError:
                    glog.warning("s3 tier: abort multipart %s failed", key)
                raise
        return total

    def _initiate_multipart(self, key: str) -> str:
        import xml.etree.ElementTree as ET

        with self._request("POST", key, query="uploads") as r:
            root = ET.fromstring(r.read())
        for el in root.iter():
            if el.tag.endswith("UploadId"):
                return el.text or ""
        raise IOError("no UploadId in InitiateMultipartUpload response")

    def _complete_multipart(self, key: str, upload_id: str,
                            etags: "list[str]") -> None:
        body = "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag></Part>"
            for i, e in enumerate(etags)) + "</CompleteMultipartUpload>"
        with self._request("POST", key, body.encode(),
                           query=f"uploadId={upload_id}"):
            pass

    def download_file(self, key: str, local_path: str, progress=None,
                      chunk: int = 8 << 20) -> int:
        got = 0
        with self._request("GET", key) as r, open(local_path, "wb") as f:
            while True:
                blob = r.read(chunk)
                if not blob:
                    break
                f.write(blob)
                got += len(blob)
                if progress:
                    progress(got)
        return got

    def delete_file(self, key: str) -> None:
        try:
            with self._request("DELETE", key):
                pass
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        with self._request(
                "GET", key,
                headers={"Range": f"bytes={offset}-{offset + size - 1}"},
        ) as r:
            return r.read()


def make_s3_backend(backend_id: str, conf: dict) -> S3Backend:
    """Build + register from a config dict (the [storage.backend.s3.<id>]
    TOML table: endpoint, bucket, access_key, secret_key, region)."""
    b = S3Backend(
        backend_id,
        endpoint=conf.get("endpoint", ""),
        bucket=conf.get("bucket", ""),
        access_key=conf.get("access_key", conf.get("aws_access_key_id", "")),
        secret_key=conf.get("secret_key",
                            conf.get("aws_secret_access_key", "")),
        region=conf.get("region", "us-east-1"),
    )
    register_backend(b)
    return b
