"""S3 request authentication, the signing side: AWS Signature V4 — the
port's copy of the signing primitives of seaweedfs_tpu/s3api/auth.py.

Reference behavior: weed/s3api/auth_signature_v4.go (canonical request,
string-to-sign, signing-key chain).  Implemented from the public AWS SigV4
specification and pinned against the documented AWS example vector in
tests/test_torch_tier.py.  The gateway's side (identities, verification,
presigned URLs, V2, aws-chunked payloads) comes with ROADMAP A-7.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str, service: str) -> bytes:
    """AWS4 signing-key derivation chain (date is YYYYMMDD)."""
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-._~" if encode_slash else "-._~/"
    return urllib.parse.quote(s, safe=safe)


def canonical_query(query: str, drop: "set[str]" = frozenset()) -> str:
    """Sorted, URI-encoded query string (values re-encoded per the spec)."""
    pairs = []
    for part in query.split("&"):
        if not part:
            continue
        k, _, v = part.partition("=")
        k = urllib.parse.unquote_plus(k)
        v = urllib.parse.unquote_plus(v)
        if k in drop:
            continue
        pairs.append((_uri_encode(k), _uri_encode(v)))
    pairs.sort()
    return "&".join(f"{k}={v}" for k, v in pairs)


def canonical_request(method: str, raw_path: str, query: str,
                      headers: "dict[str, str]", signed_headers: "list[str]",
                      payload_hash: str,
                      drop_query: "set[str]" = frozenset()) -> str:
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n" for h in signed_headers)
    # S3 does NOT normalize paths: SDKs sign the raw (still percent-encoded)
    # request path verbatim, so keys containing %2F etc. must reach the
    # canonical request untouched (AWS SigV4 spec, "do not normalize URI
    # paths for Amazon S3").
    return "\n".join([
        method,
        raw_path or "/",
        canonical_query(query, drop_query),
        canon_headers,
        ";".join(signed_headers),
        payload_hash,
    ])


def string_to_sign(amz_date: str, scope: str, canon_req: str) -> str:
    return "\n".join([
        "AWS4-HMAC-SHA256",
        amz_date,
        scope,
        hashlib.sha256(canon_req.encode()).hexdigest(),
    ])


def sign_v4(secret: str, date: str, region: str, service: str,
            amz_date: str, canon_req: str) -> str:
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = string_to_sign(amz_date, scope, canon_req)
    return hmac.new(signing_key(secret, date, region, service), sts.encode(),
                    hashlib.sha256).hexdigest()
