"""JWT write tokens: HS256, claim-bound to a file id.

The port's copy of seaweedfs_tpu/security/jwt.py.

Reference: weed/security/jwt.go:21-58 — the master signs a short-lived
token on Assign carrying the fid; the volume server verifies it on
POST/DELETE when a signing key is configured.  Unsigned clusters skip both
sides (the default).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time

DEFAULT_EXPIRES_SECONDS = 10


def _b64(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _unb64(data: bytes) -> bytes:
    return base64.urlsafe_b64decode(data + b"=" * (-len(data) % 4))


def encode_jwt(key: bytes, claims: dict) -> str:
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = header + b"." + payload
    sig = _b64(hmac.new(key, signing_input, hashlib.sha256).digest())
    return (signing_input + b"." + sig).decode()


def decode_jwt(key: bytes, token: str) -> dict | None:
    """-> claims, or None when the signature/structure/expiry is invalid."""
    try:
        header, payload, sig = token.encode().split(b".")
    except ValueError:
        return None
    want = _b64(hmac.new(key, header + b"." + payload, hashlib.sha256).digest())
    if not hmac.compare_digest(want, sig):
        return None
    try:
        claims = json.loads(_unb64(payload))
    except (ValueError, UnicodeDecodeError):
        return None
    exp = claims.get("exp")
    if exp is not None and time.time() > exp:
        return None
    return claims


def gen_write_jwt(key: bytes, fid: str,
                  expires_seconds: int = DEFAULT_EXPIRES_SECONDS) -> str:
    """Signed token authorizing one write/delete of `fid` (jwt.go GenJwt)."""
    if not key:
        return ""
    return encode_jwt(key, {"exp": int(time.time()) + expires_seconds,
                            "sub": fid})


def verify_write_jwt(key: bytes, token: str, fid: str) -> bool:
    """Volume-server side check (jwt.go ValidateJwt + fid claim match)."""
    claims = decode_jwt(key, token)
    if claims is None:
        return False
    # tokens bound to a fid authorize exactly that fid; an empty sub is a
    # master-issued wildcard (reference allows unbound tokens)
    sub = claims.get("sub", "")
    return sub == "" or sub == fid


def token_from_header(auth_header: str | None) -> str:
    """Extract the bearer token from an Authorization header."""
    if not auth_header:
        return ""
    parts = auth_header.split()
    if len(parts) == 2 and parts[0].upper() == "BEARER":
        return parts[1]
    return ""
