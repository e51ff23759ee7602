"""AES-256-GCM chunk encryption.

The port's copy of seaweedfs_tpu/util/cipher.py.

Reference: weed/util/cipher.go — each chunk gets its own random 32-byte
key stored in the chunk's metadata (FileChunk.cipher_key); the stored
blob is nonce || ciphertext || tag, so possession of the volume files
alone reveals nothing.  Wire layout matches the reference (gcm.Seal with
the nonce prepended), standard 12-byte GCM nonce and 16-byte tag.
"""

from __future__ import annotations

import os

try:  # gated: hosts without the cryptography wheel can still run the
    # plaintext path (maybe_seal(enabled=False)); only actually sealing
    # or opening a sealed chunk requires the dependency
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # pragma: no cover - environment-dependent
    AESGCM = None

KEY_SIZE = 32
NONCE_SIZE = 12


def _require_aesgcm():
    if AESGCM is None:
        raise RuntimeError(
            "chunk encryption requires the 'cryptography' package, "
            "which is not installed on this host")
    return AESGCM


def gen_cipher_key() -> bytes:
    return os.urandom(KEY_SIZE)


def encrypt(plaintext: bytes, key: bytes) -> bytes:
    nonce = os.urandom(NONCE_SIZE)
    return nonce + _require_aesgcm()(key).encrypt(nonce, plaintext, None)


def decrypt(blob: bytes, key: bytes) -> bytes:
    if len(blob) < NONCE_SIZE:
        raise ValueError("ciphertext too short")
    return _require_aesgcm()(key).decrypt(
        blob[:NONCE_SIZE], blob[NONCE_SIZE:], None)


def maybe_seal(data: bytes, enabled: bool) -> tuple[bytes, bytes]:
    """-> (stored_bytes, cipher_key): seal with a fresh per-chunk key
    when enabled, pass through otherwise.  Shared by every chunk writer
    (filer autochunk, FUSE mount) so the sealing format cannot drift."""
    if not enabled:
        return data, b""
    key = gen_cipher_key()
    return encrypt(data, key), key
