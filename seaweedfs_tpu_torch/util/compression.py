"""Chunk compression: gzip + zstd with content-aware gating.

The port's copy of seaweedfs_tpu/util/compression.py.

Reference: weed/util/compression.go — IsGzippable decides by mime/ext,
compression happens per uploaded chunk and is recorded so reads can
transparently decompress.
"""

from __future__ import annotations

import gzip

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - zstd ships in this image
    _zstd = None

_COMPRESSIBLE_MIME_PREFIXES = ("text/",)
_COMPRESSIBLE_MIMES = {
    "application/json", "application/javascript", "application/xml",
    "application/xhtml+xml", "application/x-javascript",
}
_COMPRESSIBLE_EXTS = {
    ".txt", ".log", ".csv", ".json", ".js", ".css", ".html", ".htm",
    ".xml", ".md", ".py", ".go", ".java", ".c", ".cc", ".h", ".sql",
}
_INCOMPRESSIBLE_EXTS = {
    ".gz", ".zst", ".zip", ".bz2", ".xz", ".7z", ".png", ".jpg",
    ".jpeg", ".gif", ".webp", ".mp3", ".mp4", ".mov", ".avi",
}


def is_compressible(filename: str = "", mime: str = "") -> bool:
    """util/compression.go IsGzippableFileType."""
    ext = ""
    if "." in filename:
        ext = filename[filename.rfind("."):].lower()
    if ext in _INCOMPRESSIBLE_EXTS:
        return False
    if ext in _COMPRESSIBLE_EXTS:
        return True
    if mime:
        if any(mime.startswith(p) for p in _COMPRESSIBLE_MIME_PREFIXES):
            return True
        if mime.split(";")[0].strip() in _COMPRESSIBLE_MIMES:
            return True
    return False


def gzip_data(data: bytes) -> bytes:
    return gzip.compress(data, compresslevel=3)


def gunzip_data(data: bytes) -> bytes:
    return gzip.decompress(data)


def zstd_available() -> bool:
    return _zstd is not None


def zstd_data(data: bytes) -> bytes:
    if _zstd is None:
        raise RuntimeError("zstandard not available")
    return _zstd.ZstdCompressor(level=3).compress(data)


def unzstd_data(data: bytes) -> bytes:
    if _zstd is None:
        raise RuntimeError("zstandard not available")
    return _zstd.ZstdDecompressor().decompress(data)


def compress_if_worthwhile(data: bytes, filename: str = "",
                           mime: str = "") -> tuple[bytes, bool]:
    """-> (maybe_compressed, was_compressed); keeps the original unless
    gzip actually shrinks it (compression.go MaybeGzipData)."""
    if not is_compressible(filename, mime) or len(data) < 128:
        return data, False
    packed = gzip_data(data)
    if len(packed) >= len(data):
        return data, False
    return packed, True
