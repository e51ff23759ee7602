"""Manifest chunks: indirection blobs that keep huge chunk lists out of
the metadata store.

The port's copy of seaweedfs_tpu/filer/filechunk_manifest.py.

Reference: weed/filer/filechunk_manifest.go — when an entry accumulates
more than `manifest_batch` chunks, batches of them are serialized into a
FileChunkManifest blob, uploaded like any other chunk, and replaced by a
single FileChunk with is_chunk_manifest=true spanning the batch's byte
range.  Readers resolve manifests (recursively — a manifest of manifests
is legal) back into the real chunk list before interval resolution.
"""

from __future__ import annotations

import gzip

from ..pb import filer_pb2
from . import filechunks

MANIFEST_BATCH = 1000  # filechunk_manifest.go ManifestBatch


def has_chunk_manifest(chunks) -> bool:
    return any(c.is_chunk_manifest for c in chunks)


def separate_manifest_chunks(chunks) -> tuple[list, list]:
    """-> (manifest_chunks, non_manifest_chunks)."""
    manifests, plain = [], []
    for c in chunks:
        (manifests if c.is_chunk_manifest else plain).append(c)
    return manifests, plain


def resolve_chunk_manifest(fetch_fn, chunks, recursion: int = 0) -> list:
    """Expand manifest chunks into their real chunk lists.

    ``fetch_fn(file_id) -> bytes`` fetches a whole blob (usually through
    the chunk cache).  Depth-limited: legitimate data never nests deeper
    than a few levels; a cycle in corrupted metadata must not hang.
    """
    if recursion > 10:
        raise IOError("chunk manifest nesting too deep (corrupt metadata?)")
    out = []
    for c in chunks:
        if not c.is_chunk_manifest:
            out.append(c)
            continue
        m = filer_pb2.FileChunkManifest()
        m.ParseFromString(gzip.decompress(fetch_fn(c.file_id)))
        resolved = resolve_chunk_manifest(fetch_fn, list(m.chunks),
                                          recursion + 1)
        out.extend(resolved)
    return out


def maybe_manifestize(save_fn, chunks,
                      manifest_batch: int = MANIFEST_BATCH) -> list:
    """Batch plain chunks into manifest chunks when the list is long.

    ``save_fn(data: bytes) -> filer_pb2.FileChunk`` uploads a blob and
    returns its chunk record (offset/size are overwritten here).  Already-
    manifest chunks pass through untouched; only full batches are folded,
    so a file growing by appends re-manifestizes amortized-once.
    """
    manifests, plain = separate_manifest_chunks(chunks)
    if len(plain) <= manifest_batch:
        return list(chunks)
    plain.sort(key=lambda c: c.offset)
    out = list(manifests)
    pos = 0
    while len(plain) - pos > manifest_batch:
        batch = plain[pos : pos + manifest_batch]
        out.append(_manifestize_batch(save_fn, batch))
        pos += manifest_batch
    out.extend(plain[pos:])
    return out


def _manifestize_batch(save_fn, batch) -> filer_pb2.FileChunk:
    m = filer_pb2.FileChunkManifest()
    m.chunks.extend(batch)
    blob = gzip.compress(m.SerializeToString(), compresslevel=3)
    chunk = save_fn(blob)
    chunk.is_chunk_manifest = True
    chunk.offset = min(c.offset for c in batch)
    chunk.size = filechunks.total_size(batch) - chunk.offset
    chunk.mtime = max(c.mtime for c in batch)
    return chunk
