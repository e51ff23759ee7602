"""Chunked-file interval model.

The port's copy of seaweedfs_tpu/filer/filechunks.py.

Reference: weed/filer/filechunks.go — a file is an ordered list of
FileChunk(fid, offset, size, mtime); later-written chunks shadow earlier
ones where they overlap, so reads resolve the chunk list into a sequence of
visible intervals, and compaction drops fully-shadowed chunks.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..pb import filer_pb2


def total_size(chunks) -> int:
    """Logical file size = max chunk extent (filechunks.go TotalSize)."""
    size = 0
    for c in chunks:
        size = max(size, c.offset + c.size)
    return size


def etag(chunks) -> str:
    """Weak etag over the chunk etags (filechunks.go ETag)."""
    if len(chunks) == 1:
        return chunks[0].e_tag
    import hashlib

    h = hashlib.md5()
    for c in chunks:
        h.update(c.e_tag.encode())
    return h.hexdigest()


@dataclass
class VisibleInterval:
    start: int
    stop: int
    file_id: str
    mtime: int
    chunk_offset: int  # offset of `start` within the chunk's data
    chunk_size: int
    cipher_key: bytes = b""
    is_compressed: bool = False


@dataclass
class ChunkView:
    file_id: str
    offset: int  # offset within the chunk's blob
    size: int
    logical_offset: int  # position in the file
    chunk_size: int
    cipher_key: bytes = b""
    is_compressed: bool = False


def non_overlapping_visible_intervals(chunks) -> list[VisibleInterval]:
    """Resolve the chunk list into disjoint visible intervals.

    Chunks are applied in (mtime, fid) order; each newer chunk punches its
    range out of the accumulated older intervals (filechunks.go
    NonOverlappingVisibleIntervals / MergeIntoVisibles).
    """
    ordered = sorted(chunks, key=lambda c: (c.mtime, c.file_id))
    visibles: list[VisibleInterval] = []
    for c in ordered:
        new = VisibleInterval(
            start=c.offset,
            stop=c.offset + c.size,
            file_id=c.file_id,
            mtime=c.mtime,
            chunk_offset=0,
            chunk_size=c.size,
            cipher_key=bytes(c.cipher_key),
            is_compressed=c.is_compressed,
        )
        out: list[VisibleInterval] = []
        for v in visibles:
            if v.stop <= new.start or v.start >= new.stop:
                out.append(v)  # disjoint
                continue
            if v.start < new.start:  # left remainder survives
                out.append(
                    VisibleInterval(
                        v.start, new.start, v.file_id, v.mtime,
                        v.chunk_offset, v.chunk_size, v.cipher_key,
                        v.is_compressed,
                    )
                )
            if v.stop > new.stop:  # right remainder survives
                out.append(
                    VisibleInterval(
                        new.stop, v.stop, v.file_id, v.mtime,
                        v.chunk_offset + (new.stop - v.start), v.chunk_size,
                        v.cipher_key, v.is_compressed,
                    )
                )
        out.append(new)
        out.sort(key=lambda v: v.start)
        visibles = out
    return visibles


def view_from_visibles(
    visibles: list[VisibleInterval], offset: int, size: int
) -> list[ChunkView]:
    """Chunk views covering [offset, offset+size) (filechunks.go ViewFromVisibleIntervals)."""
    stop = offset + size
    views: list[ChunkView] = []
    for v in visibles:
        lo = max(v.start, offset)
        hi = min(v.stop, stop)
        if lo >= hi:
            continue
        views.append(
            ChunkView(
                file_id=v.file_id,
                offset=v.chunk_offset + (lo - v.start),
                size=hi - lo,
                logical_offset=lo,
                chunk_size=v.chunk_size,
                cipher_key=v.cipher_key,
                is_compressed=v.is_compressed,
            )
        )
    return views


def view_from_chunks(chunks, offset: int, size: int) -> list[ChunkView]:
    return view_from_visibles(
        non_overlapping_visible_intervals(chunks), offset, size
    )


def compact_chunks(chunks) -> tuple[list, list]:
    """-> (compacted, garbage): drop chunks fully shadowed by newer writes
    (filechunks.go CompactFileChunks)."""
    visible_fids = {v.file_id for v in non_overlapping_visible_intervals(chunks)}
    compacted, garbage = [], []
    for c in chunks:
        (compacted if c.file_id in visible_fids else garbage).append(c)
    return compacted, garbage


def minus_chunks(older, newer) -> list:
    """Chunks in `older` not present in `newer` (by fid) — the delta whose
    blobs must be deleted after an entry update (filechunks.go MinusChunks)."""
    keep = {c.file_id for c in newer}
    return [c for c in older if c.file_id not in keep]


def make_chunk(file_id: str, offset: int, size: int, mtime: int,
               e_tag: str = "", is_compressed: bool = False) -> filer_pb2.FileChunk:
    return filer_pb2.FileChunk(
        file_id=file_id,
        offset=offset,
        size=size,
        mtime=mtime,
        e_tag=e_tag,
        is_compressed=is_compressed,
    )
