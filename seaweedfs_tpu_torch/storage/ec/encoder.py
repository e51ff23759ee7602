"""EC file pipeline: `.dat` -> `.ec00`..`.ec13` shards + `.ecx` sorted index,
and the rebuild of lost shards — the port of seaweedfs_tpu/storage/ec/
encoder.py for the torch codecs.

Layout matches the reference pipeline (ec_encoder.go:57-231): stripe the
volume into rows of 10 large (1GB) blocks while MORE than one full large row
remains, then rows of 10 small (1MB) blocks, zero-padding the tail; parity
is RS(10,4) over columns.  Column slices of up to `slice_size` bytes per
shard go through the codec as one (10, W) kernel call; output bytes are the
same for any slice width because parity is columnwise.

Encode and rebuild share one streaming pipeline (_stream_apply):
  * a prefetch thread fills (S, W) slices in host buffers, page-locked
    when the codec runs on a card;
  * the main thread hands each slice to the compute route, one of
    - the codec service (ops/codec_service.py), where slices become jobs
      that the scheduler coalesces with other concurrent volumes' slices
      into one batched kernel launch, uploading each slice straight from
      its page-locked buffer; two slices ride in flight.  The
      default for the `cuda` codec when the probe finds a card, as in the
      reference (encoder.py:97-98, :745-746);
    - direct: the main thread copies each slice from page-locked memory to
      the card and launches the GF kernel on a compute stream; a second
      stream copies the result back into page-locked memory behind a CUDA
      event, so slice k's readback overlaps slice k+1's upload and kernel;
    - inline on the host, for the host codecs (cpu, torch_cpu) without a
      service;
  * a writer thread appends the shard rows and recycles the buffers.
The bytes written are the same on every route.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from ...ops import codec_service, gf256
from ...ops.codec import get_codec
from ...stats.metrics import (
    EC_PARTIAL_FALLBACK,
    EC_REBUILD_BYTES,
    EC_REBUILD_RESULT,
    EC_REBUILD_SECONDS,
    EC_REBUILD_SHARDS,
)
from ...util import faultpoint
from ...util.executors import MeteredThreadPoolExecutor
from ..needle_map import NeedleMap
from .constants import (
    DATA_SHARDS,
    LARGE_BLOCK_SIZE,
    SMALL_BLOCK_SIZE,
    TOTAL_SHARDS,
    to_ext,
)

# bytes per shard per kernel call (64 x 256KB reference batches)
DEFAULT_SLICE = 16 * 1024 * 1024
# host slice buffers in rotation: one filling, one on the card, one
# awaiting readback, one in the writer — and one more through a service,
# which keeps two slices in flight
_HOST_BUFFERS = 4


def write_sorted_file_from_idx(base_name: str, ext: str = ".ecx") -> None:
    """Generate the sorted .ecx index from the .idx log (ec_encoder.go:27-54)."""
    NeedleMap.load_from_idx(base_name + ".idx").write_sorted_index(
        base_name + ext)


def write_ec_files(base_name: str, codec_name: str = "cuda",
                   slice_size: int = DEFAULT_SLICE, service=None) -> int:
    """Generate .ec00 ~ .ec13 from .dat (ec_encoder.go:57-59); -> the
    number of codec calls (slices) dispatched."""
    return generate_ec_files(base_name, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE,
                             codec_name, slice_size, service)


def generate_ec_files(base_name: str,
                      large_block_size: int = LARGE_BLOCK_SIZE,
                      small_block_size: int = SMALL_BLOCK_SIZE,
                      codec_name: str = "cuda",
                      slice_size: int = DEFAULT_SLICE,
                      service=None, progress=None,
                      sync: bool = False) -> int:
    """Stripe `<base>.dat` into the 14 shard files; -> slices dispatched.

    `progress(volume_bytes_done)` fires after each slice's shard bytes hit
    the output files (reference encoder.py:83).  `sync=True` fsyncs every
    shard file and their directory before returning, so a completed
    encode survives a crash.

    `service` routes the parity compute through a codec service
    (ops.codec_service): slices become jobs the scheduler coalesces with
    OTHER concurrent volumes' slices into one batched launch.  Default:
    the shared service when `codec_name` is a device codec and the probe
    finds a card (codec_service.service_for_codec), else the direct
    path."""
    codec = get_codec(codec_name)
    if service is None:
        service = codec_service.service_for_codec(codec_name)
    dat_path = base_name + ".dat"
    dat_size = os.path.getsize(dat_path)
    outs = [open(base_name + to_ext(i), "wb") for i in range(TOTAL_SHARDS)]
    try:
        with open(dat_path, "rb") as f:
            if (hasattr(codec, "parity_into") or service is not None) \
                    and not hasattr(codec, "encode_device") and dat_size > 0:
                # host codecs: the zero-copy route (reference
                # encoder.py:103-112); on a host of few cores the pipeline
                # is a SUM of stage costs, and this route drops the
                # (10, W) gather copy and the per-1MB write syscalls
                slices = _encode_stream_mmap(
                    f, dat_size, outs, codec, large_block_size,
                    small_block_size, slice_size, progress, service)
            else:
                slices = _encode_stream_pipelined(
                    f, dat_size, outs, codec, large_block_size,
                    small_block_size, slice_size, service, progress)
        if sync:
            for o in outs:
                o.flush()
                os.fsync(o.fileno())
            # new files also need their directory entry durable
            dfd = os.open(os.path.dirname(os.path.abspath(dat_path))
                          or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        return slices
    finally:
        for o in outs:
            o.close()


def _segments(dat_size: int, large: int, small: int, slice_size: int):
    """Yield (row_start, block_size, col, width) in shard-file write order."""
    processed = 0
    remaining = dat_size
    # large rows: strictly-greater loop per the reference (ec_encoder.go:214)
    while remaining > large * DATA_SHARDS:
        for col in range(0, large, slice_size):
            yield processed, large, col, min(slice_size, large - col)
        remaining -= large * DATA_SHARDS
        processed += large * DATA_SHARDS
    while remaining > 0:
        for col in range(0, small, slice_size):
            yield processed, small, col, min(slice_size, small - col)
        remaining -= small * DATA_SHARDS
        processed += small * DATA_SHARDS


def _slice_tasks(dat_size: int, large: int, small: int, slice_size: int):
    """Group stripe segments into codec-call batches of up to slice_size
    bytes per shard.

    Parity is columnwise, so segments from DIFFERENT stripe rows can share
    one codec call: shard i's bytes for consecutive rows are consecutive in
    its .ecNN file, so a batch is a per-shard concatenation.  Without this
    every small-row call would be a (10, 1MB) stripe — 16x the launches and
    host<->card round trips.  Yields lists of (row_start, block_size, col,
    width) whose widths sum to <= slice_size, in shard-file write order.
    """
    batch: list[tuple[int, int, int, int]] = []
    batch_width = 0
    for seg in _segments(dat_size, large, small, slice_size):
        width = seg[3]
        if batch and batch_width + width > slice_size:
            yield batch
            batch, batch_width = [], 0
        batch.append(seg)
        batch_width += width
    if batch:
        yield batch


def fill_stripe_rows(f, batch, dest: np.ndarray) -> None:
    """Fill dest[(DATA_SHARDS, total_width)] with one _slice_tasks batch:
    row i gathers the batch's segments at `row_start + i*block + col`."""
    for i in range(DATA_SHARDS):
        row = memoryview(dest[i])
        at = 0
        for row_start, block, col, width in batch:
            _read_into(f, row_start + i * block + col, row[at:at + width])
            at += width


def _read_at(f, offset: int, length: int) -> np.ndarray:
    """Read with zero-fill past EOF (the reference zero-pads tail buffers)."""
    arr = np.empty(length, dtype=np.uint8)
    _read_into(f, offset, memoryview(arr))
    return arr


def _read_into(f, offset: int, dest: memoryview) -> None:
    """Fill `dest` from f[offset:], zero-filling past EOF (the reference
    zero-pads tail buffers), reading straight into the stripe row."""
    f.seek(offset)
    n = f.readinto(dest) or 0
    while 0 < n < len(dest):  # short read mid-file
        more = f.readinto(dest[n:])
        if not more:
            break
        n += more
    if n < len(dest):
        dest[n:] = bytes(len(dest) - n)


def _pread_into(fd: int, dest, offset: int) -> None:
    """Positioned read of exactly len(dest) bytes; a short shard file
    raises (shard files have a fixed extent)."""
    got = 0
    length = len(dest)
    while got < length:
        n = os.preadv(fd, [dest[got:]], offset + got)
        if n <= 0:
            raise IOError(f"short shard read at {offset + got}")
        got += n


class _HostBuffers:
    """A fixed rotation of flat host buffers; `view(buf, rows, w)` is the
    contiguous (rows, w) prefix, so every H2D/D2H copy is one linear DMA.
    Page-locked when the codec runs on a card."""

    def __init__(self, count: int, nbytes: int, pinned: bool,
                 stop: threading.Event):
        self._free: queue.Queue = queue.Queue()
        self._stop = stop
        for _ in range(count):
            self._free.put(torch.empty(nbytes, dtype=torch.uint8,
                                       pin_memory=pinned))

    def get(self) -> "torch.Tensor | None":
        """Stop-aware take: None once the pipeline is shutting down."""
        while not self._stop.is_set():
            try:
                return self._free.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def put(self, buf: torch.Tensor) -> None:
        self._free.put(buf)

    @staticmethod
    def view(buf: torch.Tensor, rows: int, width: int) -> torch.Tensor:
        return buf[: rows * width].view(rows, width)


def _stream_apply(codec, matrix: np.ndarray, items, width_of, read_into,
                  write_out, slice_size: int, submit=None) -> int:
    """Run `matrix` (R, S) over a stream of column slices; -> slices run.

    For each item of `items` (consumed by the prefetch thread):
    `read_into(item, dest)` fills dest (S, width_of(item)) uint8 numpy;
    the GF product (R, width) is computed on the codec's device, or by
    `submit(dest)` -> a codec-service future of it when given; the writer
    thread then calls `write_out(item, src, out)` with both as numpy
    arrays.  Any stage's exception stops the pipeline, joins its threads
    and propagates."""
    n_in, n_out = matrix.shape[1], matrix.shape[0]
    # page-locked slices upload as DMA on either route; the direct route
    # drives the card's streams itself, the service drives its own.  The
    # cpu codec has no torch device: it runs inline on the host.
    device = getattr(codec, "device", None)
    pinned = device is not None and device.type == "cuda"
    on_card = submit is None and pinned
    max_pending = 1 if submit is None else 2
    stop = threading.Event()
    in_bufs = _HostBuffers(_HOST_BUFFERS + max_pending - 1,
                           n_in * slice_size, pinned, stop)
    # the service hands results back in its own buffers
    out_bufs = _HostBuffers(_HOST_BUFFERS if submit is None else 0,
                            n_out * slice_size, on_card, stop)
    q: queue.Queue = queue.Queue(maxsize=2)
    wq: queue.Queue = queue.Queue(maxsize=2)
    write_err: list[BaseException] = []

    def _put(item) -> bool:
        """Bounded put that gives up when the consumer has bailed."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def reader() -> None:
        try:
            for item in items:
                width = width_of(item)
                buf = in_bufs.get()
                if buf is None:
                    return
                read_into(item, _HostBuffers.view(buf, n_in, width).numpy())
                if not _put((item, buf, width)):
                    return
        except Exception as e:  # surfaced by the consumer
            _put(e)
            return
        _put(None)

    def writer() -> None:
        while True:
            pending = wq.get()
            if pending is None:
                return
            if write_err:
                continue  # drain so the main thread never blocks
            try:
                item, ibuf, obuf, width, result = pending
                if result is None:
                    result = _HostBuffers.view(obuf, n_out, width).numpy()
                write_out(item, _HostBuffers.view(ibuf, n_in, width).numpy(),
                          result)
                in_bufs.put(ibuf)
                if obuf is not None:
                    out_bufs.put(obuf)
            except Exception as e:  # surfaced by the main thread
                write_err.append(e)

    rt = threading.Thread(target=reader, name="ec-prefetch", daemon=True)
    wt = threading.Thread(target=writer, name="ec-writer", daemon=True)
    if on_card:
        compute = torch.cuda.Stream(codec.device)
        readback = torch.cuda.Stream(codec.device)
        dev_in = torch.empty(n_in * slice_size, dtype=torch.uint8,
                             device=codec.device)

    def dispatch(ibuf, obuf, width):
        """Start one slice; -> a codec-service future of its result, a CUDA
        event that fires when its result is in obuf, or None when it was
        computed inline on the host."""
        host_in = _HostBuffers.view(ibuf, n_in, width)
        if submit is not None:
            return submit(host_in.numpy())
        host_out = _HostBuffers.view(obuf, n_out, width)
        if device is None:  # the native SIMD codec
            res = codec.apply_rows(matrix, list(host_in.numpy()))
            for dst, row in zip(host_out.numpy(), res):
                dst[:] = row
            return None
        if not on_card:
            host_out.copy_(codec.apply_rows_device(matrix, host_in))
            return None
        with torch.cuda.stream(compute):
            d_in = _HostBuffers.view(dev_in, n_in, width)
            d_in.copy_(host_in, non_blocking=True)
            d_out = codec.apply_rows_device(matrix, d_in)
        readback.wait_stream(compute)
        with torch.cuda.stream(readback):
            d_out.record_stream(readback)
            host_out.copy_(d_out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(readback)
        return done

    def drain(pending) -> None:
        item, ibuf, obuf, width, done = pending
        result = None
        if submit is not None:
            result = done.result()  # (R, width), the service's to hand out
        elif done is not None:
            done.synchronize()
        wq.put((item, ibuf, obuf, width, result))
        if write_err:
            raise write_err[0]

    slices = 0
    in_flight: deque = deque()
    try:
        rt.start()
        wt.start()
        while True:
            got = q.get()
            if isinstance(got, Exception):
                raise got
            if got is None:
                break
            item, ibuf, width = got
            obuf = None
            if submit is None:
                obuf = out_bufs.get()
                if obuf is None:
                    break
            in_flight.append((item, ibuf, obuf, width,
                              dispatch(ibuf, obuf, width)))
            slices += 1
            if len(in_flight) > max_pending:  # k reads back while k+1 computes
                drain(in_flight.popleft())
        while in_flight:
            drain(in_flight.popleft())
        wq.put(None)
        wt.join()
        if write_err:
            raise write_err[0]
    finally:
        stop.set()  # unblocks the prefetch thread and buffer waits
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        if rt.ident is not None:
            rt.join()
        if wt.ident is not None and wt.is_alive():
            while True:
                try:
                    wq.get_nowait()
                except queue.Empty:
                    break
            wq.put(None)
            wt.join()
        if on_card:
            # no copy may still target a host buffer once they are freed
            compute.synchronize()
            readback.synchronize()
    return slices


try:
    _IOV_MAX = os.sysconf("SC_IOV_MAX")
    if _IOV_MAX <= 0:  # sysconf returns -1 for "unlimited/unknown"
        _IOV_MAX = 1024
except (ValueError, OSError, AttributeError):
    _IOV_MAX = 1024


def _writev_all(fd: int, bufs: list) -> None:
    """os.writev with partial-write resume, chunked to IOV_MAX iovecs
    (a small slice_size/small_block ratio can exceed the kernel limit).
    Consumed iovecs advance an index, so a batch costs O(n) in iovecs."""
    i = 0
    while i < len(bufs):
        n = os.writev(fd, bufs[i:i + _IOV_MAX])
        while i < len(bufs) and n >= len(bufs[i]):
            n -= len(bufs[i])
            i += 1
        if n and i < len(bufs):
            bufs[i] = memoryview(bufs[i])[n:]


def _encode_stream_mmap(f, dat_size, outs, codec, large, small, slice_size,
                        progress=None, service=None) -> int:
    """Single-threaded zero-copy encode for host codecs; -> codec calls
    (batches) dispatched.

    Per _slice_tasks batch: each stripe row of each segment is a 1-D view
    into the mmap'd .dat (page cache), passed directly to the SIMD GF
    kernel (codec.parity_into) and to writev for the data-shard appends:
    no (10, W) stripe gather, no per-MB write() syscalls.  Rows that cross
    EOF fall back to a small zero-padded copy (SeaweedFS zero-pads tail
    buffers, ec_encoder.go:162-192); rows fully past EOF share one zeros
    buffer.  No prefetch or writer thread: on a host of few cores they
    only add GIL churn."""
    import mmap

    # no MAP_POPULATE: prefaulting a 30GB volume upfront would stall the
    # encode and thrash hosts with RAM < volume; MADV_SEQUENTIAL readahead
    # streams pages just ahead of the kernel
    mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
    view = None
    batches = 0
    try:
        if hasattr(mm, "madvise"):
            try:
                mm.madvise(mmap.MADV_SEQUENTIAL)
            except (ValueError, OSError):
                pass
        view = np.frombuffer(mm, dtype=np.uint8)
        n_parity = len(codec.parity_matrix) if hasattr(
            codec, "parity_matrix") else 4
        zeros: "np.ndarray | None" = None
        done = 0
        parity = np.empty((n_parity, slice_size), dtype=np.uint8)
        for batch in _slice_tasks(dat_size, large, small, slice_size):
            total = sum(seg[3] for seg in batch)
            # per shard: the ordered list of row buffers for this batch
            per_shard: list[list[np.ndarray]] = [
                [] for _ in range(DATA_SHARDS)]
            for row_start, block, col, width in batch:
                for i in range(DATA_SHARDS):
                    off = row_start + i * block + col
                    if off + width <= dat_size:
                        row = view[off:off + width]
                    elif off >= dat_size:
                        if zeros is None or len(zeros) < width:
                            zeros = np.zeros(max(width, small), dtype=np.uint8)
                        row = zeros[:width]
                    else:
                        row = np.zeros(width, dtype=np.uint8)
                        n = dat_size - off
                        row[:n] = view[off:off + n]
                    per_shard[i].append(row)
            # parity per segment into contiguous per-batch output slabs
            at = 0
            futures = []
            if service is not None:
                # one vectored submit for the whole batch of segments: the
                # service coalesces them (and any concurrent volume's)
                # into one call, and the data-shard writev below overlaps
                # the parity compute
                seg_ins, seg_outs = [], []
                for s, (_, _, _, width) in enumerate(batch):
                    seg_ins.append(
                        [per_shard[i][s] for i in range(DATA_SHARDS)])
                    seg_outs.append(
                        [parity[j, at:at + width] for j in range(n_parity)])
                    at += width
                futures = service.submit_parity_many(seg_ins, seg_outs)
            else:
                for s, (_, _, _, width) in enumerate(batch):
                    codec.parity_into(
                        [per_shard[i][s] for i in range(DATA_SHARDS)],
                        [parity[j, at:at + width] for j in range(n_parity)])
                    at += width
            for i in range(DATA_SHARDS):
                outs[i].flush()  # keep the buffered layer empty around writev
                _writev_all(outs[i].fileno(), per_shard[i])
            for fut in futures:
                fut.result()  # parity slab must be full before its writev
            for j in range(n_parity):
                outs[DATA_SHARDS + j].flush()
                _writev_all(outs[DATA_SHARDS + j].fileno(),
                            [parity[j, :total]])
            batches += 1
            done += total * DATA_SHARDS
            if progress is not None:
                progress(min(done, dat_size))
    finally:
        del view  # release the exported buffer before closing the map
        try:
            mm.close()
        except BufferError:
            pass  # stray view still alive; the map dies with the process
    return batches


def _encode_stream_pipelined(f, dat_size, outs, codec, large, small,
                             slice_size, service=None, progress=None) -> int:
    """Encode the .dat open as `f` into the 14 open shard files `outs`;
    `progress(bytes of the .dat done)` after each slice is written."""
    done = 0

    def width_of(batch) -> int:
        return sum(seg[3] for seg in batch)

    def read_into(batch, dest: np.ndarray) -> None:
        fill_stripe_rows(f, batch, dest)

    def write_out(batch, data: np.ndarray, parity: np.ndarray) -> None:
        nonlocal done
        for i in range(DATA_SHARDS):
            outs[i].write(data[i])
        for j, prow in enumerate(parity):
            outs[DATA_SHARDS + j].write(prow)
        done += data.shape[1] * DATA_SHARDS
        if progress is not None:
            progress(min(done, dat_size))

    return _stream_apply(
        codec, codec.parity_matrix,
        _slice_tasks(dat_size, large, small, slice_size),
        width_of, read_into, write_out, slice_size,
        None if service is None else service.submit_parity)


# fires once per rebuilt slice, before the source reads: chaos tests kill
# a rebuild mid-stream here and assert the clean-error contract (partial
# .ecNN outputs removed, retry succeeds)
FP_REBUILD_READ = faultpoint.register("ec.rebuild.read")


def _pick_rebuild_sources(local: list[int], remote_fetch, partial=None
                          ) -> tuple[list[int], set[int], set[int]]:
    """-> (DATA_SHARDS source ids, local first; the remote ones among them;
    every shard a peer can serve).

    With a partial-repair client, remote availability and ORDER come from
    its holder map: same-rack sources are drawn before cross-rack ones
    (topology.placement.order_ec_sources), so the expensive links carry
    as few partials as possible, and each chosen source is probed with a
    1-byte read through `remote_fetch` (when there is one, and the client
    does not `trust_holders`), so a dead holder still listed in the map
    is passed over for a live one.  Without a client each shard not held
    locally is probed that way.  Every non-local shard is covered, so the
    caller rebuilds only GLOBALLY missing shards: a local copy of a shard
    that is healthy on a peer would double the repair traffic and register
    a duplicate holder."""
    sources = list(local[:DATA_SHARDS])
    remote: set[int] = set()
    remote_available: set[int] = set()
    if partial is not None:
        holders = {sid: h for sid, h in partial.remote_shards().items()
                   if sid not in local}
        remote_available = set(holders)
        probe = (remote_fetch is not None
                 and not getattr(partial, "trust_holders", False))
        for sid in partial.order(holders):
            if len(sources) >= DATA_SHARDS:
                break
            if probe:
                try:
                    if not remote_fetch(sid, 0, 1):
                        continue
                except Exception:
                    continue
            sources.append(sid)
            remote.add(sid)
    elif remote_fetch is not None:
        for sid in range(TOTAL_SHARDS):
            if sid in local:
                continue
            try:
                probe = remote_fetch(sid, 0, 1)
            except Exception:
                probe = None
            if probe:
                remote_available.add(sid)
                if len(sources) < DATA_SHARDS:
                    sources.append(sid)
                    remote.add(sid)
    if len(sources) < DATA_SHARDS:
        raise ValueError(
            f"cannot rebuild: only {len(sources)} of {TOTAL_SHARDS} shards "
            f"reachable ({len(local)} local), need {DATA_SHARDS}")
    return sources, remote, remote_available


def rebuild_ec_files(base_name: str, codec_name: str = "cuda",
                     slice_size: int = DEFAULT_SLICE, progress=None,
                     remote_fetch=None, shard_size: "int | None" = None,
                     service=None, partial=None) -> list[int]:
    """Regenerate the globally missing .ecNN files (ec_encoder.go:61-62);
    -> the rebuilt shard ids.

    The cached decode plan for this loss pattern runs through the same
    pipeline as the encode, on the same routes (`service` as for
    generate_ec_files); the DATA_SHARDS sources of each slice are read in
    parallel.  `remote_fetch(shard_id, offset, length) -> bytes | None`
    (EcVolume.remote_fetch's contract) lets a node with fewer than
    DATA_SHARDS local shards stream source intervals from its peers; a
    shard a peer still holds is not rebuilt here.  `shard_size` must be
    given when no shard is local (a partial client's probe can answer it
    too).  `progress(shard_bytes_done)` fires after each slice's rows are
    written.  On any error the partial .ecNN outputs are REMOVED — a
    failed rebuild leaves no truncated shard for a later mount to trust.

    `partial` (a storage.ec.partial.PartialRepairClient) switches remote
    sourcing to the partial-sum protocol: the remote sources multiply
    their intervals by their decode-plan columns and this node pulls ONE
    aggregated (missing x width) partial per rack instead of every raw
    interval.  The slice on the codec is then the local source rows
    followed by the partial's rows, under the plan's local columns
    followed by an identity block: local_plan x local + partial, the full
    decode by GF linearity, so the bytes are the same.  A partial failure
    degrades for the rest of the rebuild to full fetches
    (seaweedfs_ec_partial_fallback_total{path="rebuild"}), whose remote
    term is then computed on the rebuild's codec into the same rows.
    """
    codec = get_codec(codec_name)
    local = [i for i in range(TOTAL_SHARDS)
             if os.path.exists(base_name + to_ext(i))]
    if len(local) == TOTAL_SHARDS:
        return []
    picked = None
    if partial is not None:
        try:
            picked = _pick_rebuild_sources(local, remote_fetch, partial)
        except ValueError:
            # the holder map cannot supply 10 sources (stale locations):
            # let the probing path have a try before giving up
            EC_PARTIAL_FALLBACK.labels("rebuild").inc()
            partial = None
    if picked is None:
        picked = _pick_rebuild_sources(local, remote_fetch)
    sources, remote, remote_available = picked
    missing = [i for i in range(TOTAL_SHARDS)
               if i not in local and i not in remote_available]
    if not missing:
        return []
    if local:
        shard_size = os.path.getsize(base_name + to_ext(local[0]))
    elif shard_size is None:
        if partial is not None:
            shard_size = partial.shard_size() or None
        if shard_size is None:
            raise ValueError(
                "cannot rebuild: no local shard and no shard_size given")
    if service is None:
        service = codec_service.service_for_codec(codec_name)
    rows = gf256.decode_plan_for(
        codec.matrix, DATA_SHARDS, sources, tuple(missing))
    use_partial = partial is not None and bool(remote)
    if use_partial and remote_fetch is not None:
        # the protocol pulls racks x missing x width; when that exceeds
        # the plain sources x width (many lost shards, few remote
        # sources), full fetch IS the bandwidth-optimal path.  Without
        # a full-fetch transport the partial path stays on regardless —
        # it is the only remote sourcing available.
        try:
            use_partial = partial.ingress_advantage(
                remote, len(missing)) >= 1.0
        except Exception:  # noqa: BLE001 — fetch failures fall back anyway
            pass
    local_bytes = EC_REBUILD_BYTES.labels("local")
    # ingress labels for full fetches: the holder the fetcher actually
    # read from, when it can say, else beyond the rack
    loc_of = getattr(remote_fetch, "locality_of", None)
    if loc_of is None and partial is not None:
        loc_of = partial.locality_of

    def remote_label(sid: int) -> str:
        try:
            return loc_of(sid) if loc_of is not None else "dc"
        except Exception:  # noqa: BLE001 — labels must never fail a read
            return "dc"

    def read_source(sid: int, off: int, dest: np.ndarray) -> None:
        if sid in remote:
            buf = remote_fetch(sid, off, len(dest))
            if buf is None or len(buf) != len(dest):
                raise IOError(f"remote shard {sid} unavailable during rebuild")
            dest[:] = np.frombuffer(buf, dtype=np.uint8)
            EC_REBUILD_BYTES.labels(remote_label(sid)).inc(len(dest))
        else:
            _pread_into(ins[sid].fileno(), dest, off)
            local_bytes.inc(len(dest))

    if use_partial:
        local_srcs = [s for s in sources if s not in remote]
        remote_srcs = [s for s in sources if s in remote]
        col = {s: i for i, s in enumerate(sources)}
        coef_by_shard = {s: rows[:, col[s]] for s in remote_srcs}
        remote_plan = np.ascontiguousarray(
            rows[:, [col[s] for s in remote_srcs]])
        matrix = np.ascontiguousarray(np.concatenate(
            [rows[:, [col[s] for s in local_srcs]],
             np.eye(len(missing), dtype=np.uint8)], axis=1))
    else:
        local_srcs, matrix = sources, rows
    part_on = [use_partial]  # sticky: one failure drops to full fetch

    def remote_term(off: int, dest: np.ndarray) -> None:
        """dest (missing, width) = the remote sources' share of the
        decode: one aggregated partial, or after a clean, PERMANENT
        fallback, full fetches combined on the rebuild's own codec (its
        service when it has one), never quietly on the host."""
        if part_on[0]:
            try:
                dest[:] = partial.fetch(coef_by_shard, len(missing), off,
                                        dest.shape[1])
                return
            except Exception:
                if remote_fetch is None:
                    raise  # no fallback transport: surface the clean error
                part_on[0] = False
                EC_PARTIAL_FALLBACK.labels("rebuild").inc()
        got = np.empty((len(remote_srcs), dest.shape[1]), dtype=np.uint8)
        list(pool.map(lambda j: read_source(remote_srcs[j], off, got[j]),
                      range(len(remote_srcs))))
        term = (codec.apply_rows(remote_plan, list(got)) if service is None
                else service.submit_apply(remote_plan, list(got)).result())
        dest[:] = np.asarray(term, dtype=np.uint8).reshape(dest.shape)

    ins: dict[int, object] = {}
    outs: dict[int, object] = {}
    pool = None
    t_start = time.perf_counter()
    ok = False
    try:
        for i in sources:
            if i not in remote:
                ins[i] = open(base_name + to_ext(i), "rb")
        for i in missing:
            outs[i] = open(base_name + to_ext(i), "wb")
        pool = MeteredThreadPoolExecutor(
            max_workers=DATA_SHARDS, name="ec_rebuild_read",
            thread_name_prefix="ec-rebuild-read")

        def read_into(off: int, dest: np.ndarray) -> None:
            faultpoint.inject(FP_REBUILD_READ, ctx=base_name)
            list(pool.map(lambda j: read_source(local_srcs[j], off, dest[j]),
                          range(len(local_srcs))))
            if use_partial:
                remote_term(off, dest[len(local_srcs):])

        def write_out(off: int, _src, rebuilt: np.ndarray) -> None:
            for row, sid in zip(rebuilt, missing):
                outs[sid].write(row)
            if progress is not None:
                progress(off + len(rebuilt[0]))

        _stream_apply(
            codec, matrix, range(0, shard_size, slice_size),
            lambda off: min(slice_size, shard_size - off),
            read_into, write_out, slice_size,
            None if service is None
            else lambda data: service.submit_apply(matrix, data))
        ok = True
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
        for h in ins.values():
            h.close()
        for h in outs.values():
            h.close()
        EC_REBUILD_SECONDS.labels(codec_name).observe(
            time.perf_counter() - t_start)
        EC_REBUILD_RESULT.labels("ok" if ok else "error").inc()
        if ok:
            EC_REBUILD_SHARDS.inc(len(missing))
        else:
            for sid in missing:
                try:
                    os.remove(base_name + to_ext(sid))
                except FileNotFoundError:
                    pass
    return missing
