"""EC codec service: batched, double-buffered GF(2⁸) dispatch — the port of
seaweedfs_tpu/ops/codec_service.py.

One bounded submission queue sits between every GF caller — the file
encoder, the rebuild pipeline — and the compute backend.  A scheduler
thread drains it, coalesces jobs that share a matrix (same generator rows
or same decode plan) into one batch, and dispatches the batch as a single
compute call:

* **device mode** runs on a mesh of devices (parallel/mesh.py; built
  when the first batch arrives: the 1x1 mesh of the service's ``device``
  when one is named, else ``make_mesh()``, every visible card).  On a 1x1 mesh, one card, each job of a batch is copied
  straight from the caller's rows into its entry of one ``(V, S, W_pad)``
  block on the card
  (``W_pad`` is the widest job rounded up to 16 bytes, the kernel's vector
  width) on a compute stream, and the batch runs as ONE
  ``rs_cuda.gf_apply_batched`` launch of the hand-written kernel.  Rows
  that lie in page-locked memory (the encoder's slices) upload as
  asynchronous DMA, with no host copy.  The result is copied back on a
  readback stream, behind an event, into page-locked memory.  Up to two
  batches stay in flight: while batch *k* computes, batch *k+1* is
  uploaded and launched, and *k*'s readback overlaps *k+1*'s compute.
  Each batch reads back into its own buffer, never reused while a
  delivered result still views it; jobs that gave an ``out`` get a copy
  there instead.  A caller's rows are read by the card until its job is
  delivered, so it must not refill them before.  On a mesh of more
  entries, the reference's layout (ops/codec_service.py:514-547): the
  batch is padded to the mesh, V to a multiple of ``dp`` and the width to
  a power-of-two bucket that ``sp`` divides (`_pad_width`), and
  `mesh.apply_per_entry` has each entry upload its volumes' column
  block, launch gf_apply_batched on it and read its part back into the
  page-locked output, all on the entry's own stream.  ``device="cpu"`` runs
  the same batching and dispatch on CPU tensors through the kernel's
  plain version (tests only).

* **host mode**: the SAME scheduler runs on the port's ``cpu`` codec, the
  native SIMD library (native/seaweed_native.cc), as the reference's host
  mode does, so the batching and fairness properties hold on hosts without
  a card.  Small jobs coalesce column-wise into one reused slab and one
  native call.

Callers that hold many independent jobs at once use the vectored
``submit_*_many`` entries: one lock acquisition and one wakeup for the
group.

Fairness: batches always start from the queue HEAD (the oldest job), so a
saturating producer of one job class cannot starve another past one
batch's service time.  GF arithmetic is exact, so every mode gives the
same bytes.

Env knobs (all ``SEAWEEDFS_TPU_EC_SERVICE_*``): ``QUEUE`` (bound, 64),
``BATCH`` (max jobs/batch, 16), ``BATCH_MB`` (max input MB/batch: 64 in
host mode, 1024 in device mode),
``COALESCE_KB`` (host slab threshold per job, 16), ``DEGRADED`` ("1"
routes degraded-read interval decodes through the service), and the
top-level ``SEAWEEDFS_TPU_EC_SERVICE`` ("0" disables every default
wiring).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

import numpy as np
import torch

from ..stats.metrics import (
    EC_SERVICE_BATCH_BYTES,
    EC_SERVICE_BATCH_JOBS,
    EC_SERVICE_FLUSH,
    EC_SERVICE_INFLIGHT,
    EC_SERVICE_JOB_SECONDS,
    EC_SERVICE_JOBS,
    EC_SERVICE_QUEUE_DEPTH,
    EC_SERVICE_STAGE,
)
from . import device_probe, gf256
from .codec import DEVICE_CODEC_NAMES as _DEVICE_CODECS
from ..native import lib as native
from .rs_cuda import gf_apply_batched
from .rs_torch import resolve_device

DATA_SHARDS = 10
PARITY_SHARDS = 4
_VEC_BYTES = 16  # the kernel's widest access: rows padded to it take it
# input MB per batch: the host's slab and cache sizes bound a host batch;
# on a card the cap must admit the encoder's slices (16 MiB per shard =
# 160 MiB of input each), so six of them share a launch.  Two batches in
# flight then hold ~2.7 GiB of the card (inputs and outputs).
_HOST_BATCH_MB = 64
_DEVICE_BATCH_MB = 1024

_STAGE_BUILD = EC_SERVICE_STAGE.labels("build")
_STAGE_COMPUTE = EC_SERVICE_STAGE.labels("compute")
_STAGE_READBACK = EC_SERVICE_STAGE.labels("readback")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


class _Job:
    __slots__ = ("kind", "key", "rows", "data", "width", "out",
                 "event", "result", "error", "t_submit")

    def __init__(self, kind, key, rows, data, width, out):
        self.kind = kind
        self.key = key
        self.rows = rows
        # (S, W) uint8 ndarray, or a list of S equal-length 1-D rows
        # (e.g. zero-copy views into an mmap'd .dat)
        self.data = data
        self.width = width
        self.out = out
        self.event = threading.Event()
        self.result = None  # (R, W) array-like of rows once delivered
        self.error: "Exception | None" = None
        self.t_submit = time.perf_counter()


class CodecFuture:
    """Handle for a submitted job; ``result()`` blocks until delivery
    and returns an (R, W) array-like — iterate it for the output rows."""

    __slots__ = ("_job",)

    def __init__(self, job: _Job):
        self._job = job

    def done(self) -> bool:
        return self._job.event.is_set()

    def result(self, timeout: "float | None" = None):
        if not self._job.event.wait(timeout):
            raise TimeoutError("codec service job not done")
        if self._job.error is not None:
            raise self._job.error
        return self._job.result


class CodecService:
    """Batched GF(2⁸) dispatch behind a bounded queue.

    ``mode``: ``host`` (the cpu codec), ``device`` (one batched
    kernel launch per batch on ``device``, a CUDA card unless ``"cpu"`` is
    asked for), or ``auto`` (device iff ``codec_name`` names a device codec
    AND the fast probe reports a reachable card — an unreachable card
    degrades to host in probe-timeout seconds, never minutes).  The
    defaults, ``auto`` with the ``cuda`` codec, run on the card when there
    is one; callers that want the host pass ``mode="host"`` or
    ``codec_name="cpu"``.
    """

    def __init__(self, mode: str = "auto", codec_name: str = "cuda",
                 data_shards: int = DATA_SHARDS,
                 parity_shards: int = PARITY_SHARDS,
                 max_batch: "int | None" = None,
                 max_queue: "int | None" = None,
                 max_batch_mb: "int | None" = None,
                 coalesce_kb: "int | None" = None,
                 device=None, mesh=None):
        if mode not in ("auto", "host", "device"):
            raise ValueError(f"unknown codec service mode {mode!r}")
        self.fallback_reason = ""
        if mode == "auto":
            if codec_name in _DEVICE_CODECS:
                pr = device_probe.probe()
                if pr.accelerator:
                    mode = "device"
                else:
                    mode = "host"
                    self.fallback_reason = (
                        pr.error or f"no accelerator ({pr.platform or 'none'})")
            else:
                mode = "host"
        self.mode = mode
        # the device mode's mesh (parallel/mesh.py): built by make_mesh()
        # at the first device batch unless one is given; its first entry is
        # the service's device
        self.mesh = mesh
        self._device_named = device is not None
        if mesh is not None and device is None:
            device = mesh.first
        # device mode without a card raises here unless the CPU is asked for
        self.device = (resolve_device("cuda" if device is None else device)
                       if mode == "device" else torch.device("cpu"))
        self.codec_name = codec_name
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.matrix = gf256.rs_matrix(data_shards, data_shards + parity_shards)
        self.parity_matrix = np.ascontiguousarray(
            gf256.rs_parity_matrix(data_shards, parity_shards), dtype=np.uint8)
        self._parity_key = (self.parity_matrix.shape,
                            self.parity_matrix.tobytes())
        self.max_batch = max_batch if max_batch is not None else _env_int(
            "SEAWEEDFS_TPU_EC_SERVICE_BATCH", 16)
        self.max_queue = max_queue if max_queue is not None else _env_int(
            "SEAWEEDFS_TPU_EC_SERVICE_QUEUE", 64)
        self.max_batch_bytes = (
            max_batch_mb if max_batch_mb is not None else _env_int(
                "SEAWEEDFS_TPU_EC_SERVICE_BATCH_MB",
                _DEVICE_BATCH_MB if mode == "device" else _HOST_BATCH_MB)
        ) << 20
        self.coalesce_bytes = (
            coalesce_kb if coalesce_kb is not None else _env_int(
                "SEAWEEDFS_TPU_EC_SERVICE_COALESCE_KB", 16)) << 10
        self._q: deque[_Job] = deque()
        self._cond = threading.Condition()
        self._open = True
        self._thread: "threading.Thread | None" = None
        self._thread_err: "Exception | None" = None
        # reused input slab for host coalescing (scheduler-thread-only):
        # a fresh allocation per batch pays more in page faults than the
        # compute call it feeds
        self._slab_in: "np.ndarray | None" = None
        self._on_card = self.device.type == "cuda"
        if self._on_card:
            self._compute = torch.cuda.Stream(self.device)
            self._readback = torch.cuda.Stream(self.device)
        # metric children resolved once — the submit/deliver hot path
        # must not pay registry locks per job
        self._depth_child = EC_SERVICE_QUEUE_DEPTH.labels()
        self._inflight_child = EC_SERVICE_INFLIGHT.labels()
        self._batch_jobs_child = EC_SERVICE_BATCH_JOBS.labels()
        self._batch_bytes_child = EC_SERVICE_BATCH_BYTES.labels()
        self._job_ok = {k: EC_SERVICE_JOBS.labels(k, "ok")
                        for k in ("parity", "apply")}
        self._job_err = {k: EC_SERVICE_JOBS.labels(k, "error")
                         for k in ("parity", "apply")}
        self._job_secs = {k: EC_SERVICE_JOB_SECONDS.labels(k)
                          for k in ("parity", "apply")}
        self._flush_children = {r: EC_SERVICE_FLUSH.labels(r)
                                for r in ("full", "bytes", "ready", "drain")}

    # -- submission -------------------------------------------------------

    def submit_parity(self, data, out=None) -> CodecFuture:
        """(data_shards, W) -> future of the parity rows."""
        return self._submit_many(
            "parity", self.parity_matrix, self._parity_key,
            (data,), (out,))[0]

    def submit_parity_many(self, datas, outs=None) -> list[CodecFuture]:
        """Vectored submit: one lock/wakeup for a group of parity jobs."""
        if outs is None:
            outs = (None,) * len(datas)
        return self._submit_many(
            "parity", self.parity_matrix, self._parity_key, datas, outs)

    def submit_apply(self, rows: np.ndarray, inputs, out=None) -> CodecFuture:
        """Arbitrary (R, S) GF matrix x S input rows -> future of R rows."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        if rows.ndim != 2:
            raise ValueError("rows must be a 2-D GF matrix")
        return self._submit_many(
            "apply", rows, (rows.shape, rows.tobytes()), (inputs,), (out,))[0]

    def submit_apply_many(self, rows: np.ndarray, inputs_list,
                          outs=None) -> list[CodecFuture]:
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        if rows.ndim != 2:
            raise ValueError("rows must be a 2-D GF matrix")
        if outs is None:
            outs = (None,) * len(inputs_list)
        return self._submit_many(
            "apply", rows, (rows.shape, rows.tobytes()), inputs_list, outs)

    @staticmethod
    def _validate(data, s: int):
        """-> (data, width).  2-D uint8 arrays pass through untouched
        (the fast path); anything else becomes a list of equal-length
        1-D uint8 rows."""
        if isinstance(data, np.ndarray) and data.ndim == 2:
            if data.shape[0] != s:
                raise ValueError(f"want {s} input rows, got {data.shape[0]}")
            if data.dtype != np.uint8:
                raise ValueError("inputs must be uint8")
            if not data.flags["C_CONTIGUOUS"]:
                data = np.ascontiguousarray(data)
            return data, data.shape[1]
        data = [np.ascontiguousarray(r_, dtype=np.uint8) for r_ in data]
        if len(data) != s:
            raise ValueError(f"want {s} input rows, got {len(data)}")
        width = len(data[0])
        for r_ in data:
            if r_.ndim != 1 or len(r_) != width:
                raise ValueError("input rows must be equal-length 1-D")
        return data, width

    def _submit_many(self, kind, rows, key, datas, outs) -> list[CodecFuture]:
        r, s = rows.shape
        jobs: list[_Job] = []
        futs: list[CodecFuture] = []
        for data, out in zip(datas, outs):
            data, width = self._validate(data, s)
            if out is not None:
                out = list(out) if not isinstance(out, np.ndarray) else out
                if len(out) != r:
                    raise ValueError(f"want {r} output rows, got {len(out)}")
                for o in out:
                    if len(o) != width:
                        raise ValueError("output rows must match input width")
            job = _Job(kind, key, rows, data, width, out)
            futs.append(CodecFuture(job))
            if width == 0:  # nothing to compute: deliver inline
                job.result = (out if out is not None else
                              np.empty((r, 0), np.uint8))
                job.event.set()
            else:
                jobs.append(job)
        if jobs:
            with self._cond:
                if not self._open:
                    raise RuntimeError("codec service is closed")
                while len(self._q) >= self.max_queue:
                    self._cond.wait(0.1)
                    if not self._open:
                        raise RuntimeError("codec service is closed")
                self._q.extend(jobs)
                self._depth_child.set(len(self._q))
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._run, name="ec-codec-service",
                        daemon=True)
                    self._thread.start()
                self._cond.notify_all()
        return futs

    # -- sync conveniences ------------------------------------------------

    def parity_into(self, inputs, outs) -> None:
        self.submit_parity(inputs, out=outs).result()

    def apply_rows(self, rows, inputs):
        return self.submit_apply(rows, inputs).result()

    # -- lifecycle --------------------------------------------------------

    def close(self, timeout: "float | None" = 30.0) -> None:
        """Stop accepting jobs, drain everything in flight, stop the
        scheduler.  Every already-submitted job still gets its result."""
        with self._cond:
            self._open = False
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout)

    @property
    def closed(self) -> bool:
        return not self._open

    # -- scheduler --------------------------------------------------------

    def _collect_locked(self) -> "tuple[list[_Job], str]":
        """Pop the head job plus every queued job sharing its matrix, up
        to the job/byte caps.  Head-of-queue start = oldest-first, so no
        job class can starve another."""
        head = self._q.popleft()
        batch = [head]
        s = head.rows.shape[1]
        nbytes = head.width * s
        reason = "ready"
        if self.max_batch > 1 and self._q:
            kept: deque[_Job] = deque()
            while self._q:
                job = self._q.popleft()
                if job.key != head.key or job.kind != head.kind:
                    kept.append(job)
                    continue
                jb = job.width * s
                if len(batch) >= self.max_batch:
                    kept.append(job)
                    reason = "full"
                    break
                if nbytes + jb > self.max_batch_bytes:
                    kept.append(job)
                    reason = "bytes"
                    break
                batch.append(job)
                nbytes += jb
            kept.extend(self._q)
            self._q = kept
        self._depth_child.set(len(self._q))
        self._batch_jobs_child.observe(len(batch))
        self._batch_bytes_child.observe(nbytes)
        return batch, reason

    def _run(self) -> None:
        inflight: deque = deque()  # device mode: (jobs, readback handle)
        try:
            while True:
                with self._cond:
                    while not self._q and self._open and not inflight:
                        self._cond.wait(0.2)
                    batch = reason = None
                    if self._q:
                        batch, reason = self._collect_locked()
                        if not self._open and not self._q:
                            reason = "drain"
                    elif not inflight and not self._open:
                        break
                    self._cond.notify_all()  # wake blocked submitters
                if batch is None:
                    if inflight:
                        self._complete_device(*inflight.popleft())
                        self._inflight_child.set(len(inflight))
                    continue
                self._flush_children[reason].inc()
                try:
                    if self.mode == "device":
                        handle = self._dispatch_device(batch)
                        inflight.append((batch, handle))
                        self._inflight_child.set(len(inflight))
                        if len(inflight) >= 2:
                            self._complete_device(*inflight.popleft())
                            self._inflight_child.set(len(inflight))
                    else:
                        self._compute_host(batch)
                except Exception as e:
                    # the collected batch is in neither queue nor
                    # inflight — fail it here or its waiters hang forever
                    for job in batch:
                        self._fail(job, e)
                    raise
            while inflight:
                self._complete_device(*inflight.popleft())
                self._inflight_child.set(len(inflight))
        except Exception as e:  # scheduler death must not strand waiters
            self._thread_err = e
            for jobs, _handle in inflight:
                for job in jobs:
                    self._fail(job, e)
            with self._cond:
                pending = list(self._q)
                self._q.clear()
                self._open = False
                self._cond.notify_all()
            for job in pending:
                self._fail(job, e)

    # -- delivery ---------------------------------------------------------

    def _deliver(self, job: _Job, result) -> None:
        """``result`` is an (R, W) array the caller may keep: it is copied
        into the job's ``out`` where one was given."""
        if job.out is not None:
            for dst, src in zip(job.out, result):
                np.copyto(np.asarray(dst), src, casting="no")
            job.result = job.out
        else:
            job.result = result
        job.event.set()
        self._job_ok[job.kind].inc()
        self._job_secs[job.kind].observe(time.perf_counter() - job.t_submit)

    def _fail(self, job: _Job, err: Exception) -> None:
        if job.event.is_set():
            return
        job.error = err
        job.event.set()
        self._job_err[job.kind].inc()

    @staticmethod
    def _fill(dest: np.ndarray, data, s: int) -> None:
        """Copy a job's (S, W) input into dest[:, :W]."""
        w = dest.shape[1]
        if isinstance(data, np.ndarray):
            dest[:, :] = data
        else:
            for ri in range(s):
                dest[ri, :w] = data[ri]

    # -- host backend -----------------------------------------------------

    def _compute_host(self, batch: list[_Job]) -> None:
        rows = batch[0].rows
        r, s = rows.shape
        mbytes = rows.tobytes()
        try:
            small = (len(batch) > 1
                     and all(j.width <= self.coalesce_bytes for j in batch))
            if small:
                # column-concatenate into the reused input slab -> ONE
                # native call for the whole batch; per-job results are
                # views of one fresh output
                with _STAGE_BUILD.time():
                    total = sum(j.width for j in batch)
                    slab = self._slab_in
                    if (slab is None or slab.shape[0] != s
                            or slab.shape[1] < total):
                        slab = np.empty(
                            (s, max(total, 1 << 20)), dtype=np.uint8)
                        self._slab_in = slab
                    at = 0
                    for j in batch:
                        self._fill(slab[:, at:at + j.width], j.data, s)
                        at += j.width
                with _STAGE_COMPUTE.time():
                    out_slab = np.empty((r, total), dtype=np.uint8)
                    # slab rows are strided by its capacity: pass each
                    # row's view; the kernel reads `total` bytes of each
                    native.gf_apply_fast(
                        mbytes, r, s, [slab[i] for i in range(s)],
                        [out_slab[i] for i in range(r)], total)
                at = 0
                for j in batch:
                    self._deliver(j, out_slab[:, at:at + j.width])
                    at += j.width
                return
            with _STAGE_COMPUTE.time():
                for j in batch:
                    rows_in = ([j.data[i] for i in range(s)]
                               if isinstance(j.data, np.ndarray) else j.data)
                    out = np.empty((r, j.width), dtype=np.uint8)
                    native.gf_apply_fast(mbytes, r, s, rows_in,
                                         [out[i] for i in range(r)], j.width)
                    self._deliver(j, out)
        except Exception as e:
            for j in batch:
                self._fail(j, e)

    # -- device backend ---------------------------------------------------

    def _device_mesh(self):
        if self.mesh is None:
            from ..parallel.mesh import make_mesh

            # every visible card only when the caller named no device
            self.mesh = make_mesh(
                None if self._on_card and not self._device_named
                else [self.device])
        return self.mesh

    @staticmethod
    def _pad_width(width: int, sp: int) -> int:
        """The reference's width buckets for a mesh of more entries:
        powers of two from max(sp, 256), a multiple of sp."""
        w = max(sp, 256)
        while w < width:
            w <<= 1
        return -(-w // sp) * sp

    def _dispatch_device(self, batch: list[_Job]):
        """Upload and launch one batch; -> (output, done) where `done` (an
        event, or one per mesh entry) fires once the (V, R, W_pad) host
        output holds the result (None when the batch ran on CPU tensors)."""
        mesh = self._device_mesh()
        if mesh.size > 1:
            return self._dispatch_mesh(batch, mesh)
        rows = batch[0].rows
        s = rows.shape[1]
        w_pad = -(-max(j.width for j in batch) // _VEC_BYTES) * _VEC_BYTES
        if not self._on_card:
            return self._upload_and_launch(batch, rows, s, w_pad), None
        with torch.cuda.device(self.device):
            with torch.cuda.stream(self._compute):
                d_out = self._upload_and_launch(batch, rows, s, w_pad)
            self._readback.wait_stream(self._compute)
            with torch.cuda.stream(self._readback):
                # a fresh page-locked output per batch: results handed to
                # callers view it, so it is never refilled under them
                out = torch.empty(d_out.shape, dtype=torch.uint8,
                                  pin_memory=True)
                out.copy_(d_out, non_blocking=True)
                d_out.record_stream(self._readback)
                done = torch.cuda.Event()
                done.record(self._readback)
        return out, done

    def _upload_and_launch(self, batch: list[_Job], rows, s: int,
                           w_pad: int) -> torch.Tensor:
        """Copy every job's rows into its entry of one (V, S, W_pad) block
        on the service's device and launch the batch; on a card both only
        enqueue work on the current (compute) stream."""
        with _STAGE_BUILD.time():
            block = torch.empty((len(batch), s, w_pad), dtype=torch.uint8,
                                device=self.device)
            for vi, j in enumerate(batch):
                # columns past a job's width stay unset: columns are
                # independent, and their outputs are never delivered.
                # One call per job where its rows are one array: each call
                # gives up and retakes the GIL, which the volumes' I/O
                # threads hold for milliseconds at a time.
                if isinstance(j.data, np.ndarray):
                    block[vi, :, :j.width].copy_(torch.from_numpy(j.data),
                                                 non_blocking=True)
                    continue
                for ri, row in enumerate(j.data):
                    block[vi, ri, :j.width].copy_(torch.from_numpy(row),
                                                  non_blocking=True)
        with _STAGE_COMPUTE.time():
            return gf_apply_batched(rows, block)

    def _dispatch_mesh(self, batch: list[_Job], mesh):
        """One batch over a mesh of more entries: V padded to a multiple of
        dp, the width to `_pad_width`, and both split over the mesh by
        `apply_per_entry`; each entry uploads its block, launches and
        reads back into its own output on its own stream.  -> (parts,
        events): each part (v0, b0, host output of that block), and one
        event per part (None on CPU tensors)."""
        from ..parallel.mesh import apply_per_entry

        rows = batch[0].rows
        s = rows.shape[1]
        dp, sp = mesh.shape["dp"], mesh.shape["sp"]
        w_pad = self._pad_width(max(j.width for j in batch), sp)
        v_pad = -(-len(batch) // dp) * dp
        parts = []

        def fill(dev, v0, v1, b0, b1):
            with _STAGE_BUILD.time():
                # padding entries and columns past a job's width stay
                # unset: their outputs are never delivered
                block = torch.empty((v1 - v0, s, b1 - b0),
                                    dtype=torch.uint8, device=dev)
                for vi in range(v0, min(v1, len(batch))):
                    j = batch[vi]
                    cols = min(b1, j.width) - b0
                    if cols <= 0:
                        continue
                    dst = block[vi - v0, :, :cols]
                    if isinstance(j.data, np.ndarray):
                        dst.copy_(torch.from_numpy(j.data[:, b0:b0 + cols]),
                                  non_blocking=True)
                        continue
                    for ri, row in enumerate(j.data):
                        dst[ri].copy_(torch.from_numpy(row[b0:b0 + cols]),
                                      non_blocking=True)
            return block

        def take(v0, b0, y):
            host = torch.empty(y.shape, dtype=torch.uint8,
                               pin_memory=self._on_card)
            host.copy_(y, non_blocking=True)
            parts.append((v0, b0, host))

        with _STAGE_COMPUTE.time():
            events = apply_per_entry(mesh, rows, v_pad, w_pad, fill, take)
        return parts, (events if self._on_card else None)

    def _complete_device(self, batch: list[_Job], handle) -> None:
        try:
            out, done = handle
            with _STAGE_READBACK.time():  # blocks until compute + D2H done
                if isinstance(done, list):
                    for event in done:
                        event.synchronize()
                elif done is not None:
                    done.synchronize()
                if isinstance(out, list):  # a mesh's parts
                    self._deliver_parts(batch, out)
                    return
                host = out.numpy()
            for vi, j in enumerate(batch):
                self._deliver(j, host[vi, :, :j.width])
        except Exception as e:
            for j in batch:
                self._fail(j, e)

    def _deliver_parts(self, batch: list[_Job], parts) -> None:
        """Each job's row blocks from the mesh entries that hold its
        volume, joined along the columns in column order."""
        pieces: dict[int, list] = {}
        for v0, b0, host in sorted(parts, key=lambda p: p[1]):
            h = host.numpy()
            for vi in range(v0, min(v0 + h.shape[0], len(batch))):
                pieces.setdefault(vi, []).append(h[vi - v0])
        for vi, j in enumerate(batch):
            cols = pieces[vi]
            res = cols[0] if len(cols) == 1 else np.concatenate(cols, axis=1)
            self._deliver(j, res[:, :j.width])


# ---------------------------------------------------------------------------
# Process-wide singletons: every caller of the same backend shares one
# queue, which is the whole point — concurrency ACROSS volumes is what
# the scheduler turns into batch occupancy.
# ---------------------------------------------------------------------------

_SERVICES: dict[str, CodecService] = {}
_SERVICES_LOCK = threading.Lock()


def enabled() -> bool:
    return os.environ.get("SEAWEEDFS_TPU_EC_SERVICE", "1").lower() not in (
        "0", "false", "off", "no")


def get_service(codec_name: str = "cuda") -> "CodecService | None":
    """The shared service for a codec backend, or None when disabled."""
    if not enabled():
        return None
    key = "device" if codec_name in _DEVICE_CODECS else "host"
    with _SERVICES_LOCK:
        svc = _SERVICES.get(key)
        if svc is None or svc.closed:
            svc = CodecService(mode="auto", codec_name=(
                codec_name if key == "device" else "cpu"))
            _SERVICES[key] = svc
        return svc


def service_for_codec(codec_name: str) -> "CodecService | None":
    """Default routing for the bulk encode/rebuild pipelines: the ``cuda``
    codec goes through the shared service ONLY when the fast probe
    confirms a reachable card (otherwise the direct paths keep their
    tested dispatch).  The service runs the batched bit-sliced kernel, so
    the other device codecs (``cuda_xor``, ``cuda_bitplane``) keep their
    direct route, where their own kernel runs.  Callers that KNOW they
    are concurrent pass an explicit service instead."""
    if not enabled() or codec_name != "cuda":
        return None
    if not device_probe.probe().accelerator:
        return None
    return get_service(codec_name)


def service_for_degraded() -> "CodecService | None":
    """Host-mode service for per-needle degraded reads (which must never
    pay a device dispatch).  Opt-in: a lone read pays one extra thread
    hop, so this is for hosts expecting degraded-read storms."""
    if not enabled():
        return None
    if os.environ.get(
            "SEAWEEDFS_TPU_EC_SERVICE_DEGRADED", "0").lower() in (
            "0", "false", "off", "no"):
        return None
    return get_service("cpu")


def shutdown_all(timeout: "float | None" = 30.0) -> None:
    """Drain and close every shared service (server shutdown, tests).
    Safe to call repeatedly; a later get_service starts a fresh one."""
    with _SERVICES_LOCK:
        svcs = list(_SERVICES.values())
        _SERVICES.clear()
    for svc in svcs:
        svc.close(timeout)
