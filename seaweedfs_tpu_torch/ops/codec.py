"""Codec registry — the port's counterpart of seaweedfs_tpu/ops/codec.py, the
`-ec.codec` switch.

Names:
  * ``cuda``: the RS codec on the card, through the hand-written
    bit-sliced kernel (ReedSolomonTorch on device "cuda");
  * ``cuda_xor`` and ``cuda_bitplane``: the same codec through the other
    two kernels, the XOR network of the doubling chain and the bit-plane
    route (impl ``xor`` and ``bitplane``): the counterparts of the
    reference's ``jax``/``tpu_xor`` and ``tpu_mxu``/``mxu``, with the
    ``cuda`` name's rule (no card, an error);
  * ``cpu``: the host codec on the native SIMD library (rs_cpu.ReedSolomon),
    for per-needle work where a launch would dominate the latency;
  * ``torch_cpu``: ReedSolomonTorch on the host, through the kernel's plain
    PyTorch version (tests, and a check of the kernel's design);
  * ``auto``: whichever of ``cuda`` and ``cpu`` wins a timed round trip on
    this host (`_resolve_auto`), chosen once per process.

Every codec comes wrapped in `InstrumentedCodec`, so each blocking call
records ``seaweedfs_ec_op_seconds{op,impl}`` and ``seaweedfs_ec_op_bytes``
with the backend that did the GF work, and a span inside an active trace.

``get_codec("cuda")`` raises when no card is usable: nothing falls back
silently.  ``effective_codec("cuda")`` answers ``("cpu", reason)`` when the
device probe finds no card, a decision its caller logs (the reference's
``get_codec`` makes that switch itself; ROADMAP §C).
"""

from __future__ import annotations

import time

from ..stats.metrics import EC_BYTES_HISTOGRAM, EC_OP_HISTOGRAM
from ..telemetry import trace
from .rs_cpu import ReedSolomon
from .rs_torch import ReedSolomonTorch

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS

# torch codec name -> its device, and its kernel (rs_torch.IMPLS) where
# that is not the bit-sliced one
_TORCH_DEVICES = {"cuda": "cuda", "cuda_xor": "cuda", "cuda_bitplane": "cuda",
                  "torch_cpu": "cpu"}
_TORCH_IMPLS = {"cuda_xor": "xor", "cuda_bitplane": "bitplane"}
# every name get_codec resolves to a codec on the card — the single source
# of truth shared with ops.codec_service's mode and routing logic
DEVICE_CODEC_NAMES = frozenset(
    name for name, dev in _TORCH_DEVICES.items() if dev == "cuda")


def _nbytes(x) -> int:
    if x is None:
        return 0
    n = getattr(x, "nbytes", None)
    if n is not None:
        return int(n)
    try:
        return len(x)
    except TypeError:
        return 0


def _arg_bytes(arg) -> int:
    if isinstance(arg, (list, tuple)):
        return sum(_nbytes(s) for s in arg)
    return _nbytes(arg)


class InstrumentedCodec:
    """Transparent telemetry proxy over a codec.

    Delegates every attribute; times only the BLOCKING operations.  The
    device-resident entries (`encode_device`, `apply_rows_device`) return
    tensors whose work may still run on the card, so their wall time at
    the call is not the compute time and they pass through untimed."""

    _TIMED = frozenset({
        "encode", "parity_of", "parity_into", "apply_rows",
        "reconstruct", "reconstruct_data", "reconstruct_one", "verify",
    })

    def __init__(self, inner, impl: str):
        self._inner = inner
        self._impl = impl

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name not in self._TIMED or not callable(attr):
            return attr
        impl = self._impl
        # children and span name resolved once per (op, impl)
        op_hist = EC_OP_HISTOGRAM.labels(name, impl)
        bytes_hist = EC_BYTES_HISTOGRAM.labels(name, impl)
        span_name = f"ec.{name}"
        child_span = trace.child_span
        perf_counter = time.perf_counter

        def timed(*args, **kwargs):
            # max over the first two args: apply_rows leads with the small
            # plan matrix, every other op with the shard payload
            nbytes = max(
                (_arg_bytes(a) for a in args[:2]), default=0) if args else 0
            t0 = perf_counter()
            try:
                # metrics always; a span only inside an active trace
                with child_span(span_name, impl=impl, bytes=nbytes):
                    return attr(*args, **kwargs)
            finally:
                op_hist.observe(perf_counter() - t0)
                bytes_hist.observe(nbytes)

        timed.__name__ = name
        # cached on the instance: hot loops must not rebuild the closure
        self.__dict__[name] = timed
        return timed


def available_codecs() -> list[str]:
    """Codec names usable with ``get_codec`` on this host: the device
    codecs only where torch sees a card."""
    import torch

    names = ["auto", "cpu", "torch_cpu"]
    if not torch.cuda.is_available():
        return names
    return names + sorted(DEVICE_CODEC_NAMES)


def effective_codec(name: str) -> tuple[str, str]:
    """-> (the codec a caller should build for `name`, the reason when that
    is not `name`).  A device codec name answers ``cpu`` when the device
    probe (ops.device_probe, a hard deadline in seconds) finds no card
    that moves bytes; the reason is "" when no switch is made.  Unlike
    `get_codec`, this never raises for a missing card: the caller decides,
    and logs the reason."""
    if name not in DEVICE_CODEC_NAMES:
        return name, ""
    from . import device_probe

    pr = device_probe.probe()
    if pr.accelerator:
        return name, ""
    return "cpu", pr.error or f"no accelerator ({pr.platform or 'none'})"


_AUTO_CHOICE: list[str] = []
# the last _resolve_auto's measurements: seconds of the host codec and of
# the card's round trip on the same block (None where not measured)
AUTO_TIMES: dict = {}

_AUTO_CHILD = r"""
import sys, time
import numpy as np
import torch
if not torch.cuda.is_available():
    sys.exit(3)
from seaweedfs_tpu_torch.ops import gf256, rs_cuda
m = gf256.rs_parity_matrix({d}, {p})
block = np.zeros(({d}, {mb} << 20), dtype=np.uint8)
def round_trip():
    out = rs_cuda.gf_apply(m, torch.from_numpy(block).cuda()).cpu()
    torch.cuda.synchronize()
    return out
round_trip()  # builds the kernel, warms the context
t0 = time.perf_counter()
round_trip()
print('DT', time.perf_counter() - t0)
"""


def _resolve_auto(probe_mb: int = 4, timeout_s: float = 75.0) -> str:
    """Pick the codec that wins the disk-to-shards pipeline on THIS host.

    The encode moves every input byte host to card and 0.4x back, so the
    choice times one real round trip (H2D, the parity kernel, D2H) at
    `probe_mb` MiB per shard against the ``cpu`` codec on the same block,
    and is cached for the process.  The card's side runs in a KILLABLE
    subprocess with a hard deadline: a hung card must leave a server on the
    host codec, not hang it.  No card, a failed probe or a timeout answer
    ``cpu``.  The times land in AUTO_TIMES."""
    import os
    import subprocess
    import sys

    import numpy as np

    from . import device_probe

    AUTO_TIMES.clear()
    AUTO_TIMES.update({"probe_mb": probe_mb, "cpu_s": None, "cuda_s": None})
    pr = device_probe.probe()
    if not pr.accelerator:
        AUTO_TIMES["choice"] = "cpu"
        AUTO_TIMES["reason"] = pr.error or "no accelerator"
        return "cpu"
    block = np.zeros((DATA_SHARDS, probe_mb << 20), dtype=np.uint8)
    cpu = ReedSolomon(DATA_SHARDS, PARITY_SHARDS)
    cpu.parity_of(block)  # warm
    t0 = time.perf_counter()
    cpu.parity_of(block)
    cpu_dt = time.perf_counter() - t0
    AUTO_TIMES["cpu_s"] = cpu_dt
    code = _AUTO_CHILD.format(d=DATA_SHARDS, p=PARITY_SHARDS, mb=probe_mb)
    env = dict(os.environ)
    # the child resolves this package as the parent did
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p] + [env.get("PYTHONPATH", "")]
    ).rstrip(os.pathsep)
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=timeout_s, env=env)
    except Exception as e:  # a hung card, a fork failure: the host codec
        AUTO_TIMES["choice"] = "cpu"
        AUTO_TIMES["reason"] = f"{type(e).__name__}: {e}"[:300]
        return "cpu"
    cuda_dt = None
    for line in proc.stdout.splitlines():
        if line.startswith("DT "):
            cuda_dt = float(line.split()[1])
    if proc.returncode != 0 or cuda_dt is None:
        tail = (proc.stderr or "").strip().splitlines()
        AUTO_TIMES["choice"] = "cpu"
        AUTO_TIMES["reason"] = (tail[-1] if tail
                                else f"rc={proc.returncode}")[:300]
        return "cpu"
    AUTO_TIMES["cuda_s"] = cuda_dt
    choice = "cuda" if cuda_dt < cpu_dt else "cpu"
    AUTO_TIMES["choice"] = choice
    return choice


def resolve_codec_name(name: str) -> str:
    """The concrete codec `name` stands for: ``auto`` becomes the choice
    `_resolve_auto` made for this process (made on the first call), every
    other name itself."""
    if name != "auto":
        return name
    if not _AUTO_CHOICE:
        _AUTO_CHOICE.append(_resolve_auto())
    return _AUTO_CHOICE[0]


def get_codec(name: str = "cuda", data_shards: int = DATA_SHARDS,
              parity_shards: int = PARITY_SHARDS) -> InstrumentedCodec:
    """Return a codec with encode/reconstruct/reconstruct_data/verify,
    wrapped in InstrumentedCodec.  A device codec raises without a usable
    card."""
    name = resolve_codec_name(name)
    if name == "cpu":
        return InstrumentedCodec(ReedSolomon(data_shards, parity_shards), "cpu")
    if name not in _TORCH_DEVICES:
        raise ValueError(
            f"unknown ec codec {name!r}; known: auto, cpu, "
            f"{', '.join(_TORCH_DEVICES)}")
    return InstrumentedCodec(
        ReedSolomonTorch(data_shards, parity_shards,
                         device=_TORCH_DEVICES[name],
                         impl=_TORCH_IMPLS.get(name, "bitslice")), name)
