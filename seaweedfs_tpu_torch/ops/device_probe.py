"""Fast accelerator-reachability probe with a hard deadline — the port of
seaweedfs_tpu/ops/device_probe.py.

One question, answered in seconds and cached for the process lifetime:
*can this host's torch move bytes through a CUDA card right now?*  The
codec service's mode pick (`auto`) and the default routing of the EC file
pipelines (`codec_service.service_for_codec`) ask here, so a card that
hangs degrades the caller to the host path in
``SEAWEEDFS_TPU_PROBE_TIMEOUT_S`` (default 30s) instead of hanging it.
The deadline is the reference's 10s raised: a fresh process that imports
torch and opens a CUDA context takes 7-9s to reach an H100, so 10s would
let a busy host flip the routing to the host path.

The check runs in a KILLABLE subprocess: a hung call into the card cannot be
interrupted from a thread.  The child does a real host->device->host round
trip of a small tensor, not just a device count — a card that enumerates
but cannot move bytes counts as unreachable.  Without a card the child does
the same round trip on the CPU and reports platform ``cpu``: the probe is
then ``ok`` but finds no ``accelerator``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass

DEFAULT_TIMEOUT_S = 30.0

# the child prints ONE json line after the round trip; anything else
# (hang, crash, failed CUDA init) is a failed probe
_CHILD_CODE = r"""
import json
import torch
if torch.cuda.is_available():
    n, platform = torch.cuda.device_count(), 'cuda'
    x = torch.ones((8, 128), device=torch.device('cuda', 0))
else:
    n, platform = 1, 'cpu'
    x = torch.ones((8, 128))
got = float((x + 1).cpu().sum())  # round trip, not just init
if got != 2.0 * 8 * 128:
    raise SystemExit(f'round trip returned {got}')
print(json.dumps({'devices': n, 'platform': platform}))
"""


@dataclass(frozen=True)
class ProbeResult:
    ok: bool
    devices: int = 0
    platform: str = ""
    seconds: float = 0.0
    error: str = ""

    @property
    def accelerator(self) -> bool:
        """True when a CUDA card answered the round trip — the gate for
        dispatching bulk GF work to the device."""
        return self.ok and self.platform == "cuda"

    def to_json(self) -> dict:
        out: dict = {"devices": self.devices, "platform": self.platform,
                     "probe_seconds": round(self.seconds, 2)}
        if not self.ok:
            out["error"] = self.error or "probe failed"
        return out


_LOCK = threading.Lock()
_CACHED: ProbeResult | None = None


def probe_timeout_s() -> float:
    try:
        return float(os.environ.get(
            "SEAWEEDFS_TPU_PROBE_TIMEOUT_S", str(DEFAULT_TIMEOUT_S)))
    except ValueError:
        return DEFAULT_TIMEOUT_S


def _run_probe(timeout_s: float) -> ProbeResult:
    import subprocess
    import sys

    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD_CODE], capture_output=True,
            text=True, timeout=timeout_s,
        )
    except subprocess.TimeoutExpired:
        return ProbeResult(
            ok=False, seconds=time.perf_counter() - t0,
            error=f"device probe timed out after {timeout_s:.0f}s")
    except Exception as exc:  # fork failure, odd embedding — never raise
        return ProbeResult(
            ok=False, seconds=time.perf_counter() - t0,
            error=f"{type(exc).__name__}: {exc}"[:300])
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout or "").strip().splitlines()
        return ProbeResult(
            ok=False, seconds=dt,
            error=(tail[-1] if tail else f"probe rc={proc.returncode}")[:300])
    parsed = None
    for line in reversed((proc.stdout or "").strip().splitlines()):
        try:
            parsed = json.loads(line)
            break
        except (json.JSONDecodeError, ValueError):
            continue
    if not isinstance(parsed, dict) or "devices" not in parsed:
        return ProbeResult(ok=False, seconds=dt,
                           error="probe emitted no device report")
    devices = int(parsed["devices"])
    return ProbeResult(
        ok=devices >= 1, devices=devices,
        platform=str(parsed.get("platform", "")), seconds=dt,
        error="" if devices >= 1 else "no devices",
    )


def probe(timeout_s: float | None = None, refresh: bool = False) -> ProbeResult:
    """Cached reachability verdict; the subprocess runs at most once per
    process (per explicit ``refresh``).  ``timeout_s`` overrides the env
    knob for this call only — it has no effect on a cache hit."""
    global _CACHED
    if not refresh:
        cached = _CACHED
        if cached is not None:
            return cached
    with _LOCK:
        if not refresh and _CACHED is not None:
            return _CACHED
        result = _run_probe(
            probe_timeout_s() if timeout_s is None else timeout_s)
        _CACHED = result
        return result


def reset_cache() -> None:
    """Forget the cached verdict (tests; long-lived admin shells)."""
    global _CACHED
    with _LOCK:
        _CACHED = None
