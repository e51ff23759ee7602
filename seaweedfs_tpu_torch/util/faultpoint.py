"""Named fault-injection points for chaos testing the cluster — the port's
copy of seaweedfs_tpu/util/faultpoint.py.

Code paths that talk across processes register a named point and call
``inject(name, ctx=...)`` at the top of the risky section.  Points are
inert (one dict lookup) until armed, either

  * via the environment at process start:
      SEAWEEDFS_TPU_FAULTS="volume.http.get=error:3,filer.chunk.fetch=delay:0.5"
    (format: name=mode[:param][:count] — for `error`/`partial` the first
    param is the trigger count, for `delay` it's seconds with an optional
    second count param; no count means "until cleared"), or

  * at runtime through GET /debug/faults on any server's HTTP port (the
    reference's servers; the port's come with the volume-server slice):
      /debug/faults                      -> JSON state
      /debug/faults?set=NAME&mode=error&count=3&delay=0.5&match=HOSTPORT
      /debug/faults?clear=NAME           (or clear=all)

``match`` scopes a fault to injection sites whose context string contains
the substring — so a test harness running several volume servers in one
process can kill exactly one of them.

Modes:
  error    raise FaultInjected (an IOError) at the point
  delay    sleep `delay` seconds, then continue normally
  partial  truncate the data passing through the point to half length
           (models a partial write/read); without data, acts like error

Every firing increments seaweedfs_fault_injected_total{point} so chaos
runs can assert the fault actually fired and correlate injected faults
with the retry/breaker metrics they provoke.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

from ..stats.metrics import FAULT_COUNTER  # declared centrally for the lint
from . import glog

ENV_VAR = "SEAWEEDFS_TPU_FAULTS"
ENABLE_VAR = "SEAWEEDFS_TPU_FAULTS_ENABLED"
MODES = ("error", "delay", "partial")


def arming_enabled() -> bool:
    """Runtime (HTTP) arming is opt-in: fault points corrupt/deny real
    traffic, so a production server must not accept `?set=` from anyone
    with HTTP reach.  Enabled by the explicit flag, or implicitly when
    the process was already started with faults in its environment (a
    chaos run by definition)."""
    return bool(os.environ.get(ENABLE_VAR) or os.environ.get(ENV_VAR))


class FaultInjected(IOError):
    """An error deliberately injected at a fault point."""


@dataclass
class FaultSpec:
    mode: str
    delay: float = 0.0
    remaining: int = -1  # -1 = until cleared
    match: str = ""  # substring of the injection-site context, "" = all

    def to_dict(self) -> dict:
        return {
            "mode": self.mode,
            "delay": self.delay,
            "remaining": self.remaining,
            "match": self.match,
        }


class FaultRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._armed: dict[str, FaultSpec] = {}
        self._registered: set[str] = set()

    # -- declaration ------------------------------------------------------

    def register(self, name: str) -> str:
        """Declare a point (import time) so /debug/faults can list it."""
        with self._lock:
            self._registered.add(name)
        return name

    # -- arming -----------------------------------------------------------

    def set(self, name: str, mode: str, delay: float = 0.0,
            count: int = -1, match: str = "") -> None:
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r} (want {MODES})")
        with self._lock:
            self._registered.add(name)
            self._armed[name] = FaultSpec(mode, delay, count, match)
        glog.warning("fault point armed: %s mode=%s delay=%s count=%d match=%s",
                     name, mode, delay, count, match or "*")

    def clear(self, name: str | None = None) -> None:
        with self._lock:
            if name is None or name == "all":
                self._armed.clear()
            else:
                self._armed.pop(name, None)

    def load_env(self, value: str | None = None) -> None:
        """Parse the SEAWEEDFS_TPU_FAULTS format (see module docstring)."""
        value = os.environ.get(ENV_VAR, "") if value is None else value
        for item in value.split(","):
            item = item.strip()
            if not item or "=" not in item:
                continue
            name, _, spec = item.partition("=")
            parts = spec.split(":")
            mode = parts[0]
            delay, count = 0.0, -1
            try:
                if mode == "delay":
                    if len(parts) > 1:
                        delay = float(parts[1])
                    if len(parts) > 2:
                        count = int(parts[2])
                elif len(parts) > 1:
                    count = int(parts[1])
                self.set(name.strip(), mode, delay=delay, count=count)
            except ValueError as e:
                glog.error("bad %s entry %r: %s", ENV_VAR, item, e)

    # -- injection --------------------------------------------------------

    def inject(self, name: str, ctx: str = "",
               data: bytes | None = None) -> bytes | None:
        """Fire the point if armed; returns (possibly truncated) data."""
        if not self._armed:
            # fast path: hot-path call sites (every needle read/GET) must
            # not pay a lock round trip while no fault is armed; a bare
            # dict truthiness read is atomic under the GIL and arming is
            # always followed by the locked re-check below
            return data
        with self._lock:
            spec = self._armed.get(name)
            if spec is None:
                return data
            if spec.match and spec.match not in ctx:
                return data
            if spec.remaining == 0:
                return data
            if spec.remaining > 0:
                spec.remaining -= 1
        FAULT_COUNTER.labels(name).inc()
        glog.warning("fault injected at %s mode=%s ctx=%s",
                     name, spec.mode, ctx or "-")
        if spec.mode == "delay":
            time.sleep(spec.delay)
            return data
        if spec.mode == "partial" and data is not None:
            return data[: len(data) // 2]
        raise FaultInjected(f"injected fault at {name}")

    # -- introspection ----------------------------------------------------

    def state(self) -> dict:
        with self._lock:
            return {
                "armed": {n: s.to_dict() for n, s in self._armed.items()},
                "registered": sorted(self._registered),
            }


FAULTS = FaultRegistry()
FAULTS.load_env()

# module-level conveniences mirroring the registry API
register = FAULTS.register
inject = FAULTS.inject
set_fault = FAULTS.set
clear_fault = FAULTS.clear
fault_state = FAULTS.state


def handle_debug_request(query: dict) -> dict:
    """Apply a parsed /debug/faults query string; returns the new state.

    query is urllib.parse.parse_qs output.  Raises ValueError on a bad
    mode/number so the HTTP layer can answer 400, PermissionError when
    runtime arming is disabled (answer 403)."""
    if ("set" in query or "clear" in query) and not arming_enabled():
        raise PermissionError(
            f"fault arming disabled; start the process with {ENABLE_VAR}=1")
    if "set" in query:
        name = query["set"][0]
        mode = query.get("mode", ["error"])[0]
        delay = float(query.get("delay", ["0"])[0])
        count = int(query.get("count", ["-1"])[0])
        match = query.get("match", [""])[0]
        FAULTS.set(name, mode, delay=delay, count=count, match=match)
    if "clear" in query:
        FAULTS.clear(query["clear"][0])
    return FAULTS.state()
