"""glog-style leveled logging: I/W/E lines with V-levels and rotation —
the port's copy of seaweedfs_tpu/util/glog.py.

Reference: weed/glog/glog.go:71 — `glog.V(n)` gates verbose logs on the
process-wide verbosity; Info/Warning/Error always emit.  Format:
`I0729 10:32:01.123456 module.py:42] message`.

Usage:
    from seaweedfs_tpu_torch.util import glog
    glog.info("volume %d mounted", vid)
    if glog.V(2): glog.info("per-read detail ...")
    glog.set_verbosity(3)
"""

from __future__ import annotations

import io
import os
import sys
import threading
import time

_LEVEL_CHAR = {"info": "I", "warning": "W", "error": "E", "fatal": "F"}

_state = threading.local()
_lock = threading.Lock()
_verbosity = int(os.environ.get("SEAWEEDFS_TPU_V", "0"))
_sink = sys.stderr
_max_bytes = 0  # 0 = no rotation
_log_path: str | None = None
_written = 0
# optional per-line context (e.g. the active trace id) resolved at emit
# time from a thread-local; none is installed until the servers are ported
_context_fn = None


def set_context_provider(fn) -> None:
    """Install a zero-arg callable whose non-None return value is stamped
    into every log line as `trace=<value>` (the log<->trace join key)."""
    global _context_fn
    _context_fn = fn


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = int(v)


def V(level: int) -> bool:
    """True when verbose logs at this level should emit."""
    return _verbosity >= level


def set_output(path_or_file, max_bytes: int = 64 << 20) -> None:
    """Log to a file (rotating at max_bytes, like glog MaxSize) or stream."""
    global _sink, _log_path, _max_bytes, _written
    with _lock:
        if isinstance(path_or_file, str):
            _log_path = path_or_file
            _max_bytes = max_bytes
            _sink = open(path_or_file, "a", buffering=1)
            _written = _sink.tell()
        else:
            _log_path = None
            _max_bytes = 0
            _sink = path_or_file


def _emit(level: str, fmt: str, *args) -> None:
    global _sink, _written
    msg = (fmt % args) if args else fmt
    frame = sys._getframe(2)
    where = f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
    now = time.time()
    stamp = time.strftime("%m%d %H:%M:%S", time.localtime(now))
    micros = int((now % 1) * 1e6)
    ctx = ""
    if _context_fn is not None:
        try:
            val = _context_fn()
        except Exception:
            val = None
        if val:
            ctx = f" trace={val}"
    line = f"{_LEVEL_CHAR[level]}{stamp}.{micros:06d} {where}{ctx}] {msg}\n"
    with _lock:
        try:
            _sink.write(line)
            _written += len(line)
            if _max_bytes and _log_path and _written >= _max_bytes:
                # rotate atomically from the logger's view: whatever
                # happens to os.replace, _sink ends up an OPEN handle on
                # _log_path.  (Previously a failed replace left _sink
                # closed and every later log was silently dropped.)
                _sink.close()
                try:
                    os.replace(_log_path, _log_path + ".1")
                finally:
                    _sink = open(_log_path, "a", buffering=1)
                    _written = _sink.tell()
        except (OSError, ValueError, io.UnsupportedOperation):
            pass


def info(fmt: str, *args) -> None:
    _emit("info", fmt, *args)


def warning(fmt: str, *args) -> None:
    _emit("warning", fmt, *args)


def error(fmt: str, *args) -> None:
    _emit("error", fmt, *args)


def flush() -> None:
    """Flush the active sink; never raises (a dead sink is not fatal)."""
    with _lock:
        try:
            _sink.flush()
        except (OSError, ValueError, io.UnsupportedOperation):
            pass


def fatal(fmt: str, *args) -> None:
    _emit("fatal", fmt, *args)
    # the process is about to exit: make sure the F line hits the disk
    # before SystemExit unwinds (a block-buffered file sink would
    # otherwise lose the one line that explains the death)
    flush()
    raise SystemExit(1)
