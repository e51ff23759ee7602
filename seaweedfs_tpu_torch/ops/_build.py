"""Build the package's CUDA code at first use.

Two kinds of build, both into `seaweedfs_tpu_torch/_build/`:

* `load(name)`: `csrc/<name>.cu` compiles with nvcc into a shared library
  with a plain C interface, `lib<name>-<hash>.so`, loaded with ctypes.  The
  hash covers the source and the flags: a changed source builds anew, an
  unchanged one loads the library an earlier process built.  No PyTorch
  headers are involved, so a build takes seconds.  The host side of the
  GF(2^8) kernels, `csrc/gf_launch.cu`, is built this way.

* `compile_cubin(source, key)`: one generated kernel source (a template
  of `csrc/` with a matrix's XOR network spliced in, see gf_network.py)
  compiles with NVRTC, the CUDA toolkit's runtime compiler (libnvrtc, beside
  nvcc), called in process through ctypes, into an sm_90a cubin,
  `<key[:16]>.cubin`, where `key` is the sha256 of template, generated
  block and flags.  A later call with the same key reads the cubin from
  disk; a new matrix or an edited template compiles anew.  NVRTC rather
  than nvcc because a kernel is built per matrix at its first use, inside
  the flow that needs it: the compile runs in this process, releases the
  GIL, and starts no compiler driver.  This is the one route: there is no
  fallback to nvcc or to another kernel.

A failed build raises with the compiler's log.  STATS counts compiles and
disk hits; COMPILE_SECONDS holds each compile's seconds by key.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
NVRTC_FLAGS = ("--gpu-architecture=sm_90a", "-std=c++17",
               "--ptxas-options=-v")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
_NVRTC: "ctypes.CDLL | None" = None
STATS = {"compiles": 0, "disk_hits": 0}
COMPILE_SECONDS: dict[str, float] = {}
COMPILE_LOGS: dict[str, str] = {}  # NVRTC's log (ptxas -v) by key


def cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else the toolkit's default prefix, else PATH."""
    cand = os.path.join(cuda_home(), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels need the "
            "CUDA toolkit to build")
    return found


def nvrtc_path() -> str:
    """libnvrtc of the toolkit that holds nvcc, else the loader's."""
    home = cuda_home()
    for pattern in ("lib64/libnvrtc.so", "lib64/libnvrtc.so.*",
                    "targets/*/lib/libnvrtc.so", "targets/*/lib/libnvrtc.so.*"):
        found = sorted(p for p in glob.glob(os.path.join(home, pattern))
                       if "builtins" not in p and "alt" not in p)
        if found:
            return found[0]
    found = ctypes.util.find_library("nvrtc")
    if found is None:
        raise RuntimeError("libnvrtc not found (set CUDA_HOME); the GF(2^8) "
                           "kernels are compiled with NVRTC")
    return found


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _replace_atomically(out: str, write) -> None:
    """Call write(tmp_path), then move tmp over `out`: concurrent builders
    race harmlessly."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=os.path.splitext(out)[1], dir=BUILD_DIR)
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library is already built; -> path."""
    out = library_path(name)
    if os.path.exists(out):
        return out

    def write(tmp: str) -> None:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    _replace_atomically(out, write)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LOADED[name] = lib
        return lib


def _nvrtc() -> ctypes.CDLL:
    global _NVRTC
    with _LOCK:
        if _NVRTC is None:
            lib = ctypes.CDLL(nvrtc_path())
            p, c, i = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
            pp = ctypes.POINTER(ctypes.c_void_p)
            sz = ctypes.POINTER(ctypes.c_size_t)
            for fn, args in (
                    ("nvrtcCreateProgram", [pp, c, c, i, p, p]),
                    ("nvrtcCompileProgram", [p, i, ctypes.POINTER(c)]),
                    ("nvrtcGetProgramLogSize", [p, sz]),
                    ("nvrtcGetProgramLog", [p, c]),
                    ("nvrtcGetCUBINSize", [p, sz]),
                    ("nvrtcGetCUBIN", [p, c]),
                    ("nvrtcDestroyProgram", [pp])):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = i
            lib.nvrtcGetErrorString.argtypes = [i]
            lib.nvrtcGetErrorString.restype = c
            _NVRTC = lib
        return _NVRTC


def _nvrtc_compile(source: str, name: str) -> tuple[bytes, str]:
    """-> (cubin, log) for one source; raises with the log on failure."""
    lib = _nvrtc()

    def check(rc: int, what: str, log: str = "") -> None:
        if rc != 0:
            msg = lib.nvrtcGetErrorString(rc).decode()
            raise RuntimeError(f"NVRTC {what} failed ({rc}: {msg}) for "
                               f"{name}:\n{log}")
    prog = ctypes.c_void_p()
    check(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                 name.encode(), 0, None, None), "create")
    try:
        opts = (ctypes.c_char_p * len(NVRTC_FLAGS))(
            *[f.encode() for f in NVRTC_FLAGS])
        rc = lib.nvrtcCompileProgram(prog, len(NVRTC_FLAGS), opts)
        n = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(n))
        buf = ctypes.create_string_buffer(n.value)
        lib.nvrtcGetProgramLog(prog, buf)
        log = buf.value.decode(errors="replace")
        check(rc, "compile", log)
        check(lib.nvrtcGetCUBINSize(prog, ctypes.byref(n)), "cubin size")
        cubin = ctypes.create_string_buffer(n.value)
        check(lib.nvrtcGetCUBIN(prog, cubin), "cubin")
        return cubin.raw, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def cubin_path(key: str) -> str:
    return os.path.join(BUILD_DIR, f"{key[:16]}.cubin")


def compile_cubin(source: str, key: str, name: str) -> bytes:
    """The sm_90a cubin of `source`, whose cache key is `key`: read from
    disk if an earlier call compiled it, else compiled with NVRTC now."""
    out = cubin_path(key)
    if os.path.exists(out):
        with open(out, "rb") as f:
            image = f.read()
        with _LOCK:
            STATS["disk_hits"] += 1
        return image
    t0 = time.perf_counter()
    image, log = _nvrtc_compile(source, name)
    seconds = time.perf_counter() - t0

    def write(tmp: str) -> None:
        with open(tmp, "wb") as f:
            f.write(image)
    _replace_atomically(out, write)
    with _LOCK:
        STATS["compiles"] += 1
        COMPILE_SECONDS[key] = seconds
        COMPILE_LOGS[key] = log
    return image

