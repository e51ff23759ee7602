"""Build the native library with g++ at first use.

One translation unit, `seaweed_native.cc`, compiled into
`seaweedfs_tpu_torch/_build/libseaweed_native-<hash>.so`.  The hash covers
the source, the compiler flags and this host's CPU flags: a changed source,
or a tree copied to a machine with another CPU, builds anew under its own
file name (ctypes returns the library already loaded for a path it has
seen, so a rebuild must never reuse one).  The build is written to a
temporary file and renamed, so concurrent processes never load a half
written library.  It never reads or writes the reference package's
library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "seaweed_native.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-march=native")


def _cpu_flags() -> str:
    """The `flags` line of /proc/cpuinfo ("" where there is none): part of
    the build key, because -march=native code may not run elsewhere."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def library_path() -> str:
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update(_cpu_flags().encode())
    return os.path.join(BUILD_DIR, f"libseaweed_native-{h.hexdigest()[:16]}.so")


def _portable_flags() -> list[str]:
    flags = _cpu_flags().split()
    extra = [f for f, name in (("-mssse3", "ssse3"), ("-msse4.2", "sse4_2"))
             if name in flags]
    return ["-O2", "-shared", "-fPIC", "-std=c++17", *extra]


def build() -> str:
    """Compile the library unless this host's build exists; -> its path.
    Raises with g++'s output when neither the native nor the portable
    build compiles."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, SRC, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            # a portable build works, but say so: a scalar GF codec costs
            # ~4x its SIMD rate
            print("seaweedfs_tpu_torch native: -march=native build failed, "
                  f"building without it: {proc.stderr[-300:]!r}",
                  file=sys.stderr)
            proc = subprocess.run(["g++", *_portable_flags(), SRC, "-o", tmp],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed ({proc.returncode}) building {SRC}:\n"
                    f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


if __name__ == "__main__":
    print(build())
