"""The port's native library (CRC32-C and the GF(2^8) SIMD host codec) held
against the reference's, and the port's CRC32-C against its plain numpy
version.

The port builds its own copy of seaweed_native.cc with g++ into
seaweedfs_tpu_torch/_build/ under a name keyed by source, flags and CPU;
the reference's library is loaded here only to compare with.  Inputs are
seeded; every comparison is byte equality.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from seaweedfs_tpu.native import lib as ref_native
from seaweedfs_tpu.ops import crc32c as ref_crc
from seaweedfs_tpu.ops import gf256 as jgf
from seaweedfs_tpu_torch.native import build as port_build
from seaweedfs_tpu_torch.native import lib as native
from seaweedfs_tpu_torch.ops import crc32c, gf256
from seaweedfs_tpu_torch.ops.rs_cpu import ReedSolomon

from torch_threads import one_torch_thread  # noqa: F401

WIDTHS = (0, 1, 31, 32, 33, 64, 4096 + 7)


def _ref_available():
    if not ref_native.available():
        pytest.skip("the reference's native library does not build here")


def test_port_library_builds_into_its_own_build_dir():
    path = port_build.build()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(port_build.__file__)))
    assert os.path.dirname(path) == os.path.join(pkg, "_build")
    name = os.path.basename(path)
    assert name.startswith("libseaweed_native-") and name.endswith(".so")
    assert path == port_build.library_path()
    assert "seaweedfs_tpu/native" not in path.replace(os.sep, "/")
    # the key covers the source, flags and CPU: the same inputs, one name
    assert port_build.build() == path


@pytest.mark.parametrize("width", WIDTHS)
def test_crc32c_equals_reference_native_and_plain(width):
    _ref_available()
    rng = np.random.default_rng(width)
    for _ in range(5):
        data = rng.integers(0, 256, width, dtype=np.uint8).tobytes()
        seed = int(rng.integers(0, 2**32))
        want = ref_native.crc32c_update(seed, data)
        assert crc32c.update(seed, data) == want
        assert crc32c.reference_update(seed, data) == want
        assert ref_crc.update(seed, data) == want
        # buffers of every kind, without copies
        arr = np.frombuffer(data, dtype=np.uint8)
        assert crc32c.update(seed, arr) == want
        assert crc32c.update(seed, memoryview(data)) == want
        assert crc32c.update(seed, bytearray(data)) == want


def test_crc32c_masked():
    # crc32c("123456789") = 0xE3069283 (the Castagnoli check value)
    assert crc32c.checksum(b"123456789") == 0xE3069283
    assert crc32c.update(crc32c.update(0, b"1234"), b"56789") == 0xE3069283
    assert crc32c.mask(0xE3069283) == (
        (((0xE3069283 >> 15) | (0xE3069283 << 17)) & 0xFFFFFFFF) + 0xA282EAD8
    ) & 0xFFFFFFFF
    assert crc32c.checksum(b"") == 0
    rng = np.random.default_rng(4)
    for c in rng.integers(0, 2**32, 50):
        c = int(c)
        assert crc32c.mask(c) == ref_crc.mask(c)
        assert crc32c.unmask(crc32c.mask(c)) == c == ref_crc.unmask(ref_crc.mask(c))
    data = rng.integers(0, 256, 999, dtype=np.uint8).tobytes()
    assert crc32c.value(data) == ref_crc.value(data)


def _plans():
    """Parity rows, decode plans of several loss sets, and matrices of
    arbitrary coefficients and shapes."""
    rng = np.random.default_rng(9)
    full = gf256.rs_matrix(10, 14)
    yield "parity", gf256.rs_parity_matrix(10, 4)
    for lost in ((0,), (0, 1, 2, 3), (2, 5, 11, 13), (10, 11, 12, 13)):
        present = [i for i in range(14) if i not in lost]
        yield f"plan{lost}", gf256.decode_plan_for(full, 10, present, lost)
    for r, s in ((1, 1), (3, 7), (14, 14), (4, 10)):
        m = rng.integers(0, 256, (r, s), dtype=np.uint8)
        m[0, 0] = 0  # zero and one coefficients take their own paths
        m[-1, -1] = 1
        yield f"random{r}x{s}", m
    yield "zero-row", np.zeros((2, 5), dtype=np.uint8)


@pytest.mark.parametrize("width", WIDTHS)
def test_gf_apply_equals_reference_native(width):
    _ref_available()
    rng = np.random.default_rng(100 + width)
    for name, m in _plans():
        s = m.shape[1]
        inputs = [rng.integers(0, 256, width, dtype=np.uint8) for _ in range(s)]
        want = ref_native.gf_apply_arrays(m, inputs)
        got = native.gf_apply_arrays(m, inputs)
        for a, b in zip(got, want):
            assert np.array_equal(a, b), (name, width)
        # and the plain GF product of the shared tables
        plain = jgf.mat_mul(np.asarray(m), np.stack(inputs)) if width else None
        if plain is not None:
            assert np.array_equal(np.stack(got), plain), name


def test_native_cpp_agrees_if_available():
    """The counterpart of test_rs_codec.py's: the library's parity of a
    seeded stripe equals the reference's host codec."""
    from seaweedfs_tpu.ops.rs_cpu import ReedSolomon as RefRS

    rng = np.random.default_rng(12)
    shards = [rng.integers(0, 256, 1000, dtype=np.uint8) for _ in range(10)]
    shards += [np.zeros(1000, dtype=np.uint8) for _ in range(4)]
    RefRS().encode(shards)
    m = gf256.rs_parity_matrix(10, 4)
    outs = native.gf_apply_arrays(m, shards[:10])
    for i in range(4):
        assert outs[i].tobytes() == shards[10 + i].tobytes()


def test_native_codec_uses_simd_on_this_host():
    """The GF codec engages the best SIMD path the host has: a silently
    scalar build costs ~4x its rate."""
    tier = native.simd_tier()
    flags = port_build._cpu_flags().split()
    if "gfni" in flags and "avx512bw" in flags and "avx512f" in flags:
        assert tier == 3
    elif "ssse3" in flags:
        assert tier == 1


def test_gf_apply_validates():
    m = gf256.rs_parity_matrix(10, 4)
    rows = [np.zeros(8, np.uint8)] * 10
    with pytest.raises(ValueError):
        native.gf_apply_arrays(m, rows[:9])
    with pytest.raises(ValueError):
        native.gf_apply_arrays(m, rows[:9] + [np.zeros(7, np.uint8)])
    with pytest.raises(ValueError):  # an output of the wrong length
        native.gf_apply_arrays(m, rows, out=[np.zeros(7, np.uint8)] * 4)
    with pytest.raises(ValueError):
        ReedSolomon().parity_into(rows, [np.zeros(7, np.uint8)] * 4)
