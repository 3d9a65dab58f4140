"""Kernel D's geometry, plain version and core against the JAX K5 kernel.

``window_rows_plain`` is held against ``window_rows_pallas`` run in
interpret mode, ``window_rows_supported`` and ``pick_window_split``
against the JAX functions over a grid, and the kernel's per-chunk core
(``csrc/wft_window.cuh``, built with g++ and run over every output chunk)
against ``window_rows_plain``.  The CUDA kernel itself is held to
``window_rows_plain`` on the card by ``chip_smoke.py``.

Tolerance: every comparison is ``np.array_equal`` (tolerance 0).
"""

import ctypes
import itertools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.kernels import window_copy as jax_window_copy
from warmup_fir_filter_tpu.ops import streaming as jax_streaming
from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels import window_copy
from warmup_fir_filter_tpu_torch.ops import streaming

#: (channels, T, sub, g_windows): T == sub, one channel, the scan test's
#: (4, 16384) geometry, and a reduced form of the bench's 16-channel one.
GEOMETRIES = [(1, 128, 128, 1), (2, 256, 256, 1), (3, 1024, 256, 2),
              (4, 16384, 512, 16), (16, 4096, 1024, 4), (5, 1280, 128, 5)]


def _inputs(rng, channels, total):
    x = rng.integers(0, 256, size=(channels, total), dtype=np.uint8)
    carry = rng.integers(0, 256, size=(channels, 128), dtype=np.uint8)
    return x, carry


@pytest.mark.parametrize("channels,total,sub,g", GEOMETRIES)
def test_plain_matches_pallas_kernel(rng, channels, total, sub, g):
    x, carry = _inputs(rng, channels, total)
    got = window_copy.window_rows_plain(torch.from_numpy(x),
                                        torch.from_numpy(carry), sub, g)
    want = np.asarray(jax_window_copy.window_rows_pallas(x, carry, sub, g,
                                                         interpret=True))
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == (total // sub * channels, sub + 256)
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_rows_supported_matches_jax():
    for channels, total, sub, taps in itertools.product(
            (0, 1, 16), (128, 1000, 4096, 16384), (0, 100, 128, 512, 1024),
            (0, 1, 5, 129, 130)):
        assert (window_copy.window_rows_supported(channels, total, sub, taps)
                == jax_window_copy.window_rows_supported(channels, total, sub,
                                                         taps))


def test_pick_window_split_matches_jax():
    assert streaming.pick_window_split(16, 4_000_000, 5) == (16000, 10)
    assert jax_streaming.pick_window_split(16, 4_000_000, 5) == (16000, 10)
    for channels, width, taps in itertools.product(
            (1, 4, 16, 64), (1000, 16_384, 65_536, 262_144, 4_000_000),
            (1, 5, 129, 131)):
        assert (streaming.pick_window_split(channels, width, taps)
                == jax_streaming.pick_window_split(channels, width, taps)), \
            (channels, width, taps)


def test_wrapper_on_cpu_is_plain(rng):
    x, carry = _inputs(rng, 4, 2048)
    before = window_copy.window_rows.launches
    got = window_copy.window_rows(torch.from_numpy(x), torch.from_numpy(carry),
                                  512, 2)
    assert window_copy.window_rows.launches == before
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jax_window_copy.window_rows_pallas(x, carry, 512, 2,
                                                      interpret=True)))


def test_wrapper_rejects_bad_geometry(rng):
    x, carry = (torch.from_numpy(a) for a in _inputs(rng, 2, 1024))
    with pytest.raises(ValueError, match="sub="):
        window_copy.window_rows(x, carry, 100, 1)
    with pytest.raises(ValueError, match="sub="):
        window_copy.window_rows(x, carry, 384, 1)
    with pytest.raises(ValueError, match="g_windows"):
        window_copy.window_rows(x, carry, 256, 3)
    with pytest.raises(ValueError, match="carry_ext"):
        window_copy.window_rows(x, carry[:, :64], 256, 1)
    with pytest.raises(TypeError, match="uint8"):
        window_copy.window_rows(x.to(torch.int32), carry, 256, 1)
    with pytest.raises(ValueError, match="device"):
        window_copy.window_rows(x, carry.to("meta"), 256, 1)


_KERNEL_HARNESS = """
#include <cstdint>
#include <cstring>
#include "wft_window.cuh"
// window_copy.cu's kernel body, one 16-byte chunk at a time.
extern "C" void window_rows_host(const uint8_t* x, const uint8_t* carry,
                                 uint8_t* out, long long channels,
                                 long long total, long long sub) {
  const long long out_rows = total / sub * channels;
  const long long row_chunks = (sub + 256) / 16;
  for (long long row = 0; row < out_rows; ++row)
    for (long long k = 0; k < row_chunks; ++k) {
      const uint8_t* src = wft::window_chunk_source(x, carry, channels, total,
                                                    sub, row, k);
      uint8_t* dst = out + (row * row_chunks + k) * 16;
      if (src) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);
    }
}
"""


@pytest.fixture(scope="module")
def kernel_core(tmp_path_factory):
    """Kernel D's core (``csrc/wft_window.cuh``) built with g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("window_copy")
    (work / "harness.cpp").write_text(_KERNEL_HARNESS)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(_build.CSRC_DIR), "-o", str(work / "lib.so"),
                    str(work / "harness.cpp")], check=True, timeout=120)
    lib = ctypes.CDLL(str(work / "lib.so"))
    lib.window_rows_host.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] * 3

    def run(x: np.ndarray, carry: np.ndarray, sub: int) -> np.ndarray:
        channels, total = x.shape
        out = np.empty((total // sub * channels, sub + 256), np.uint8)
        lib.window_rows_host(x.ctypes.data, carry.ctypes.data, out.ctypes.data,
                             channels, total, sub)
        return out

    return run


@pytest.mark.parametrize("channels,total,sub,g", GEOMETRIES)
def test_kernel_core_matches_plain(kernel_core, rng, channels, total, sub, g):
    x, carry = _inputs(rng, channels, total)
    np.testing.assert_array_equal(
        kernel_core(x, carry, sub),
        window_copy.window_rows_plain(torch.from_numpy(x),
                                      torch.from_numpy(carry), sub, g).numpy())
