"""Kernel N (``kernels/copy_rows.py``, ``csrc/copy_rows.cu``) against the
TPU kernel it ports, ``bench_roofline.py::_pallas_copy_fn`` (K15).

The JAX kernel runs in interpret mode (``pl.pallas_call`` patched for the
duration of a test only) and is held byte for byte against the port's
``copy_rows_`` on CPU tensors, which must hand back the very tensor it was
given.  The kernel's per-thread core (``csrc/wft_copy.cuh``), built with
g++, runs every thread of every CTA of a launch between two buffers at
each alignment mod 16 and at widths around its 16-byte vectors and its
CTAs' 16 KB chunks.  The CUDA kernel itself is held to ``copy_rows_plain``
on the card by ``chip_smoke.py`` (phase 16).

Tolerance: every comparison is exact (``np.array_equal``/``torch.equal``).
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bench_roofline
from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels import copy_rows


@pytest.fixture
def interpret_pallas(monkeypatch):
    """``pl.pallas_call`` in interpret mode while the test runs."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("br", [128, 256])
@pytest.mark.parametrize("batch,seed", [(256, 0), (512, 1), (768, 2)])
def test_copy_matches_jax_pallas_copy(interpret_pallas, br, batch, seed):
    x = np.random.default_rng(seed).integers(
        0, 256, size=(batch, bench_roofline.WIDTH), dtype=np.uint8)
    want = np.asarray(bench_roofline._pallas_copy_fn(br)(x))
    t = torch.from_numpy(x.copy())
    ptr = t.data_ptr()
    got = copy_rows.copy_rows_(t)
    assert got is t and got.data_ptr() == ptr
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, x)


def test_plain_returns_its_input():
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, size=(5, 77), dtype=np.uint8))
    before = x.clone()
    assert copy_rows.copy_rows_plain(x) is x
    assert torch.equal(x, before)


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    calls = []
    plain = copy_rows.copy_rows_plain

    def spy(x):
        calls.append(tuple(x.shape))
        return plain(x)

    monkeypatch.setattr(copy_rows, "copy_rows_plain", spy)
    launches = copy_rows.copy_rows_.launches
    x = torch.zeros((3, 8), dtype=torch.uint8)
    assert copy_rows.copy_rows_(x) is x
    assert calls == [(3, 8)]
    assert copy_rows.copy_rows_.launches == launches  # no kernel launched


@pytest.mark.parametrize("make,error", [
    (lambda: torch.zeros((4, 16), dtype=torch.int8), TypeError),
    (lambda: torch.zeros((4, 16), dtype=torch.float32), TypeError),
    (lambda: torch.zeros((4, 32), dtype=torch.uint8)[:, ::2], ValueError),
    (lambda: torch.zeros((16, 4), dtype=torch.uint8).t(), ValueError),
    (lambda: torch.zeros(64, dtype=torch.uint8), ValueError),
    (lambda: torch.zeros((2, 4, 8), dtype=torch.uint8), ValueError),
    (lambda: np.zeros((4, 16), np.uint8), TypeError),
], ids=["int8", "float32", "strided", "transposed", "1-D", "3-D", "numpy"])
def test_wrapper_refuses(make, error):
    with pytest.raises(error):
        copy_rows.copy_rows_(make())


def test_source_is_built():
    assert _build.CSRC_DIR / "copy_rows.cu" in _build.kernel_sources()
    assert "wft_copy_rows" in _build._SIGNATURES
    assert (_build.CSRC_DIR / "wft_copy.cuh").is_file()


_HARNESS = """
#include <cstdint>
#include "wft_copy.cuh"
// copy_rows.cu's grid, one thread of one CTA at a time.
extern "C" void copy_rows_host(const uint8_t* src, uint8_t* dst,
                               long long nbytes) {
  const wft::CopySplit s =
      wft::copy_split(reinterpret_cast<uintptr_t>(dst), nbytes);
  const long long blocks = wft::copy_blocks(s);
  for (long long b = 0; b < blocks; ++b)
    for (int t = 0; t < wft::kCopyThreads; ++t)
      wft::copy_thread(src, dst, s, b, t);
}
extern "C" void copy_split_host(unsigned long long addr, long long nbytes,
                                long long* out) {
  const wft::CopySplit s = wft::copy_split(addr, nbytes);
  out[0] = s.head; out[1] = s.vectors; out[2] = s.tail;
  out[3] = wft::copy_blocks(s);
}
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    """Kernel N's core (``csrc/wft_copy.cuh``) built with g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("copy_rows")
    (work / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(_build.CSRC_DIR), "-o", str(work / "lib.so"),
                    str(work / "harness.cpp")], check=True, timeout=120)
    lib = ctypes.CDLL(str(work / "lib.so"))
    lib.copy_rows_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_longlong]
    lib.copy_split_host.argtypes = [ctypes.c_ulonglong, ctypes.c_longlong,
                                    ctypes.c_void_p]
    return lib


#: Widths around the vectors and the CTA's 16 KB chunk (1,024 vectors).
CORE_WIDTHS = [*range(0, 201), 1023, 4096 + 7, 16 * 1024 - 1, 16 * 1024,
               16 * 1024 + 1, 16 * 1024 + 17, 3 * 16 * 1024 + 5]


@pytest.mark.parametrize("offset", range(16))
def test_core_copies_every_byte(core, offset):
    """Every thread of every CTA, between two buffers aligned alike mod 16,
    at CORE_WIDTHS: the destination equals the source and nothing around it
    is written."""
    rng = np.random.default_rng(offset)
    for nbytes in CORE_WIDTHS:
        src_buf = np.empty(nbytes + 64, np.uint8)
        dst_buf = np.full(nbytes + 64, 0xA5, np.uint8)
        lead_s = (offset - src_buf.ctypes.data) % 16
        lead_d = (offset - dst_buf.ctypes.data) % 16
        src = src_buf[lead_s : lead_s + nbytes]
        src[:] = rng.integers(0, 256, size=nbytes, dtype=np.uint8)
        core.copy_rows_host(src.ctypes.data, dst_buf.ctypes.data + lead_d,
                            nbytes)
        np.testing.assert_array_equal(dst_buf[lead_d : lead_d + nbytes], src,
                                      err_msg=f"{nbytes} bytes")
        assert (dst_buf[:lead_d] == 0xA5).all()
        assert (dst_buf[lead_d + nbytes :] == 0xA5).all()


@pytest.mark.parametrize("addr,nbytes,split", [
    (0, 0, (0, 0, 0, 1)), (0, 15, (0, 0, 15, 1)), (0, 16, (0, 1, 0, 1)),
    (1, 15, (15, 0, 0, 1)), (1, 10, (10, 0, 0, 1)), (15, 33, (1, 2, 0, 1)),
    (3, 8192 * 4, (13, 2047, 3, 2)), (0, 16 * 1024, (0, 1024, 0, 1)),
    (0, 16 * 1024 + 16, (0, 1025, 0, 2)),
    (16, 8192 * 81920, (0, 41943040, 0, 40960)),
])
def test_split(core, addr, nbytes, split):
    """Head, vectors, tail and CTAs of a launch."""
    out = (ctypes.c_longlong * 4)()
    core.copy_split_host(addr, nbytes, out)
    assert tuple(out) == split
