"""Kernel A's parameters and plain version against the JAX band kernels.

The port carries the TPU band kernels' encoding across (digit planes,
exponents, tri-tile band planes, bias, ``needs_wrap``); these tests hold
each piece against ``warmup_fir_filter_tpu/kernels/fir_mxu.py`` and hold
``fir_band_plain`` (the band formulation in int64 matmuls) against
``fir1d_fixed_rows_mxu`` run in interpret mode, as the JAX tests run it on
the CPU.  The kernel's two routes (``csrc/wft_band.cuh``) are built with
g++ and run thread by thread on the host against ``fir_band_plain`` and
the golden; the CUDA kernel itself is held to ``fir_band_plain`` on the
card by ``chip_smoke.py``.

Tolerances: every fixed-point comparison is ``np.array_equal`` (tolerance
0).  The f32 ideal path is held to ``atol=1e-2, rtol=1e-5`` elsewhere
(``tests/test_torch_fir1d.py``), the bound ``tests/test_fir1d_jnp.py:72``
uses.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.kernels import fir_mxu
from warmup_fir_filter_tpu.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels import fir_band as band
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

FORMATS = [QFormat(), QFormat(8, 4, 32), QFormat(8, 7, 16),
           QFormat(16, 12, 20), QFormat(16, 15, 31), QFormat(32, 24, 32),
           QFormat(32, 12, 28), QFormat(16, 1, 8)]
BANK_FILTERS = [(tap, name) for tap in (3, 5) for name in FILTER_BANKS[tap]]


def _taps(rng, qf: QFormat, num_taps: int) -> np.ndarray:
    span = min(qf.max_coeff_real, 8.0)
    return np.clip(rng.uniform(-span, span, size=num_taps),
                   max(qf.min_coeff_real, -8.0), span)


def _jax_bias_and_wrap(monkeypatch, h, qf: QFormat) -> tuple[int, bool]:
    """What ``fir1d_fixed_rows_mxu`` hands its full-row kernel
    (``fir_mxu.py:578-597``), recorded at the call."""
    seen = {}

    def record(x, a_prev, a_cur, a_next, bias, exponents, frac_bits,
               acc_bits, block_rows, needs_wrap, *rest):
        seen["bias"] = int(np.asarray(bias)[0, 0])
        seen["needs_wrap"] = bool(needs_wrap)
        return x

    monkeypatch.setattr(fir_mxu, "_fir_mxu_fullrow", record)
    fir_mxu.fir1d_fixed_rows_mxu(np.zeros((1, 8), np.uint8), h, qf)
    return seen["bias"], seen["needs_wrap"]


def _assert_parameters_match(monkeypatch, h, qf: QFormat) -> None:
    h_fixed = qf.quantize_coeffs(h).astype(np.int64)
    want = fir_mxu.build_tile_band_planes(h_fixed)
    fir = band.FixedFir1d.from_numpy(h, qf)
    for got, ref in zip((fir.a_prev, fir.a_cur, fir.a_next), want[:3]):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), ref)
    assert fir.exponents == want[3]
    assert tuple(fir.digits.shape) == (len(want[3]), h_fixed.size)
    np.testing.assert_array_equal(fir.h_fixed.numpy(), h_fixed)
    bias, needs_wrap = _jax_bias_and_wrap(monkeypatch, h, qf)
    assert int(fir.bias) == bias == fir.bias_value
    assert bool(fir.needs_wrap) == needs_wrap == fir.wrap


@pytest.mark.parametrize("tap,name", BANK_FILTERS)
@pytest.mark.parametrize("qf", [QFormat(), QFormat(16, 12, 20),
                                QFormat(8, 4, 32)], ids=str)
def test_parameters_match_jax_filter_banks(monkeypatch, tap, name, qf):
    _assert_parameters_match(monkeypatch, FILTER_BANKS[tap][name], qf)


@pytest.mark.parametrize("qf", FORMATS, ids=str)
def test_parameters_match_jax_random_taps(monkeypatch, rng, qf):
    for num_taps in (1, 2, 4, 63, 257):
        _assert_parameters_match(monkeypatch, _taps(rng, qf, num_taps), qf)


def test_digit_helpers_match_jax(rng):
    for values in (rng.integers(-2**31, 2**31, size=64),
                   rng.integers(-300, 300, size=17) << 7,
                   np.array([0, 0]), np.array([-2**31, 2**31 - 1, 1365])):
        np.testing.assert_array_equal(band.signed_base256_digits(values),
                                      fir_mxu.signed_base256_digits(values))
        got, want = band.factor_pow2(values), fir_mxu.factor_pow2(values)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_moving_avg_needs_two_planes():
    fir = band.FixedFir1d.from_numpy(FILTER_BANKS[3]["moving_avg"], QFormat())
    assert fir.exponents == (0, 8)  # 1365 = 5·256 + 85


@pytest.mark.parametrize("num_taps", [1, 2, 3, 5, 63, 129, 257])
def test_band_plain_matches_mxu_kernel(rng, num_taps):
    """Ragged widths, both sides of the no-wrap fast path."""
    for qf in (QFormat(), QFormat(16, 12, 20), QFormat(32, 12, 28)):
        h = _taps(rng, qf, num_taps)
        fir = band.FixedFir1d.from_numpy(h, qf)
        for width in (1, 127, 150, 389):
            x = rng.integers(0, 256, size=(3, width), dtype=np.uint8)
            want = np.asarray(fir_mxu.fir1d_fixed_rows_mxu(x, h, qf,
                                                           block_rows=8))
            got = band.fir_band_plain(torch.from_numpy(x), fir)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"L={num_taps} N={width} {qf}")


def test_band_plain_matches_column_split_kernel(rng):
    """K2's column-split path (explicit ``col_tiles``) on a ragged width."""
    qf = QFormat(16, 8, 24)
    h = _taps(rng, qf, 11)
    x = rng.integers(0, 256, size=(3, 530), dtype=np.uint8)
    want = np.asarray(fir_mxu.fir1d_fixed_rows_mxu(x, h, qf, block_rows=8,
                                                   col_tiles=2))
    got = band.fir_band_plain(torch.from_numpy(x), band.FixedFir1d.from_numpy(h, qf))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tap,name", BANK_FILTERS)
def test_band_wrapper_on_cpu_is_plain_and_golden(rng, tap, name):
    h = np.asarray(FILTER_BANKS[tap][name])
    x = rng.integers(0, 256, size=(4, 97), dtype=np.uint8)
    before = band.fir_band.launches
    got = band.FixedFir1d.from_numpy(h, QFormat())(torch.from_numpy(x))
    assert band.fir_band.launches == before  # no kernel on a CPU tensor
    np.testing.assert_array_equal(got.numpy(), fir1d_fixed_golden_rows(x, h))


def test_band_plain_wide_row_golden(rng):
    """One row of 40,000 samples: K2's regime, against the golden only."""
    qf = QFormat(16, 12, 20)
    h = _taps(rng, qf, 129)
    x = rng.integers(0, 256, size=(1, 40000), dtype=np.uint8)
    got = band.fir_band_plain(torch.from_numpy(x), band.FixedFir1d.from_numpy(h, qf))
    np.testing.assert_array_equal(got.numpy(), fir1d_fixed_golden_rows(x, h, qf))


def test_all_zero_filter(rng):
    fir = band.FixedFir1d.from_numpy(np.zeros(3), QFormat())
    assert fir.exponents == (0,)
    x = rng.integers(0, 256, size=(2, 40), dtype=np.uint8)
    assert not band.fir_band_plain(torch.from_numpy(x), fir).any()


def test_band_rejects_bad_inputs(rng):
    fir = band.FixedFir1d.from_numpy([0.25, 0.5, 0.25], QFormat())
    x = torch.from_numpy(rng.integers(0, 256, size=(2, 8), dtype=np.uint8))
    with pytest.raises(TypeError, match="uint8"):
        fir(x.to(torch.int32))
    with pytest.raises(ValueError, match="rows"):
        fir(x[0])
    with pytest.raises(ValueError, match="device"):
        fir(x.to("meta"))
    with pytest.raises(ValueError, match="257"):
        band.FixedFir1d.from_numpy(np.ones(258) / 258, QFormat())
    with pytest.raises(ValueError, match="acc_bits"):
        band.FixedFir1d.from_numpy([0.5], QFormat(acc_bits=40))


def test_module_buffers_move_with_the_module():
    fir = band.FixedFir1d.from_numpy(FILTER_BANKS[5]["sharpen"], QFormat())
    names = set(fir.state_dict())
    assert names == {"h_fixed", "digits", "a_prev", "a_cur", "a_next",
                     "bias", "needs_wrap"}
    moved = fir.to("meta")
    assert moved.digits.device.type == "meta"


# ------------------------------------------------------------ the host core

_HARNESS = r"""
#include <array>
#include <cstdint>
#include <utility>
#include <vector>

#include "wft_band.cuh"

namespace {

// fir_band.cu's short-tap kernel: every thread of every CTA.
template <int L>
void short_ctas(const uint8_t* x, uint8_t* y, long long total, long long n,
                const wft::BandShort& p) {
  const long long chunks = (total + wft::kShortChunk - 1) / wft::kShortChunk;
  const long long ctas =
      (chunks + wft::kShortCtaChunks - 1) / wft::kShortCtaChunks;
  for (long long b = 0; b < ctas; ++b)
    for (int t = 0; t < wft::kShortThreads; ++t)
      wft::short_thread<L>(x, y, total, n, chunks, p, b, t);
}

using Short = void (*)(const uint8_t*, uint8_t*, long long, long long,
                       const wft::BandShort&);

template <int... Is>
std::array<Short, sizeof...(Is)> short_table(
    std::integer_sequence<int, Is...>) {
  return {&short_ctas<wft::kShortInstances[Is]>...};
}

}  // namespace

// wft_fir_band's dispatch and kernels, a CTA's phases one after another.
extern "C" void fir_band_host(const uint8_t* x, uint8_t* y, long long rows,
                              long long n, const int8_t* digits, int planes,
                              int taps, const int* exps, uint32_t bias,
                              int wrap, int frac_bits, int acc_bits,
                              const int32_t* h) {
  if (taps <= wft::kShortMaxTaps) {
    static const auto table = short_table(
        std::make_integer_sequence<int, wft::kShortInstanceCount>{});
    const int i = wft::short_instance(taps);
    table[i](x, y, rows * n, n,
             wft::band_short_params(taps, wft::kShortInstances[i], h, bias,
                                    wrap, frac_bits, acc_bits));
    return;
  }
  wft::BandParams p{};
  p.planes = planes;
  p.taps = taps;
  p.left = taps - 1 - taps / 2;
  for (int b = 0; b < planes; ++b) p.exps[b] = exps[b];
  p.bias = bias;
  p.needs_wrap = wrap;
  p.frac_bits = frac_bits;
  p.acc_bits = acc_bits;
  std::vector<int8_t> xs(wft::kBandRows * wft::kBandWindow);
  std::vector<int8_t> ds(wft::kBandMaxPlanes * wft::kBandMaxTaps);
  auto* xs2 = reinterpret_cast<int8_t (*)[wft::kBandWindow]>(xs.data());
  auto* ds2 = reinterpret_cast<int8_t (*)[wft::kBandMaxTaps]>(ds.data());
  for (long long row0 = 0; row0 < rows; row0 += wft::kBandRows) {
    for (long long col0 = 0; col0 < n; col0 += wft::kBandLane) {
      for (int i = 0; i < wft::kBandLane; ++i)
        wft::band_stage_thread(x, rows, n, row0, col0, digits, p, xs2, ds2,
                               i);
      for (int i = 0; i < wft::kBandLane; ++i)
        wft::band_planes_thread(xs2, ds2, p, y, rows, n, row0, col0, i);
    }
  }
}
"""


@pytest.fixture(scope="module")
def kernel_core(tmp_path_factory):
    """Kernel A's cores (``csrc/wft_band.cuh``) built with g++; runs them
    on ``x`` placed ``offset`` bytes past a 64-byte boundary."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("fir_band")
    (work / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(_build.CSRC_DIR), "-o", str(work / "lib.so"),
                    str(work / "harness.cpp")], check=True, timeout=240)
    lib = ctypes.CDLL(str(work / "lib.so"))
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fir_band_host.argtypes = [vp, vp, ll, ll, vp, i32, i32, vp,
                                  ctypes.c_uint32, i32, i32, i32, vp]

    def run(x: np.ndarray, fir: band.FixedFir1d, offset: int = 0):
        rows, n = x.shape
        store = np.zeros(x.size + 128, np.uint8)
        start = (-store.ctypes.data) % 64 + offset
        xa = store[start : start + x.size]
        xa[:] = x.reshape(-1)
        y = np.full(x.size + 64, 0xA5, np.uint8)
        ya = y[(-y.ctypes.data) % 16:][: x.size]
        digits = np.ascontiguousarray(fir.digits.numpy())
        exps = np.asarray(fir.exponents, np.int32)
        taps = np.ascontiguousarray(fir.h_fixed.numpy())
        qf = fir.qformat
        lib.fir_band_host(xa.ctypes.data, ya.ctypes.data, rows, n,
                          digits.ctypes.data, len(fir.exponents),
                          fir.num_taps, exps.ctypes.data,
                          fir.bias_value & 0xFFFFFFFF, int(fir.wrap),
                          qf.frac_bits, qf.acc_bits, taps.ctypes.data)
        return ya.reshape(rows, n).copy()

    return run


#: Widths at the 16-byte chunk and around it, a ragged image width and K2's
#: regime; row counts that are no multiple of a CTA's rows or chunks.
CORE_SHAPES = ((3, 1), (5, 15), (2, 16), (7, 17), (1, 31), (3, 4499),
               (1, 40000))
#: Tap counts at each instance of the short route, between them (run
#: zero-padded on the next), either side of the crossover (32) and at the
#: digit planes' ends.
CORE_TAPS = [(1, 2, 3, 4, 5), (6, 7, 8, 9, 10, 11, 12), (13, 16, 17, 24),
             (25, 31, 32), (33, 34, 63), (129, 256, 257)]


@pytest.mark.parametrize("taps", CORE_TAPS, ids=str)
@pytest.mark.parametrize("qf", [QFormat(), QFormat(8, 7, 16),
                                QFormat(16, 12, 20), QFormat(16, 15, 31),
                                QFormat(32, 12, 28)], ids=str)
def test_kernel_core_matches_plain_and_golden(kernel_core, rng, taps, qf):
    """Both routes, wrap and no-wrap formats, acc_bits 16-32; golden up to
    4,499 columns."""
    for num_taps in taps:
        h = _taps(rng, qf, num_taps)
        fir = band.FixedFir1d.from_numpy(h, qf)
        for rows, n in CORE_SHAPES:
            x = rng.integers(0, 256, size=(rows, n), dtype=np.uint8)
            got = kernel_core(x, fir)
            label = f"L={num_taps} {rows}x{n} {qf} wrap={fir.wrap}"
            np.testing.assert_array_equal(
                got, band.fir_band_plain(torch.from_numpy(x), fir).numpy(),
                err_msg=label)
            if n <= 4499:
                np.testing.assert_array_equal(
                    got, fir1d_fixed_golden_rows(x, h, qf), err_msg=label)


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
def test_kernel_core_misaligned_input(kernel_core, rng, offset):
    """An input that starts off a 16-byte boundary takes byte reads and
    gives the same outputs."""
    for num_taps in (3, 5, 32, 63):
        h = _taps(rng, QFormat(), num_taps)
        fir = band.FixedFir1d.from_numpy(h, QFormat())
        x = rng.integers(0, 256, size=(5, 333), dtype=np.uint8)
        np.testing.assert_array_equal(
            kernel_core(x, fir, offset), kernel_core(x, fir, 0),
            err_msg=f"L={num_taps} offset={offset}")
        np.testing.assert_array_equal(
            kernel_core(x, fir, offset), fir1d_fixed_golden_rows(x, h))


def test_kernel_core_bank_filters_and_zero_filter(kernel_core, rng):
    x = rng.integers(0, 256, size=(9, 1280), dtype=np.uint8)
    for tap, name in BANK_FILTERS:
        h = np.asarray(FILTER_BANKS[tap][name])
        fir = band.FixedFir1d.from_numpy(h, QFormat())
        np.testing.assert_array_equal(kernel_core(x, fir),
                                      fir1d_fixed_golden_rows(x, h),
                                      err_msg=name)
    fir = band.FixedFir1d.from_numpy(np.zeros(5), QFormat())
    assert not kernel_core(x, fir).any()
