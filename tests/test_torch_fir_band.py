"""Kernel A's parameters and plain version against the JAX band kernels.

The port carries the TPU band kernels' encoding across (digit planes,
exponents, tri-tile band planes, bias, ``needs_wrap``); these tests hold
each piece against ``warmup_fir_filter_tpu/kernels/fir_mxu.py`` and hold
``fir_band_plain`` (the band formulation in int64 matmuls) against
``fir1d_fixed_rows_mxu`` run in interpret mode, as the JAX tests run it on
the CPU.  The kernel's two routes (``csrc/wft_band.cuh``) are built with
g++ and run on the host against ``fir_band_plain`` and the golden: the
short-tap route thread by thread, the digit-plane route's CTAs phase by
phase and its warps with their 32 lanes as one unit, ``mma.sync`` s8 × u8
emulated from its PTX fragment layout (the emulation itself held to a
numpy matmul); the CUDA kernel itself is held to ``fir_band_plain`` on the
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


LEAN_TAPS = (1, 5, 6, 7, 63, 257)
LEAN_FORMATS = [QFormat(), QFormat(32, 24, 32)]


@pytest.mark.parametrize("qf", LEAN_FORMATS, ids=str)
@pytest.mark.parametrize("num_taps", LEAN_TAPS)
def test_device_preparation_uploads_only_the_digits(rng, num_taps, qf):
    """Off the CPU the filter puts one tensor on its device, the digit
    planes kernel A reads; the host buffers equal the CPU filter's."""
    h = _taps(rng, qf, num_taps)
    before = band.FixedFir1d.uploads
    cpu = band.FixedFir1d.from_numpy(h, qf)
    assert band.FixedFir1d.uploads == before
    fir = band.FixedFir1d.from_numpy(h, qf, "meta")
    assert band.FixedFir1d.uploads == before + 1
    assert [(name, b.device.type) for name, b in fir.named_buffers()] == [
        ("digits", "meta")]
    assert fir.digits.dtype == cpu.digits.dtype == torch.int8
    assert fir.digits.shape == cpu.digits.shape
    assert fir.exponents == cpu.exponents
    for name in band.HOST_BUFFERS:
        got, want = getattr(fir, name), getattr(cpu, name)
        assert got.device.type == "cpu" and got.dtype == want.dtype, name
        assert torch.equal(got, want), name


@pytest.mark.parametrize("qf", LEAN_FORMATS, ids=str)
@pytest.mark.parametrize("num_taps", LEAN_TAPS)
def test_band_plain_on_planes_built_at_first_read(rng, num_taps, qf):
    """A filter prepared off the CPU builds its band planes when the plain
    version first reads them, once, and filters as the golden does."""
    h = _taps(rng, qf, num_taps)
    fir = band.FixedFir1d.from_numpy(h, qf, "meta")
    assert not set(band.HOST_BUFFERS) & set(vars(fir))
    x = rng.integers(0, 256, size=(3, 150), dtype=np.uint8)
    got = band.fir_band_plain(torch.from_numpy(x), fir)
    np.testing.assert_array_equal(got.numpy(),
                                  fir1d_fixed_golden_rows(x, h, qf))
    assert fir.a_cur is fir.a_cur
    assert fir.digits.device.type == "meta"


# ------------------------------------------------------------ the host core

_HARNESS = r"""
#include <algorithm>
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

// fir_band.cu's digit-plane kernel on `ctas` CTAs: each CTA's two set-up
// phases thread by thread, then its warps one after another.
template <int CHUNKS>
void planes_ctas(const uint8_t* x, uint8_t* y, long long rows, long long n,
                 const int8_t* digits, const wft::PlanesParams& p,
                 long long ctas) {
  const wft::PlanesLayout lay = wft::planes_layout(p.planes, p.taps, CHUNKS);
  std::vector<uint32_t> words(lay.total / 4 + 4);
  uint8_t* smem = reinterpret_cast<uint8_t*>(words.data());
  for (long long b = 0; b < ctas; ++b) {
    std::fill(words.begin(), words.end(), 0xA5A5A5A5u);
    for (int i = 0; i < wft::kPlanesThreads; ++i)
      wft::planes_setup_digits(smem, digits, p, lay, i);
    for (int i = 0; i < wft::kPlanesThreads; ++i)
      wft::planes_setup_band(smem, p, lay, i);
    for (int w = 0; w < wft::kPlanesWarps; ++w) {
      long long first = 0, count = 0;
      wft::planes_share(p.items, ctas * wft::kPlanesWarps,
                        b * wft::kPlanesWarps + w, &first, &count);
      wft::planes_warp<CHUNKS>(x, y, rows, n, smem,
                               smem + lay.warps + w * lay.warp_bytes, p, lay,
                               first, count);
    }
  }
}

using Planes = void (*)(const uint8_t*, uint8_t*, long long, long long,
                        const int8_t*, const wft::PlanesParams&, long long);

template <int... Is>
std::array<Planes, sizeof...(Is)> planes_table(
    std::integer_sequence<int, Is...>) {
  return {&planes_ctas<Is + 1>...};
}

void run_planes(const uint8_t* x, uint8_t* y, long long rows, long long n,
                const int8_t* digits, int planes, int taps, const int* exps,
                uint32_t bias, int wrap, int frac_bits, int acc_bits,
                const int32_t* h, int ctas) {
  static const auto table = planes_table(
      std::make_integer_sequence<int, wft::kPlanesMaxChunks>{});
  const wft::PlanesParams p = wft::planes_params(
      rows, n, planes, taps, exps, bias, wrap, frac_bits, acc_bits, h);
  table[p.chunks - 1](x, y, rows, n, digits, p, ctas);
}

}  // namespace

// wft_fir_band's dispatch and kernels, a CTA's phases one after another.
extern "C" void fir_band_host(const uint8_t* x, uint8_t* y, long long rows,
                              long long n, const int8_t* digits, int planes,
                              int taps, const int* exps, uint32_t bias,
                              int wrap, int frac_bits, int acc_bits,
                              const int32_t* h, int ctas) {
  if (taps <= wft::kBandShortMaxTaps) {
    static const auto table = short_table(
        std::make_integer_sequence<int, wft::kBandShortInstances>{});
    const int i = wft::short_instance(taps);
    table[i](x, y, rows * n, n,
             wft::band_short_params(taps, wft::kShortInstances[i], h, bias,
                                    wrap, frac_bits, acc_bits));
    return;
  }
  run_planes(x, y, rows, n, digits, planes, taps, exps, bias, wrap,
             frac_bits, acc_bits, h, ctas);
}

// The digit-plane route alone at any tap count, on `ctas` CTAs.
extern "C" void fir_band_planes_host(const uint8_t* x, uint8_t* y,
                                     long long rows, long long n,
                                     const int8_t* digits, int planes,
                                     int taps, const int* exps, uint32_t bias,
                                     int wrap, int frac_bits, int acc_bits,
                                     const int32_t* h, int ctas) {
  run_planes(x, y, rows, n, digits, planes, taps, exps, bias, wrap,
             frac_bits, acc_bits, h, ctas);
}

// One emulated mma.sync m16n8k32 s8 x u8 over a warp's fragments.
extern "C" void mma_s8u8_host(uint32_t* a, uint32_t* b, int32_t* d) {
  wft::mma_s8u8(reinterpret_cast<int32_t (*)[4]>(d),
                reinterpret_cast<uint32_t (*)[4]>(a),
                reinterpret_cast<uint32_t (*)[2]>(b));
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
    for fn in (lib.fir_band_host, lib.fir_band_planes_host):
        fn.argtypes = [vp, vp, ll, ll, vp, i32, i32, vp, ctypes.c_uint32,
                       i32, i32, i32, vp, i32]
    lib.mma_s8u8_host.argtypes = [vp] * 3

    def run(x: np.ndarray, fir: band.FixedFir1d, offset: int = 0,
            ctas: int = 3, planes_route: bool = False):
        """The kernel on ``x`` (the digit-plane route on ``ctas`` CTAs, or
        at any tap count with ``planes_route``); the output starts as
        0xA5, so an unwritten byte shows."""
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
        fn = lib.fir_band_planes_host if planes_route else lib.fir_band_host
        fn(xa.ctypes.data, ya.ctypes.data, rows, n, digits.ctypes.data,
           len(fir.exponents), fir.num_taps, exps.ctypes.data,
           fir.bias_value & 0xFFFFFFFF, int(fir.wrap), qf.frac_bits,
           qf.acc_bits, taps.ctypes.data, ctas)
        return ya.reshape(rows, n).copy()

    run.mma_s8u8 = lib.mma_s8u8_host
    return run


#: Widths at the 16-byte chunk and around it, a ragged image width and K2's
#: regime; row counts that are no multiple of a CTA's rows or chunks.
CORE_SHAPES = ((3, 1), (5, 15), (2, 16), (7, 17), (1, 31), (3, 4499),
               (1, 40000))
#: Tap counts at each instance of the short route, either side of the
#: crossover (6) and at each chunk count of the digit planes and their
#: ends.
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


@pytest.mark.parametrize("offset", range(1, 16))
def test_kernel_core_misaligned_input(kernel_core, rng, offset):
    """An input that starts off a 16-byte boundary gives the same outputs:
    byte reads on the short-tap route, items shifted to the rows' 16-byte
    boundaries on the digit planes."""
    for num_taps in (3, 5, 32, 33, 63, 129, 257):
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
    for num_taps in (5, 40):
        fir = band.FixedFir1d.from_numpy(np.zeros(num_taps), QFormat())
        assert not kernel_core(x, fir).any()


#: The digit-plane route's tap counts: each side of the crossover and of
#: each chunk count (2 chunks to 49 taps, 3 to 81, 5 at 129, 9 from 242).
PLANES_TAPS = (33, 34, 63, 64, 65, 129, 255, 256, 257)
#: Formats of one to four digit planes, wrap and no-wrap, acc_bits 16-32.
PLANES_FORMATS = [QFormat(), QFormat(8, 7, 16), QFormat(16, 12, 20),
                  QFormat(16, 15, 31), QFormat(32, 12, 28),
                  QFormat(32, 24, 32)]
#: Widths 1-4,499 around the 128-column tile and the 1,024-column item,
#: row counts no multiple of a CTA's four warps.
PLANES_SHAPES = ((3, 1), (5, 15), (2, 16), (7, 17), (1, 127), (5, 128),
                 (3, 129), (6, 511), (9, 513), (2, 1023), (3, 1024),
                 (5, 1025), (3, 2100), (3, 4499))


@pytest.mark.parametrize("num_taps", PLANES_TAPS)
@pytest.mark.parametrize("qf", PLANES_FORMATS, ids=str)
def test_planes_route_matches_plain_and_golden(kernel_core, rng, qf,
                                               num_taps):
    """The digit-plane route's CTAs and warps on the host (the MMA
    emulated), each shape against the plain version and the golden."""
    h = _taps(rng, qf, num_taps)
    fir = band.FixedFir1d.from_numpy(h, qf)
    for rows, n in PLANES_SHAPES:
        x = rng.integers(0, 256, size=(rows, n), dtype=np.uint8)
        got = kernel_core(x, fir)
        label = (f"L={num_taps} {rows}x{n} {qf} planes={len(fir.exponents)}"
                 f" wrap={fir.wrap}")
        np.testing.assert_array_equal(
            got, band.fir_band_plain(torch.from_numpy(x), fir).numpy(),
            err_msg=label)
        np.testing.assert_array_equal(
            got, fir1d_fixed_golden_rows(x, h, qf), err_msg=label)


@pytest.mark.parametrize("case", ["five_planes", "shift_32"])
def test_planes_route_five_planes_and_shifts_past_32(kernel_core, rng, case):
    """Five digit planes (int32 taps at both ends of their range; the
    planes run in three passes of two) and a plane whose exponent is 32 or
    more, which adds nothing mod 2^32."""
    qf = QFormat(32, 24, 32)
    if case == "five_planes":
        h_fixed = rng.integers(-2**31, 2**31, size=77)
        h_fixed[:3] = (-2**31, 2**31 - 1, 2**31 - 2**23)
        want_planes = 5
    else:
        h_fixed = rng.integers(-200, 200, size=70) << 25
        h_fixed[0] = 255 << 25
        want_planes = 2
    fir = band.FixedFir1d(h_fixed, qf)
    assert len(fir.exponents) == want_planes
    if case == "shift_32":
        assert max(fir.exponents) >= 32
    x = rng.integers(0, 256, size=(5, 1300), dtype=np.uint8)
    np.testing.assert_array_equal(
        kernel_core(x, fir),
        band.fir_band_plain(torch.from_numpy(x), fir).numpy())


@pytest.mark.parametrize("ctas", [1, 2, 5, 64])
def test_planes_route_any_grid(kernel_core, rng, ctas):
    """Warps that walk many items across rows, and grids with idle warps."""
    qf = QFormat(16, 12, 20)
    h = _taps(rng, qf, 129)
    fir = band.FixedFir1d.from_numpy(h, qf)
    x = rng.integers(0, 256, size=(13, 1000), dtype=np.uint8)
    np.testing.assert_array_equal(
        kernel_core(x, fir, ctas=ctas),
        band.fir_band_plain(torch.from_numpy(x), fir).numpy())


@pytest.mark.parametrize("num_taps", [1, 2, 3, 5, 6, 7, 8, 12, 16, 17, 24,
                                      31, 32])
def test_planes_route_at_short_tap_counts(kernel_core, rng, num_taps):
    """The digit-plane route alone (``wft_fir_band_planes``) at every tap
    count of the short route, where the crossover is measured, against the
    kernel's dispatch: one chunk up to 17 taps."""
    for qf in (QFormat(), QFormat(8, 7, 16), QFormat(32, 12, 28)):
        h = _taps(rng, qf, num_taps)
        fir = band.FixedFir1d.from_numpy(h, qf)
        x = rng.integers(0, 256, size=(6, 700), dtype=np.uint8)
        got = kernel_core(x, fir, planes_route=True)
        np.testing.assert_array_equal(
            got, band.fir_band_plain(torch.from_numpy(x), fir).numpy(),
            err_msg=f"L={num_taps} {qf}")
        np.testing.assert_array_equal(got, kernel_core(x, fir),
                                      err_msg=f"L={num_taps} {qf}")


def _fragments_s8u8(a: np.ndarray, b: np.ndarray, d: np.ndarray):
    """A warp's fragments of mma.sync.aligned.m16n8k32.row.col with s8 A
    and u8 B, from the PTX ISA's layout: lane 4g + t holds A rows g and
    g + 8 at k 4t..4t+3 and 16+4t..16+4t+3, B column g at the same k, D
    (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)."""
    def word(v, dtype):
        return int(np.ascontiguousarray(v, dtype).view("<u4")[0])

    fa = np.zeros((32, 4), np.uint32)
    fb = np.zeros((32, 2), np.uint32)
    fd = np.zeros((32, 4), np.int32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for reg, (row, k) in enumerate(((g, 4 * t), (g + 8, 4 * t),
                                        (g, 16 + 4 * t), (g + 8, 16 + 4 * t))):
            fa[lane, reg] = word(a[row, k : k + 4], np.int8)
        fb[lane, 0] = word(b[4 * t : 4 * t + 4, g], np.uint8)
        fb[lane, 1] = word(b[16 + 4 * t : 20 + 4 * t, g], np.uint8)
        for j in range(4):
            fd[lane, j] = d[g + 8 * (j >> 1), 2 * t + (j & 1)]
    return fa, fb, fd


@pytest.mark.parametrize("case", ["random", "extremes", "accumulate"])
def test_mma_s8u8_emulation_matches_matmul(kernel_core, rng, case):
    """The host emulation of mma.sync m16n8k32 s8 x u8 (what the CPU tests
    run in place of the tensor cores) against a numpy matmul."""
    a = rng.integers(-128, 128, size=(16, 32)).astype(np.int8)
    b = rng.integers(0, 256, size=(32, 8)).astype(np.uint8)
    d = np.zeros((16, 8), np.int32)
    if case == "extremes":
        a[:8], b[:, :4] = -128, 255
        a[8:], b[:, 4:] = 127, 255
    elif case == "accumulate":
        d = rng.integers(-2**30, 2**30, size=(16, 8)).astype(np.int32)
    fa, fb, fd = _fragments_s8u8(a, b, d)
    kernel_core.mma_s8u8(fa.ctypes.data, fb.ctypes.data, fd.ctypes.data)
    want = d.astype(np.int64) + a.astype(np.int64) @ b.astype(np.int64)
    got = np.zeros((16, 8), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(4):
            got[g + 8 * (j >> 1), 2 * t + (j & 1)] = fd[lane, j]
    np.testing.assert_array_equal(got, want)


def test_short_max_taps_matches_the_kernel():
    """The wrapper's record of the crossover is the kernel's."""
    header = (_build.CSRC_DIR / "wft_band.cuh").read_text()
    assert (f"constexpr int kBandShortMaxTaps = {band.SHORT_MAX_TAPS};"
            in header)
