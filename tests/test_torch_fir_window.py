"""Kernel C's parameters, plain version and core against the JAX K3 kernel.

The port carries K3's encoding across (kept digit planes, exponents,
per-plane trimming to the nonzero tap range, bias, ``needs_wrap``).  These
tests hold ``build_window_band_planes`` against
``warmup_fir_filter_tpu/kernels/fir_mxu.py``, ``fir_window_plain`` (the
windowed formulation in int64 matmuls) against
``fir1d_fixed_rows_mxu_window`` run in interpret mode and the golden, at
the JAX tests' own sizes (``tests/test_fir_mxu_window.py:72-138``), and
the kernel's warp core (``csrc/wft_window.cuh``, built with g++ and run
over every warp item, a warp's 32 lanes as one unit, with ``mma.sync``
emulated from its PTX fragment layout in ``csrc/wft_band_mma.cuh``)
against ``fir_window_plain``; the emulation alone against a numpy matmul.
The CUDA kernel itself is held to ``fir_window_plain`` on the card by
``chip_smoke.py``.

Tolerance: every comparison is ``np.array_equal`` (tolerance 0).
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
from warmup_fir_filter_tpu.ops.resample import design_lowpass
from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels import fir_window as window
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

FORMATS = [QFormat(), QFormat(8, 4, 32), QFormat(16, 12, 20),
           QFormat(16, 8, 24), QFormat(32, 24, 32), QFormat(32, 12, 28)]


def _taps(rng, qf: QFormat, num_taps: int) -> np.ndarray:
    span = min(qf.max_coeff_real, 8.0)
    return np.clip(rng.uniform(-span, span, size=num_taps),
                   max(qf.min_coeff_real, -8.0), span)


def _fixed(h, qf: QFormat = QFormat()) -> np.ndarray:
    return qf.quantize_coeffs(h).astype(np.int64)


def _plain(x: np.ndarray, h, qf: QFormat = QFormat()) -> np.ndarray:
    fir = window.FixedFirWindow.from_numpy(h, qf)
    return window.fir_window_plain(torch.from_numpy(x), fir).numpy()


@pytest.mark.parametrize("case", ["lowpass258", "lowpass1001", "random37",
                                  "random4096", "q32", "zeros", "impulse"])
def test_band_planes_match_jax(rng, case):
    h_fixed = {
        "lowpass258": lambda: _fixed(design_lowpass(258, 0.3)),
        "lowpass1001": lambda: _fixed(design_lowpass(1001, 0.25)),
        "random37": lambda: rng.integers(-30000, 30000, size=37),
        "random4096": lambda: rng.integers(-2**15, 2**15, size=4096),
        "q32": lambda: _fixed(_taps(rng, QFormat(32, 24, 32), 300),
                              QFormat(32, 24, 32)),
        "zeros": lambda: np.zeros(300, np.int64),
        "impulse": lambda: np.eye(1, 513, 256, dtype=np.int64)[0] << 12,
    }[case]()
    got = window.build_window_band_planes(h_fixed)
    want = fir_mxu.build_window_band_planes(h_fixed)
    assert got[0].dtype == np.int8
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_per_plane_trimming():
    """The 1,001-tap low-pass of ``test_fir_mxu_window.py:50-64``: the
    high-byte plane covers the main lobe only, in the bands and in the
    kernel's tap ranges."""
    h = design_lowpass(1001, 0.25)
    _, entries = window.build_window_band_planes(_fixed(h))
    rows = {exp: r for exp, _, r, _ in entries}
    low_exp, high_exp = sorted(rows)
    assert len(entries) == 2
    assert 700 < rows[low_exp] <= 1001 + 127
    assert rows[high_exp] < min(400, rows[low_exp] // 2)
    fir = window.FixedFirWindow.from_numpy(h)
    (lo_min, lo_max), (hi_min, hi_max) = fir.tap_ranges
    assert hi_max - hi_min + 128 == rows[high_exp]
    assert lo_max - lo_min + 128 == rows[low_exp]
    quads = fir.plane_table[window.PLANE_FIELDS + 2]
    assert quads * 4 < (hi_max - hi_min + 1) + 8


def test_tap_limit_rejected():
    with pytest.raises(ValueError, match="supports up to"):
        window.build_window_band_planes(np.ones(4097, np.int64))
    with pytest.raises(ValueError, match="supports up to"):
        window.FixedFirWindow.from_numpy(np.ones(4097) / 4097)
    with pytest.raises(ValueError, match="acc_bits"):
        window.FixedFirWindow.from_numpy(np.ones(300) / 300, QFormat(acc_bits=40))


def _jax_bias_and_wrap(monkeypatch, h, qf: QFormat) -> tuple[int, bool]:
    """An interior tile's start value and ``needs_wrap`` as
    ``fir1d_fixed_rows_mxu_window`` hands them to K3 (``fir_mxu.py:935-959``)."""
    seen = {}

    def record(x, bands, bias_tbl, entries, frac_bits, acc_bits, block_rows,
               needs_wrap, *rest):
        seen["bias"] = np.asarray(bias_tbl)
        seen["needs_wrap"] = bool(needs_wrap)
        return x

    monkeypatch.setattr(fir_mxu, "_fir_mxu_window", record)
    num_taps = np.asarray(h).size
    fir_mxu.fir1d_fixed_rows_mxu_window(
        np.zeros((1, 4 * num_taps + 512), np.uint8), h, qf)
    middle = seen["bias"].shape[0] // 2  # far from both row edges
    assert np.all(seen["bias"][middle] == seen["bias"][middle, 0])
    return int(seen["bias"][middle, 0]), seen["needs_wrap"]


@pytest.mark.parametrize("qf", FORMATS, ids=str)
def test_parameters_match_jax(monkeypatch, rng, qf):
    for h in (_taps(rng, qf, 258), _taps(rng, qf, 1001) / 64):
        fir = window.FixedFirWindow.from_numpy(h, qf)
        h_fixed = _fixed(h, qf)
        _, entries = fir_mxu.build_window_band_planes(h_fixed)
        assert fir.exponents == tuple(e[0] for e in entries)
        np.testing.assert_array_equal(fir.h_fixed.numpy(), h_fixed)
        bias, needs_wrap = _jax_bias_and_wrap(monkeypatch, h, qf)
        assert int(fir.bias) == bias == fir.bias_value
        assert bool(fir.needs_wrap) == needs_wrap == fir.wrap


def test_kernel_digit_words_rebuild_the_convolution(rng):
    """Kernel C's operand (reversed digits in quads, one table row per
    plane) rebuilds the same-mode sum of every plane."""
    for num_taps in (258, 301, 1001):
        h_fixed = rng.integers(-2**20, 2**20, size=num_taps)
        h_fixed[: num_taps // 3] = 0  # an uneven nonzero range
        fir = window.FixedFirWindow(h_fixed, QFormat(32, 12, 32))
        words = fir.kernel_digits.numpy()
        table = np.asarray(fir.plane_table).reshape(-1, window.PLANE_FIELDS)
        xs = rng.integers(-128, 128, size=4 * (128 + (num_taps + 3) // 4))
        total = np.zeros(512, np.int64)
        for exp, a0, quads, off in table:
            rd = words[4 * off : 4 * (off + quads)].astype(np.int64)
            for i in range(512):
                window_bytes = xs[i + 4 * a0 : i + 4 * (a0 + quads)]
                total[i] += int(rd @ window_bytes) << int(exp)
        # x~[n - k + center] is xs[left + i - k + center] for output i.
        k = np.arange(num_taps)
        direct = np.array([h_fixed @ xs[num_taps - 1 + i - k]
                           for i in range(512)])
        np.testing.assert_array_equal(total, direct)


@pytest.mark.parametrize("num_taps", [258, 511, 1001])
def test_plain_matches_window_kernel_beyond_tri_tile(rng, num_taps):
    h = design_lowpass(num_taps, 0.2)
    x = rng.integers(0, 256, size=(3, 1500), dtype=np.uint8)
    got = _plain(x, h)
    np.testing.assert_array_equal(
        got, np.asarray(fir_mxu.fir1d_fixed_rows_mxu_window(x, h, block_rows=8)))
    np.testing.assert_array_equal(got, fir1d_fixed_golden_rows(x, h))


def test_plain_wraparound(rng):
    """Large coefficients and a narrow accumulator force the wrap path."""
    qf = QFormat(acc_bits=16)
    h = np.array([qf.max_coeff_real, -8.0, 7.5] * 90)  # 270 taps
    x = rng.integers(0, 256, size=(2, 640), dtype=np.uint8)
    fir = window.FixedFirWindow.from_numpy(h, qf)
    assert fir.wrap
    got = window.fir_window_plain(torch.from_numpy(x), fir).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(fir_mxu.fir1d_fixed_rows_mxu_window(x, h, qf,
                                                           block_rows=8)))
    np.testing.assert_array_equal(got, fir1d_fixed_golden_rows(x, h, qf))


def test_plain_row_shorter_than_filter(rng):
    h = design_lowpass(258, 0.3)
    x = rng.integers(0, 256, size=(2, 64), dtype=np.uint8)
    got = _plain(x, h)
    np.testing.assert_array_equal(
        got, np.asarray(fir_mxu.fir1d_fixed_rows_mxu_window(x, h, block_rows=8)))
    np.testing.assert_array_equal(got, fir1d_fixed_golden_rows(x, h))


@pytest.mark.parametrize("tap", [3, 5])
def test_plain_filter_bank(rng, tap):
    """The windowed formulation covers small L too."""
    for name, h in FILTER_BANKS[tap].items():
        x = rng.integers(0, 256, size=(4, 300), dtype=np.uint8)
        h = np.asarray(h)
        got = _plain(x, h)
        np.testing.assert_array_equal(
            got, np.asarray(fir_mxu.fir1d_fixed_rows_mxu_window(x, h,
                                                               block_rows=8)),
            err_msg=name)
        np.testing.assert_array_equal(got, fir1d_fixed_golden_rows(x, h))


@pytest.mark.parametrize("qf", FORMATS, ids=str)
def test_plain_random_taps_golden(rng, qf):
    """Every format, up to five digit planes, ragged widths."""
    for num_taps, width in ((258, 1), (300, 127), (777, 1000), (4096, 600)):
        h = _taps(rng, qf, num_taps)
        x = rng.integers(0, 256, size=(2, width), dtype=np.uint8)
        np.testing.assert_array_equal(_plain(x, h, qf),
                                      fir1d_fixed_golden_rows(x, h, qf),
                                      err_msg=f"L={num_taps} N={width} {qf}")


def test_all_zero_filter(rng):
    fir = window.FixedFirWindow.from_numpy(np.zeros(300), QFormat())
    assert fir.exponents == (0,) and fir.tap_ranges == ((0, -1),)
    x = rng.integers(0, 256, size=(2, 40), dtype=np.uint8)
    assert not window.fir_window_plain(torch.from_numpy(x), fir).any()


def test_wrapper_on_cpu_is_plain(rng):
    h = design_lowpass(300, 0.2)
    x = torch.from_numpy(rng.integers(0, 256, size=(3, 200), dtype=np.uint8))
    before = window.fir_window.launches
    fir = window.FixedFirWindow.from_numpy(h)
    got = fir(x)
    assert window.fir_window.launches == before  # no kernel on a CPU tensor
    np.testing.assert_array_equal(got.numpy(),
                                  fir1d_fixed_golden_rows(x.numpy(), h))


def test_wrapper_rejects_bad_inputs(rng):
    fir = window.FixedFirWindow.from_numpy(design_lowpass(300, 0.2))
    x = torch.from_numpy(rng.integers(0, 256, size=(2, 8), dtype=np.uint8))
    with pytest.raises(TypeError, match="uint8"):
        fir(x.to(torch.int32))
    with pytest.raises(ValueError, match="rows"):
        fir(x[0])
    with pytest.raises(ValueError, match="device"):
        fir(x.to("meta"))


def test_module_buffers_move_with_the_module():
    fir = window.FixedFirWindow.from_numpy(design_lowpass(300, 0.2))
    assert set(fir.state_dict()) == {"h_fixed", "digits", "kernel_digits",
                                     "bias", "needs_wrap"}
    assert fir.kernel_digits.numel() % 4 == 0
    assert fir.to("meta").kernel_digits.device.type == "meta"


_KERNEL_HARNESS = """
#include <cstdint>
#include <vector>
#include "wft_window.cuh"
// fir_window.cu's kernel body: the shifted digit copies, then every warp
// item (one row's 512 columns), a warp's lanes as one unit.
extern "C" void fir_window_host(const uint8_t* x, uint8_t* y, long long rows,
                                long long n, const uint32_t* digits,
                                int planes, int taps, const int* table,
                                uint32_t bias, int wrap, int frac_bits,
                                int acc_bits) {
  const wft::WindowLayout lay = wft::window_layout(table, planes);
  const int left = taps - 1 - taps / 2;
  std::vector<uint32_t> ds(lay.copy_words + 1);
  for (int i = 0; i < lay.copy_words; ++i)
    ds[i] = wft::window_copy_word(digits, lay, i);
  std::vector<uint32_t> words(lay.buf_bytes / 4 + 1);
  uint8_t* buf = reinterpret_cast<uint8_t*>(words.data());
  for (long long r = 0; r < rows; ++r) {
    for (long long col0 = 0; col0 < n; col0 += wft::kWindowCols) {
      int off = 0;
      for (int lane = 0; lane < wft::kWarp; ++lane)
        off = wft::window_stage(buf, x, n, r, col0, left, lay, lane);
      wft::window_warp(buf, off, ds.data(), lay, bias, wrap != 0, frac_bits,
                       acc_bits, y, r, n, col0);
    }
  }
}
// One emulated mma.sync m16n8k32 over a warp's fragments (32 lanes each).
extern "C" void mma_host(uint32_t* a, uint32_t* b, int32_t* d) {
  wft::mma_s8(reinterpret_cast<int32_t (*)[4]>(d),
              reinterpret_cast<uint32_t (*)[4]>(a),
              reinterpret_cast<uint32_t (*)[2]>(b));
}
"""


@pytest.fixture(scope="module")
def kernel_core(tmp_path_factory):
    """Kernel C's core (``csrc/wft_window.cuh``) built with g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("fir_window")
    (work / "harness.cpp").write_text(_KERNEL_HARNESS)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(_build.CSRC_DIR), "-o", str(work / "lib.so"),
                    str(work / "harness.cpp")], check=True, timeout=120)
    lib = ctypes.CDLL(str(work / "lib.so"))
    lib.fir_window_host.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.mma_host.argtypes = [ctypes.c_void_p] * 3

    def run(x: np.ndarray, fir: window.FixedFirWindow) -> np.ndarray:
        """Kernel C's core on ``x`` (a C-contiguous array, possibly a view
        at any byte offset: the row alignment follows its address); the
        output starts as 0xAB, so an unwritten byte shows."""
        assert x.flags.c_contiguous
        y = np.full_like(x, 0xAB)
        words = np.ascontiguousarray(fir.kernel_digits.numpy())
        table = np.asarray(fir.plane_table, np.int32)
        qf = fir.qformat
        lib.fir_window_host(x.ctypes.data, y.ctypes.data, x.shape[0],
                            x.shape[1], words.ctypes.data,
                            len(fir.exponents), fir.num_taps,
                            table.ctypes.data, fir.bias_value & 0xFFFFFFFF,
                            int(fir.wrap), qf.frac_bits, qf.acc_bits)
        return y

    run.mma = lib.mma_host
    return run


@pytest.mark.parametrize("qf", FORMATS + [QFormat(16, 12, 16)], ids=str)
def test_kernel_core_matches_plain(kernel_core, rng, qf):
    """Ragged widths and row counts around the 512-column warp item, 1-5
    planes."""
    for num_taps, rows, width in ((258, 3, 1), (259, 9, 513), (1001, 2, 1500),
                                  (4096, 1, 700), (5, 8, 64)):
        h = _taps(rng, qf, num_taps)
        fir = window.FixedFirWindow.from_numpy(h, qf)
        x = rng.integers(0, 256, size=(rows, width), dtype=np.uint8)
        np.testing.assert_array_equal(
            kernel_core(x, fir),
            window.fir_window_plain(torch.from_numpy(x), fir).numpy(),
            err_msg=f"L={num_taps} rows={rows} N={width} {qf}")


def test_kernel_core_trimmed_planes(kernel_core, rng):
    """A long low-pass (trimmed high plane) and the all-zero filter."""
    x = rng.integers(0, 256, size=(4, 2000), dtype=np.uint8)
    for h in (design_lowpass(1001, 0.2), np.zeros(300)):
        fir = window.FixedFirWindow.from_numpy(h)
        np.testing.assert_array_equal(kernel_core(x, fir),
                                      fir1d_fixed_golden_rows(x, h))


def _fragments(a: np.ndarray, b: np.ndarray, d: np.ndarray):
    """A warp's fragments of mma.sync.aligned.m16n8k32.row.col with s8
    operands, from the PTX ISA's layout: lane 4g + t holds A rows g and
    g + 8 at k 4t..4t+3 and 16+4t..16+4t+3, B column g at the same k, D
    (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)."""
    def word(v):
        return int(np.ascontiguousarray(v, np.int8).view("<u4")[0])

    fa = np.zeros((32, 4), np.uint32)
    fb = np.zeros((32, 2), np.uint32)
    fd = np.zeros((32, 4), np.int32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for reg, (row, k) in enumerate(((g, 4 * t), (g + 8, 4 * t),
                                        (g, 16 + 4 * t), (g + 8, 16 + 4 * t))):
            fa[lane, reg] = word(a[row, k : k + 4])
        fb[lane, 0] = word(b[4 * t : 4 * t + 4, g])
        fb[lane, 1] = word(b[16 + 4 * t : 20 + 4 * t, g])
        for j in range(4):
            fd[lane, j] = d[g + 8 * (j >> 1), 2 * t + (j & 1)]
    return fa, fb, fd


@pytest.mark.parametrize("case", ["random", "extremes", "accumulate"])
def test_mma_emulation_matches_matmul(kernel_core, rng, case):
    """The host emulation of mma.sync m16n8k32 s8 (what the CPU tests run
    in place of the tensor cores) against a numpy matmul, from fragments
    packed here by the PTX layout."""
    a = rng.integers(-128, 128, size=(16, 32)).astype(np.int8)
    b = rng.integers(-128, 128, size=(32, 8)).astype(np.int8)
    d = np.zeros((16, 8), np.int32)
    if case == "extremes":
        a[:8], b[:, :4] = -128, -128
        a[8:], b[:, 4:] = 127, -128
    elif case == "accumulate":
        d = rng.integers(-2**30, 2**30, size=(16, 8)).astype(np.int32)
    fa, fb, fd = _fragments(a, b, d)
    kernel_core.mma(fa.ctypes.data, fb.ctypes.data, fd.ctypes.data)
    want = d.astype(np.int64) + a.astype(np.int64) @ b.astype(np.int64)
    got = np.zeros((16, 8), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(4):
            got[g + 8 * (j >> 1), 2 * t + (j & 1)] = fd[lane, j]
    np.testing.assert_array_equal(got, want)


GRID_TAPS = [1, 5, 33, 257, 258, 1001, 2048, 4096]
GRID_WIDTHS = [1, 17, 511, 512, 513, 4099]
GRID_ROWS = [1, 15, 16, 17, 33]
GRID_FORMATS = FORMATS + [QFormat(16, 12, 16)]


@pytest.mark.parametrize("width", GRID_WIDTHS)
@pytest.mark.parametrize("num_taps", GRID_TAPS)
def test_kernel_core_grid(kernel_core, rng, num_taps, width):
    """Every tap count at every width (odd widths start rows misaligned),
    the row counts and Q-formats (wrapping ones among them) in turn; the
    row count drops to 1 where taps × width × rows would pass 3·10^7."""
    i, j = GRID_TAPS.index(num_taps), GRID_WIDTHS.index(width)
    rows = GRID_ROWS[(i + j) % len(GRID_ROWS)]
    if num_taps * width * rows > 3e7:
        rows = 1
    qf = GRID_FORMATS[(i + 2 * j) % len(GRID_FORMATS)]
    fir = window.FixedFirWindow.from_numpy(_taps(rng, qf, num_taps), qf)
    x = rng.integers(0, 256, size=(rows, width), dtype=np.uint8)
    np.testing.assert_array_equal(
        kernel_core(x, fir),
        window.fir_window_plain(torch.from_numpy(x), fir).numpy(),
        err_msg=f"L={num_taps} rows={rows} N={width} {qf}")


def test_kernel_core_plane_past_32_bits(kernel_core, rng):
    """Taps near 2^31 need a fifth digit plane at exponent 32, which leaves
    nothing mod 2^32 and is skipped."""
    h_fixed = np.array([2**31 - 1, -(2**31 - 1), 12345, 2**30 + 7] * 70)
    fir = window.FixedFirWindow(h_fixed, QFormat(32, 12, 32))
    assert max(fir.exponents) >= 32
    x = rng.integers(0, 256, size=(3, 700), dtype=np.uint8)
    np.testing.assert_array_equal(
        kernel_core(x, fir),
        window.fir_window_plain(torch.from_numpy(x), fir).numpy())


@pytest.mark.parametrize("offset", [1, 2, 3, 7, 15])
def test_kernel_core_misaligned_input(kernel_core, rng, offset):
    """Rows at every alignment: a view at a byte offset of an aligned
    buffer; the staging copies whole 16-byte chunks only inside a row."""
    big = rng.integers(0, 256, size=5 * 1001 + 16, dtype=np.uint8)
    x = big[offset : offset + 5 * 1001].reshape(5, 1001)
    fir = window.FixedFirWindow.from_numpy(design_lowpass(1001, 0.2))
    np.testing.assert_array_equal(
        kernel_core(x, fir),
        window.fir_window_plain(torch.from_numpy(x.copy()), fir).numpy())
