"""The port's plain PyTorch FIR paths against the JAX package and the golden.

``warmup_fir_filter_tpu_torch.ops.fir1d`` against
``warmup_fir_filter_tpu.ops.fir1d`` (the jnp paths), the Pallas direct-form
kernel K4 in interpret mode, and the numpy golden, on the same numpy-seeded
inputs.

Tolerances: every fixed-point comparison is ``np.array_equal`` (tolerance
0).  The f32 ideal path is held to the bound ``tests/test_fir1d_jnp.py:72``
uses, ``atol=1e-2, rtol=1e-5``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.kernels.fir_pallas import fir1d_fixed_rows_pallas
from warmup_fir_filter_tpu.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu.ops import fir1d as jax_fir1d
from warmup_fir_filter_tpu.ops.qformat import (
    bias_round_shift_np,
    saturate_pixel_np,
    wrap_to_acc_bits_np,
)
from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels.fir_direct import fir_direct
from warmup_fir_filter_tpu_torch.ops.fir1d import (
    fir1d_fixed_rows_torch,
    fir1d_ideal_rows_torch,
    fixed_epilogue_i32,
    fixed_fir_prehaloed_i32,
    pad_rows_same_mode,
)
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

#: (coeff_bits, frac_bits, acc_bits, num_taps): the SWEEP cells of
#: tests/test_qformat_sweep.py:30-40.
SWEEP = [
    (8, 4, 32, 3),
    (8, 7, 16, 7),
    (16, 12, 32, 5),
    (16, 12, 20, 5),
    (16, 8, 24, 11),
    (16, 15, 31, 4),
    (32, 24, 32, 3),
    (32, 12, 28, 6),
    (16, 1, 8, 2),
]


def _taps(rng, qf: QFormat, num_taps: int) -> np.ndarray:
    span = min(qf.max_coeff_real, 8.0)
    return np.clip(rng.uniform(-span, span, size=num_taps),
                   max(qf.min_coeff_real, -8.0), span)


def _port(x: np.ndarray, h, qf: QFormat) -> np.ndarray:
    return fir1d_fixed_rows_torch(torch.from_numpy(x), h, qf).numpy()


@pytest.mark.parametrize("coeff_bits,frac_bits,acc_bits,num_taps", SWEEP)
def test_fixed_torch_matches_jnp_and_golden_sweep(rng, coeff_bits, frac_bits,
                                                  acc_bits, num_taps):
    qf = QFormat(coeff_bits=coeff_bits, frac_bits=frac_bits, acc_bits=acc_bits)
    h = _taps(rng, qf, num_taps)
    x = rng.integers(0, 256, size=(3, 150), dtype=np.uint8)
    golden = fir1d_fixed_golden_rows(x, h, qf)
    np.testing.assert_array_equal(
        np.asarray(jax_fir1d.fir1d_fixed_rows_jnp(x, h, qf)), golden)
    np.testing.assert_array_equal(_port(x, h, qf), golden)


def _fuzz_cells(num_cells: int, seed: int) -> list:
    """Seeded (coeff_bits, frac_bits, acc_bits, taps, width) cells, drawn as
    ``tests/test_qformat_sweep.py:65-77`` draws them."""
    rng = np.random.default_rng(seed)
    tap_choices = np.array([1, 2, 3, 5, 63, 129, 257])
    cells = []
    for _ in range(num_cells):
        coeff_bits = int(rng.choice([8, 16, 32]))
        frac_bits = int(rng.integers(1, min(coeff_bits, 25)))
        acc_bits = int(rng.integers(8, 33))
        num_taps = int(rng.choice(tap_choices))
        width = int(rng.integers(num_taps, 600))
        cells.append((coeff_bits, frac_bits, acc_bits, num_taps, width))
    return cells


@pytest.mark.parametrize("batch_idx", range(5))
def test_fixed_torch_randomized_fuzz(batch_idx):
    """25 seeded cells in five batches: port vs jnp vs golden."""
    rng = np.random.default_rng(4242 + batch_idx)
    for cell in _fuzz_cells(num_cells=5, seed=20261016 + batch_idx):
        coeff_bits, frac_bits, acc_bits, num_taps, width = cell
        qf = QFormat(coeff_bits=coeff_bits, frac_bits=frac_bits,
                     acc_bits=acc_bits)
        h = _taps(rng, qf, num_taps)
        x = rng.integers(0, 256, size=(2, width), dtype=np.uint8)
        golden = fir1d_fixed_golden_rows(x, h, qf)
        np.testing.assert_array_equal(
            np.asarray(jax_fir1d.fir1d_fixed_rows_jnp(x, h, qf)), golden,
            err_msg=f"jnp {cell}")
        np.testing.assert_array_equal(_port(x, h, qf), golden,
                                      err_msg=f"torch {cell}")


@pytest.mark.parametrize("tap", [3, 5])
@pytest.mark.parametrize("name", ["moving_avg", "simple_lp", "edge", "sharpen"])
def test_fixed_torch_filter_bank(rng, tap, name):
    h = np.asarray(FILTER_BANKS[tap][name])
    x = rng.integers(0, 256, size=(4, 97), dtype=np.uint8)
    np.testing.assert_array_equal(
        _port(x, h, QFormat()),
        np.asarray(jax_fir1d.fir1d_fixed_rows_jnp(x, h)))


@pytest.mark.parametrize("acc_bits", [8, 12, 16, 20, 24, 31, 32])
def test_fixed_torch_wraparound(rng, acc_bits):
    qf = QFormat(acc_bits=acc_bits)
    h = np.array([qf.max_coeff_real, -8.0, qf.max_coeff_real])
    x = rng.integers(0, 256, size=(3, 64), dtype=np.uint8)
    np.testing.assert_array_equal(_port(x, h, qf),
                                  fir1d_fixed_golden_rows(x, h, qf))


def _random_accumulators(rng, frac_bits: int) -> np.ndarray:
    """Random int32 accumulators, exact rounding ties included."""
    acc = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64)
    acc[:64] = (rng.integers(-2**20, 2**20, size=64) << frac_bits) \
        + (1 << (frac_bits - 1))
    return ((acc + 2**31) % 2**32 - 2**31).astype(np.int32)


@pytest.mark.parametrize("frac_bits,acc_bits", [(1, 8), (12, 20), (12, 32),
                                                (24, 31), (30, 32), (15, 12)])
def test_fixed_epilogue_matches_jnp(rng, frac_bits, acc_bits):
    acc = _random_accumulators(rng, frac_bits)
    want = np.asarray(jax_fir1d.fixed_epilogue_i32(acc, frac_bits, acc_bits))
    got = fixed_epilogue_i32(torch.from_numpy(acc), frac_bits, acc_bits)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("frac_bits,acc_bits", [(12, 20), (31, 32), (31, 16)])
def test_fixed_epilogue_matches_golden(rng, frac_bits, acc_bits):
    """Against the golden's own steps.  At frac_bits=31 the jnp epilogue's
    ``low + 2^30`` overflows int32, so there the port follows the golden."""
    acc = _random_accumulators(rng, frac_bits)
    want = _golden_epilogue(acc, frac_bits, acc_bits)
    got = fixed_epilogue_i32(torch.from_numpy(acc), frac_bits, acc_bits)
    np.testing.assert_array_equal(got.numpy(), want)


_EPILOGUE_HARNESS = """
#include <cstdint>
#include "wft_fixed.cuh"
extern "C" void epilogue(const uint32_t* acc, uint8_t* out, long n, int wrap,
                         int frac_bits, int acc_bits) {
  for (long i = 0; i < n; ++i)
    out[i] = wft::fixed_epilogue(acc[i], wrap != 0, frac_bits, acc_bits);
}
"""


@pytest.fixture(scope="module")
def cuda_epilogue(tmp_path_factory):
    """``csrc/wft_fixed.cuh`` (the kernels' epilogue) built with g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("epilogue")
    (work / "harness.cpp").write_text(_EPILOGUE_HARNESS)
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(_build.CSRC_DIR), "-o", str(work / "lib.so"),
                    str(work / "harness.cpp")], check=True, timeout=120)
    lib = ctypes.CDLL(str(work / "lib.so"))
    lib.epilogue.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int]

    def run(acc_i32: np.ndarray, wrap: bool, frac_bits: int, acc_bits: int):
        acc = np.ascontiguousarray(acc_i32.astype(np.int32).view(np.uint32))
        out = np.empty(acc.shape, np.uint8)
        lib.epilogue(acc.ctypes.data, out.ctypes.data, acc.size, int(wrap),
                     frac_bits, acc_bits)
        return out

    return run


def _golden_epilogue(acc: np.ndarray, frac_bits: int, acc_bits: int):
    return saturate_pixel_np(bias_round_shift_np(
        wrap_to_acc_bits_np(acc.astype(np.int64), acc_bits), frac_bits))


@pytest.mark.parametrize("frac_bits,acc_bits", [(1, 8), (12, 20), (12, 32),
                                                (24, 31), (31, 32), (15, 12)])
def test_cuda_epilogue_header_matches_golden(cuda_epilogue, rng, frac_bits,
                                             acc_bits):
    """The kernels' own epilogue code: wrap path on any accumulator, fast
    path (rounding bias pre-added, no wrap possible) on in-range ones."""
    acc = _random_accumulators(rng, frac_bits)
    np.testing.assert_array_equal(cuda_epilogue(acc, True, frac_bits, acc_bits),
                                  _golden_epilogue(acc, frac_bits, acc_bits))
    limit = (1 << (acc_bits - 1)) - (1 << (frac_bits - 1))
    if limit > 0:
        fits = acc[(acc > -limit) & (acc < limit)].astype(np.int64)
        biased = fits + (1 << (frac_bits - 1))
        np.testing.assert_array_equal(
            cuda_epilogue(biased, False, frac_bits, acc_bits),
            _golden_epilogue(fits, frac_bits, acc_bits))


@pytest.mark.parametrize("num_taps", [1, 2, 5, 8])
def test_pad_rows_same_mode_matches_jnp(rng, num_taps):
    x = rng.integers(0, 256, size=(2, 9), dtype=np.uint8)
    np.testing.assert_array_equal(
        pad_rows_same_mode(torch.from_numpy(x), num_taps).numpy(),
        np.asarray(jax_fir1d.pad_rows_same_mode(x, num_taps)))


def test_fixed_torch_rejects_wide_acc(rng):
    x = torch.from_numpy(rng.integers(0, 256, size=(1, 8), dtype=np.uint8))
    with pytest.raises(ValueError, match="int32 sim path"):
        fir1d_fixed_rows_torch(x, [0.5], QFormat(acc_bits=48))


def test_single_sample_row():
    h = np.array([0.25, 0.5, 0.25])
    x = np.array([[200]], dtype=np.uint8)
    np.testing.assert_array_equal(_port(x, h, QFormat()),
                                  fir1d_fixed_golden_rows(x, h))


@pytest.mark.parametrize("tap", [3, 5])
def test_ideal_torch_close_to_jnp(rng, tap):
    for h in FILTER_BANKS[tap].values():
        h = np.asarray(h)
        x = rng.integers(0, 256, size=(4, 257), dtype=np.uint8)
        want = np.asarray(jax_fir1d.fir1d_ideal_rows_jnp(x, h), np.float64)
        got = fir1d_ideal_rows_torch(torch.from_numpy(x), h)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy().astype(np.float64), want,
                                   atol=1e-2, rtol=1e-5)


@pytest.mark.parametrize("num_taps", [5, 300])
def test_fixed_torch_matches_pallas_direct_kernel(rng, num_taps):
    """K4 in interpret mode; its port's plain version on the same input."""
    qf = QFormat(coeff_bits=16, frac_bits=12, acc_bits=24)
    h = _taps(rng, qf, num_taps)
    x = rng.integers(0, 256, size=(3, 333), dtype=np.uint8)
    want = np.asarray(fir1d_fixed_rows_pallas(x, h, qf))
    np.testing.assert_array_equal(_port(x, h, qf), want)
    np.testing.assert_array_equal(
        fir_direct(torch.from_numpy(x), h, qf).numpy(), want)


def test_fixed_torch_4097_taps_golden(rng):
    """Past every band limit; the JAX interpret path would unroll 4,097 ops."""
    qf = QFormat(coeff_bits=32, frac_bits=20, acc_bits=32)
    h = rng.uniform(-0.01, 0.01, size=4097)
    x = rng.integers(0, 256, size=(2, 600), dtype=np.uint8)
    np.testing.assert_array_equal(_port(x, h, qf),
                                  fir1d_fixed_golden_rows(x, h, qf))


def _prehaloed_case(rng, num_taps: int):
    """u8 rows with their halo columns as int32, and int32 taps spread over
    the whole int32 range, so that products and sums wrap."""
    x_ext = rng.integers(0, 256, size=(3, 200 + num_taps - 1)).astype(np.int32)
    taps = rng.integers(-2**31, 2**31, size=num_taps).astype(np.int32)
    return x_ext, taps


@pytest.mark.parametrize("form", ["position", "keyword"])
@pytest.mark.parametrize("num_taps", [1, 5, 63])
def test_prehaloed_core_takes_the_jax_call(rng, num_taps, form):
    """The JAX signature ``(x_ext_i32, h_fixed_i32, num_taps, frac_bits,
    acc_bits)`` at acc_bits 32, where the int32 sums wrap: bit-equal to the
    JAX core, the taps given as a numpy array, a list or a tensor."""
    x_ext, taps = _prehaloed_case(rng, num_taps)
    args = (num_taps, 12, 32)
    if form == "position":
        want = jax_fir1d.fixed_fir_prehaloed_i32(x_ext, taps, *args)
    else:
        want = jax_fir1d.fixed_fir_prehaloed_i32(
            x_ext_i32=x_ext, h_fixed_i32=taps, num_taps=num_taps,
            frac_bits=12, acc_bits=32)
    want = np.asarray(want)
    for h in (taps, taps.tolist(), torch.from_numpy(taps)):
        if form == "position":
            got = fixed_fir_prehaloed_i32(torch.from_numpy(x_ext), h, *args)
        else:
            got = fixed_fir_prehaloed_i32(
                x_ext_i32=torch.from_numpy(x_ext), h_fixed_i32=h,
                num_taps=num_taps, frac_bits=12, acc_bits=32)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_taps", [1, 5, 63])
def test_prehaloed_core_refuses_a_wrong_tap_count(rng, num_taps):
    """The JAX core reads ``h_fixed_i32[k]`` for k < num_taps: a count
    below the taps' drops the last ones, and one above repeats the last tap
    (jnp clamps the index) or raises ``IndexError`` (a numpy array).  The
    port raises ``ValueError`` for either."""
    x_ext, taps = _prehaloed_case(rng, num_taps)
    for wrong in (num_taps - 1, num_taps + 1):
        with pytest.raises(ValueError, match="num_taps"):
            fixed_fir_prehaloed_i32(torch.from_numpy(x_ext), taps, wrong,
                                    12, 32)
