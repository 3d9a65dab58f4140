"""Kernel A's parameters and plain version against the JAX band kernels.

The port carries the TPU band kernels' encoding across (digit planes,
exponents, tri-tile band planes, bias, ``needs_wrap``); these tests hold
each piece against ``warmup_fir_filter_tpu/kernels/fir_mxu.py`` and hold
``fir_band_plain`` (the band formulation in int64 matmuls) against
``fir1d_fixed_rows_mxu`` run in interpret mode, as the JAX tests run it on
the CPU.  The CUDA kernel itself is held to ``fir_band_plain`` on the card
by ``chip_smoke.py``.

Tolerances: every fixed-point comparison is ``np.array_equal`` (tolerance
0).  The f32 ideal path is held to ``atol=1e-2, rtol=1e-5`` elsewhere
(``tests/test_torch_fir1d.py``), the bound ``tests/test_fir1d_jnp.py:72``
uses.
"""

import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.kernels import fir_mxu
from warmup_fir_filter_tpu.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
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
