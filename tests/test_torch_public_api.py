"""The port's public surface against the JAX package's.

Each package ``__init__`` of the port exports what the JAX one exports,
and each kernel entry under a JAX name equals its JAX namesake on the CPU
(the Pallas kernels in interpret mode, as the JAX tests run them): the
fixed-point entries bit for bit (``np.array_equal``), the float entries at
the bounds of ``tests/test_fir_float_mxu.py`` and
``tests/test_resample_mxu.py``.  On a CPU tensor each entry runs its
kernel's plain version.
"""

import importlib

import numpy as np
import pytest
import torch

import warmup_fir_filter_tpu.kernels as jax_kernels
from warmup_fir_filter_tpu.kernels import fir_mxu as jax_fir_mxu
from warmup_fir_filter_tpu.kernels import resample_mxu as jax_resample_mxu
from warmup_fir_filter_tpu.kernels import window_copy as jax_window_copy
from warmup_fir_filter_tpu.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu.ops.qformat import QFormat as JaxQFormat
from warmup_fir_filter_tpu_torch import kernels
from warmup_fir_filter_tpu_torch.kernels.fir_window import (
    fir1d_fixed_rows_mxu_window,
)
from warmup_fir_filter_tpu_torch.kernels.resample import resample_poly_mxu
from warmup_fir_filter_tpu_torch.kernels.window_copy import window_rows_pallas
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

PACKAGES = ("", ".kernels", ".ops", ".models", ".pipeline")
#: (coeff_bits, frac_bits, acc_bits): the default, a wrap-needing
#: accumulator and a multi-digit format.
FORMATS = ((16, 12, 32), (16, 12, 20), (32, 24, 32))


@pytest.mark.parametrize("suffix", PACKAGES, ids=lambda s: s or "top")
def test_all_names_what_the_jax_package_names(suffix):
    jax_pkg = importlib.import_module("warmup_fir_filter_tpu" + suffix)
    port_pkg = importlib.import_module("warmup_fir_filter_tpu_torch" + suffix)
    assert port_pkg.__all__ == jax_pkg.__all__
    for name in port_pkg.__all__:
        assert getattr(port_pkg, name) is not None


def test_kernel_reexports_are_the_modules_functions():
    """The 2-D, FFT and dispatch entries ported earlier are re-exported,
    not copied."""
    from warmup_fir_filter_tpu_torch.kernels import dispatch, fft, fir2d

    for name in ("fir2d_fixed_mxu", "fir2d_fixed_frame", "pad_frame",
                 "fir2d_fixed_frame_overlap", "crop_frame_overlap",
                 "pad_frame_overlap"):
        assert getattr(kernels, name) is getattr(fir2d, name)
    for name in ("fft_rows_pallas", "fir_overlap_save_pallas",
                 "fir_overlap_save_quantized_pallas"):
        assert getattr(kernels, name) is getattr(fft, name)
    for name in ("fir1d_fixed_rows_auto", "fir2d_fixed_auto"):
        assert getattr(kernels, name) is getattr(dispatch, name)


def _fixed_cases(rng, taps):
    for fmt in FORMATS:
        for n in (1, 127, 300):
            h = rng.uniform(-1.5, 1.5, size=taps)
            x = rng.integers(0, 256, size=(3, n), dtype=np.uint8)
            yield fmt, h, x


@pytest.mark.parametrize("taps", [1, 3, 5, 64, 257])
def test_fir1d_fixed_rows_mxu_equals_jax(rng, taps):
    for fmt, h, x in _fixed_cases(rng, taps):
        got = kernels.fir1d_fixed_rows_mxu(torch.from_numpy(x), h,
                                           QFormat(*fmt))
        want = np.asarray(jax_kernels.fir1d_fixed_rows_mxu(
            x, h, JaxQFormat(*fmt), interpret=True))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(fmt))


@pytest.mark.parametrize("taps", [1, 5, 40])
def test_fir1d_fixed_rows_pallas_equals_jax(rng, taps):
    for fmt, h, x in _fixed_cases(rng, taps):
        got = kernels.fir1d_fixed_rows_pallas(torch.from_numpy(x), h,
                                              QFormat(*fmt))
        want = np.asarray(jax_kernels.fir1d_fixed_rows_pallas(
            x, h, JaxQFormat(*fmt), interpret=True))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(fmt))


@pytest.mark.parametrize("taps", [5, 300])
def test_fir1d_fixed_rows_mxu_window_equals_jax(rng, taps):
    for fmt, h, x in _fixed_cases(rng, taps):
        got = fir1d_fixed_rows_mxu_window(torch.from_numpy(x), h,
                                          QFormat(*fmt))
        want = np.asarray(jax_fir_mxu.fir1d_fixed_rows_mxu_window(
            x, h, JaxQFormat(*fmt), interpret=True))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(fmt))


def test_fixed_entries_raise_as_the_jax_ones():
    x = torch.zeros((2, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="257"):
        kernels.fir1d_fixed_rows_mxu(x, np.ones(258) / 258)
    for entry in (kernels.fir1d_fixed_rows_mxu,
                  kernels.fir1d_fixed_rows_pallas,
                  fir1d_fixed_rows_mxu_window):
        with pytest.raises(ValueError, match="acc_bits"):
            entry(x, [0.5, 0.5], QFormat(16, 12, 40))


@pytest.mark.parametrize("tap", [3, 5])
def test_fir1d_ideal_rows_mxu_equals_jax_bank(rng, tap):
    """``test_fir_float_mxu.py``'s bank case and bound."""
    for name, h in FILTER_BANKS[tap].items():
        x = rng.integers(0, 256, size=(4, 300), dtype=np.uint8)
        got = kernels.fir1d_ideal_rows_mxu(torch.from_numpy(x), h)
        want = np.asarray(jax_kernels.fir1d_ideal_rows_mxu(x, h, block_rows=8))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("precision", ["bf16x3", "highest"])
def test_fir1d_ideal_rows_mxu_equals_jax_63tap(rng, precision):
    h = design_lowpass(63, 0.25)
    x = rng.uniform(-3, 3, size=(2, 512)).astype(np.float32)
    got = kernels.fir1d_ideal_rows_mxu(torch.from_numpy(x), h,
                                       precision=precision)
    want = np.asarray(jax_kernels.fir1d_ideal_rows_mxu(
        x, h, precision=precision, block_rows=8))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("up,down", [(2, 3), (1, 2), (4, 3)])
def test_resample_poly_mxu_equals_jax(rng, up, down):
    """``test_resample_mxu.py``'s rate cases and bound."""
    h = design_lowpass(63, 0.8 / max(up, down), gain=up)
    x = rng.integers(0, 256, size=(3, 2000)).astype(np.float32)
    got = resample_poly_mxu(torch.from_numpy(x), h, up, down)
    want = np.asarray(jax_resample_mxu.resample_poly_mxu(x, h, up, down))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=0.02)


@pytest.mark.parametrize("channels,total,sub,g", [(2, 1024, 512, 1),
                                                  (3, 2048, 256, 4)])
def test_window_rows_pallas_equals_jax(rng, channels, total, sub, g):
    x = rng.integers(0, 256, size=(channels, total), dtype=np.uint8)
    carry = rng.integers(0, 256, size=(channels, 128), dtype=np.uint8)
    got = window_rows_pallas(torch.from_numpy(x), torch.from_numpy(carry),
                             sub, g)
    want = np.asarray(jax_window_copy.window_rows_pallas(x, carry, sub, g,
                                                         interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
