"""Kernel H's plain version and entry point against the JAX package's K9.

The JAX function (``fir1d_ideal_rows_mxu``) runs its Pallas kernels in
interpret mode here.  Tolerances: against the JAX ``"highest"`` kernel
``rtol = atol = 1e-5`` on unit-scale samples
(``tests/test_fir_float_mxu.py:110``: two f32 computations of the same
sums), ``atol = 1e-3`` on u8 samples (``:80``); against the f64 golden an
SNR of at least
120 dB (the stricter JAX bound, ``tests/test_fir_float_mxu.py:69``).  The
kernel's own core runs on the host in ``test_torch_chain.py``.
"""

import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.kernels import fir_float_mxu
from warmup_fir_filter_tpu.models.golden import fir1d_ideal_golden_rows
from warmup_fir_filter_tpu.ops.fir1d import fir1d_ideal_rows_jnp
from warmup_fir_filter_tpu_torch.kernels import fir_float
from warmup_fir_filter_tpu_torch.models.filters import FILTER_BANKS
from warmup_fir_filter_tpu_torch.ops.fftfilt import snr_db
from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass


def test_band_planes_equal_jax(rng):
    for num_taps in (1, 2, 5, 63, 128, 129, 256, 257):
        h = rng.standard_normal(num_taps)
        for got, want in zip(fir_float.build_tile_band_planes_f32(h),
                             fir_float_mxu.build_tile_band_planes_f32(h)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="257"):
        fir_float.build_tile_band_planes_f32(np.ones(258))


@pytest.mark.parametrize("num_taps,width", [(1, 1), (2, 127), (5, 128),
                                            (63, 640), (64, 1000),
                                            (257, 300)])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_matches_jax_highest(rng, num_taps, width, dtype):
    """Unit-scale outputs (standard normal samples, taps scaled by
    1/sqrt(L)); u8 samples are 255 times larger, so their absolute
    tolerance is 1e-3 (``tests/test_fir_float_mxu.py:80``)."""
    h = rng.standard_normal(num_taps) / np.sqrt(num_taps)
    if dtype == "uint8":
        x = rng.integers(0, 256, size=(3, width), dtype=np.uint8)
    else:
        x = rng.standard_normal((3, width)).astype(np.float32)
    got = fir_float.fir1d_ideal_rows_band(torch.from_numpy(x), h,
                                          precision="highest")
    assert got.dtype == torch.float32 and got.shape == x.shape
    want = np.asarray(fir_float_mxu.fir1d_ideal_rows_mxu(
        x, h, precision="highest"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-3 if dtype == "uint8" else 1e-5)


@pytest.mark.parametrize("precision", ["bf16x3", "highest"])
def test_snr_against_golden(rng, precision):
    """Both names compute f32 sums: >= 120 dB against the f64 golden."""
    h = design_lowpass(63, 0.25)
    x = rng.uniform(0, 255, size=(4, 640)).astype(np.float32)
    got = fir_float.fir1d_ideal_rows_band(torch.from_numpy(x), h,
                                          precision=precision)
    assert snr_db(fir1d_ideal_golden_rows(x, h), got.numpy()) >= 120.0


@pytest.mark.parametrize("tap", [3, 5])
def test_filter_bank_against_golden(rng, tap):
    x = rng.integers(0, 256, size=(5, 137), dtype=np.uint8)
    for h in FILTER_BANKS[tap].values():
        got = fir_float.fir1d_ideal_rows_band(torch.from_numpy(x), h)
        np.testing.assert_allclose(got.numpy(), fir1d_ideal_golden_rows(x, h),
                                   rtol=1e-5, atol=1e-3)


def test_plain_is_float64_band_product(rng):
    h = rng.standard_normal(10)
    x = torch.from_numpy(rng.standard_normal((2, 300)))
    fir = fir_float.FloatFir1d(h)
    got = fir_float.fir_float_plain(x, fir)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(
        got.numpy(),
        fir1d_ideal_golden_rows(x.numpy(), h.astype(np.float32)),
        rtol=1e-12, atol=1e-12)


def test_long_filters_take_the_plain_path(monkeypatch, rng):
    """L > 257: ``fir1d_ideal_rows_torch``, as the JAX function takes its
    jnp path (``fir_float_mxu.py:587-590``); no kernel, no plain band."""
    def refuse(*args):
        raise AssertionError("band path taken for a long filter")

    monkeypatch.setattr(fir_float, "fir_float", refuse)
    h = design_lowpass(300, 0.2)
    x = rng.integers(0, 256, size=(2, 900), dtype=np.uint8)
    got = fir_float.fir1d_ideal_rows_band(torch.from_numpy(x), h)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(fir1d_ideal_rows_jnp(x, h)),
                               rtol=1e-5, atol=1e-3)


def test_other_dtypes_are_read_as_f32(rng):
    h = design_lowpass(31, 0.3)
    x = rng.standard_normal((2, 200))
    got = fir_float.fir1d_ideal_rows_band(torch.from_numpy(x), h)
    want = fir_float.fir1d_ideal_rows_band(
        torch.from_numpy(x.astype(np.float32)), h)
    assert torch.equal(got, want)


def test_validation(rng):
    x = torch.zeros((2, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="precision"):
        fir_float.fir1d_ideal_rows_band(x, [0.5, 0.5], precision="fast")
    fir = fir_float.FloatFir1d([0.5, 0.5])
    with pytest.raises(TypeError, match="samples"):
        fir_float.fir_float(x.to(torch.int32), fir)
    with pytest.raises(ValueError, match="rows"):
        fir_float.fir_float(torch.zeros(5, dtype=torch.uint8), fir)


def test_cpu_tensor_launches_no_kernel(rng):
    before = fir_float.fir_float.launches
    fir_float.fir1d_ideal_rows_band(
        torch.from_numpy(rng.integers(0, 256, size=(2, 300), dtype=np.uint8)),
        [0.25, 0.5, 0.25])
    assert fir_float.fir_float.launches == before
