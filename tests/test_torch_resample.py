"""The port's resampler (``ops/resample.py``, kernel I's plain version)
against the JAX package's.

Tolerances: the band path against the f64 golden and the JAX
``resample_poly_mxu(precision="highest")`` at ``rtol=1e-6, atol=1e-3``
(``tests/test_resample_mxu.py:85``); the exact slice path against the JAX
slice path at ``rtol=atol=1e-5`` (the same f32 sums in the same order,
differing only where one compiler fuses a multiply-add); the fixed path
``np.array_equal`` to the fixed golden.  Kernel I's core runs on the host
in ``test_torch_chain.py``.
"""

import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.kernels import resample_mxu
from warmup_fir_filter_tpu.ops import resample as jax_resample
from warmup_fir_filter_tpu_torch.kernels import resample as port_kernel
from warmup_fir_filter_tpu_torch.ops import resample as port_resample
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

#: (up, down): the chain's, larger upsample, pure upsample, deep polyphase,
#: pure decimation.
RATES = [(2, 3), (4, 3), (2, 1), (8, 5), (1, 2)]


def test_design_and_plans_equal_jax():
    for num_taps, cutoff, gain in ((63, 0.3, 2.0), (33, 0.25, 1.0),
                                   (1001, 0.2, 1.0), (8, 0.9, 3.0)):
        np.testing.assert_array_equal(
            port_resample.design_lowpass(num_taps, cutoff, gain=gain),
            jax_resample.design_lowpass(num_taps, cutoff, gain=gain))
    h = port_resample.design_lowpass(47, 0.3)
    for up, down in RATES + [(3, 7)]:
        for got, want in zip(port_resample._plan(1000, up, down, 47),
                             jax_resample._plan(1000, up, down, 47)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(port_resample._polyphase_taps(h, up),
                                      jax_resample._polyphase_taps(h, up))
        assert (port_resample._phase_plan(up, down, 23, 333)
                == jax_resample._phase_plan(up, down, 23, 333))
    with pytest.raises(ValueError, match="coprime"):
        port_resample._plan(10, 2, 4, 5)
    with pytest.raises(ValueError, match="cutoff"):
        port_resample.design_lowpass(5, 1.0)


@pytest.mark.parametrize("up,down", RATES)
def test_band_equals_jax(up, down):
    h = port_resample.design_lowpass(63, 0.3, gain=up)
    for got, want in zip(port_kernel.build_resample_band(h, up, down),
                         resample_mxu.build_resample_band(h, up, down)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("up,down", RATES)
def test_goldens_equal_jax(rng, up, down):
    h = port_resample.design_lowpass(31, 0.3, gain=up)
    x = rng.integers(0, 256, size=(2, 301), dtype=np.uint8)
    np.testing.assert_array_equal(
        port_resample.resample_poly_golden(x, h, up, down),
        jax_resample.resample_poly_golden(x, h, up, down))
    for fmt in ((16, 12, 32), (16, 12, 20), (8, 4, 32)):
        np.testing.assert_array_equal(
            port_resample.resample_poly_fixed_golden(x, h, up, down,
                                                     QFormat(*fmt)),
            jax_resample.resample_poly_fixed_golden(x, h, up, down,
                                                    QFormat(*fmt)))


@pytest.mark.parametrize("up,down", RATES)
def test_band_path_matches_golden_and_jax(rng, up, down):
    h = port_resample.design_lowpass(63, 0.3, gain=up)
    x = rng.integers(0, 256, size=(2, 1500)).astype(np.float32)
    got = port_resample.resample_poly(torch.from_numpy(x), h, up, down,
                                      precision="highest")
    assert got.dtype == torch.float32
    gold = port_resample.resample_poly_golden(x, h, up, down)
    assert got.shape == gold.shape == (2, -(-1500 * up // down))
    np.testing.assert_allclose(got.numpy(), gold, rtol=1e-6, atol=1e-3)
    want = np.asarray(resample_mxu.resample_poly_mxu(x, h, up, down,
                                                     precision="highest"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("up,down", RATES + [(3, 2)])
def test_exact_path_matches_jax(rng, up, down):
    """The slice path; (3, 2) has ``128 % up != 0`` and no band path."""
    h = port_resample.design_lowpass(47, 0.3, gain=up)
    x = rng.standard_normal((3, 777)).astype(np.float32)
    got = port_resample.resample_poly(torch.from_numpy(x), h, up, down,
                                      precision="exact")
    want = np.asarray(jax_resample.resample_poly(x, h, up, down,
                                                 precision="exact"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), port_resample.resample_poly_golden(x, h, up, down),
        rtol=1e-5, atol=1e-5)


def test_auto_on_cpu_is_the_exact_path(monkeypatch, rng):
    """As the JAX package picks its slice path off the TPU."""
    def refuse(*args, **kwargs):
        raise AssertionError("band path taken on a CPU tensor")

    monkeypatch.setattr(port_kernel, "resample_poly_band", refuse)
    x = torch.from_numpy(rng.standard_normal((2, 500)).astype(np.float32))
    h = port_resample.design_lowpass(63, 0.3, gain=2)
    got = port_resample.resample_poly(x, h, 2, 3)
    assert torch.equal(got, port_resample.resample_poly(x, h, 2, 3,
                                                        precision="exact"))


@pytest.mark.parametrize("up,down", RATES)
@pytest.mark.parametrize("fmt", [(16, 12, 32), (16, 12, 20), (8, 4, 32),
                                 (32, 24, 32)], ids=str)
def test_fixed_path_bit_exact(rng, up, down, fmt):
    qf = QFormat(*fmt)
    span = min(qf.max_coeff_real, 8.0)
    h = rng.uniform(-span, span, size=21)
    x = rng.integers(0, 256, size=(3, 257), dtype=np.uint8)
    got = port_resample.resample_poly_fixed(torch.from_numpy(x), h, up, down,
                                            qf)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), port_resample.resample_poly_fixed_golden(x, h, up, down,
                                                              qf))


def test_fixed_path_refuses_wide_accumulators():
    with pytest.raises(ValueError, match="acc_bits=48"):
        port_resample.resample_poly_fixed(torch.zeros((1, 8), dtype=torch.uint8),
                                          [1.0], 1, 1, QFormat(32, 12, 48))


def test_long_branches_and_ragged_tails(rng):
    """Any branch length (J = 80 here, past the JAX one-tile halo budget)
    and lengths around a 1,024-output tile."""
    up, down = 2, 3
    h = port_resample.design_lowpass(160, 0.3, gain=up)
    for n in (1, 2, 1535, 1536, 1537, 3000):
        x = rng.standard_normal((2, n)).astype(np.float32)
        got = port_kernel.resample_poly_band(torch.from_numpy(x), h, up, down)
        np.testing.assert_allclose(
            got.numpy(), port_resample.resample_poly_golden(x, h, up, down),
            rtol=1e-6, atol=1e-5)


def test_validation(rng):
    x = torch.zeros((2, 300))
    with pytest.raises(ValueError, match="precision"):
        port_resample.resample_poly(x, [1.0], 2, 3, precision="fast")
    with pytest.raises(ValueError, match="precision"):
        port_kernel.resample_poly_band(x, [1.0], 2, 3, precision="exact")
    with pytest.raises(ValueError, match="up | 128"):
        port_kernel.PolyphaseResampler([1.0, 1.0, 1.0], 3, 2)
    with pytest.raises(ValueError, match="coprime"):
        port_kernel.PolyphaseResampler([1.0], 2, 4)
    rs = port_kernel.PolyphaseResampler([1.0], 2, 3)
    with pytest.raises(TypeError, match="samples"):
        port_kernel.resample(x.to(torch.float64), rs)


def test_cpu_tensor_launches_no_kernel(rng):
    before = port_kernel.resample.launches
    x = torch.from_numpy(rng.standard_normal((2, 300)).astype(np.float32))
    port_resample.resample_poly(x, [0.5, 1.0, 0.5], 2, 3, precision="highest")
    assert port_kernel.resample.launches == before


@pytest.mark.parametrize("up,down", RATES + [(4, 5), (1, 4), (128, 3)])
def test_conv1d_yardstick_is_kernel_i_function(rng, up, down):
    """``yardsticks.py``'s ``F.conv1d`` yardstick for kernel I (P output
    channels at stride Q, interleaved) computes ``resample_plain``'s
    function: f32 against float64, SNR >= 120 dB, at ragged lengths."""
    from warmup_fir_filter_tpu_torch.ops.fftfilt import snr_db
    from yardsticks import conv1d_resample, conv1d_resampler

    h = port_resample.design_lowpass(63, 0.9 / max(up, down), gain=up)
    rs = port_kernel.PolyphaseResampler(h, up, down)
    weight, pad = conv1d_resampler(rs)
    for n in (1, 5, 700, 3001):
        x = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
        got = conv1d_resample(x, weight, pad, rs)
        want = port_kernel.resample_plain(x, rs)
        assert got.shape == want.shape
        assert snr_db(want.numpy(), got.numpy()) >= 120.0, n
