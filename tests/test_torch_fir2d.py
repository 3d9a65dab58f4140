"""The port's 2-D FIR ops (``ops/fir2d.py``) against the JAX package's.

The numpy golden copies and ``FILTER_BANK_2D`` must equal the JAX
module's; ``fir2d_fixed_torch`` and ``fixed_fir2d_prehaloed_i32`` must equal
``fir2d_fixed_jnp`` and its pre-haloed core, and BASELINE config 3 (5×5
gauss5 over 512 × 512, ``bench_configs.py:72-92``) must pass through the
port's ``fir2d_fixed_auto``.

Tolerances: fixed-point results are ``np.array_equal`` (tolerance 0); the
f32 model is held to ``atol=1e-2`` of the float64 golden, the bound of
``tests/test_fir2d.py:93``; config 3's RMSE against the ideal golden to
< 0.5, its acceptance bound.
"""

import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.ops import fir2d as jax_fir2d
from warmup_fir_filter_tpu_torch.kernels.dispatch import fir2d_fixed_auto
from warmup_fir_filter_tpu_torch.ops import fir2d
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

BANK = sorted(jax_fir2d.FILTER_BANK_2D)
FORMATS = [QFormat(), QFormat(acc_bits=20), QFormat(8, 4, 32),
           QFormat(32, 24, 32), QFormat(16, 12, 48)]


def test_filter_bank_matches_jax():
    assert sorted(fir2d.FILTER_BANK_2D) == BANK
    for name in BANK:
        got, want = fir2d.FILTER_BANK_2D[name], jax_fir2d.FILTER_BANK_2D[name]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("shape", [(1, 1), (2, 4), (3, 3), (4, 1), (5, 6)])
def test_pad_2d_matches_jax(rng, shape):
    x = rng.integers(0, 256, size=(7, 9), dtype=np.uint8)
    want = jax_fir2d._pad_2d(x, *shape, np)
    np.testing.assert_array_equal(fir2d.pad_2d(x, *shape), want)
    np.testing.assert_array_equal(
        fir2d.pad_2d(torch.from_numpy(x), *shape).numpy(), want)


@pytest.mark.parametrize("qf", FORMATS, ids=str)
@pytest.mark.parametrize("name", BANK + ["random", "even"])
def test_golden_copies_match_jax(rng, name, qf):
    h = {"random": lambda: rng.uniform(-3.0, 3.0, size=(3, 7)),
         "even": lambda: rng.uniform(-0.5, 0.5, size=(4, 2))}.get(
             name, lambda: fir2d.FILTER_BANK_2D[name])()
    x = rng.integers(0, 256, size=(19, 23), dtype=np.uint8)
    np.testing.assert_array_equal(fir2d.fir2d_fixed_golden(x, h, qf),
                                  jax_fir2d.fir2d_fixed_golden(x, h, qf))
    np.testing.assert_array_equal(fir2d.fir2d_ideal_golden(x, h),
                                  jax_fir2d.fir2d_ideal_golden(x, h))


@pytest.mark.parametrize("qf", [QFormat(), QFormat(acc_bits=20)], ids=str)
@pytest.mark.parametrize("name", BANK)
def test_fixed_torch_matches_jnp(rng, name, qf):
    h = fir2d.FILTER_BANK_2D[name]
    x = rng.integers(0, 256, size=(37, 53), dtype=np.uint8)
    got = fir2d.fir2d_fixed_torch(torch.from_numpy(x), h, qf)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_fir2d.fir2d_fixed_jnp(x, h, qf)))
    np.testing.assert_array_equal(got.numpy(),
                                  fir2d.fir2d_fixed_golden(x, h, qf))


@pytest.mark.parametrize("case", BANK + ["5x5", "2x4", "1x7", "4x1"])
def test_prehaloed_core_matches_jax(rng, case):
    """The core over a block whose halo rows and columns hold real samples
    (the shard-with-neighbours case of ``parallel/halo.py``): every bank
    filter, and random taps large enough to wrap at 20 bits."""
    qf = QFormat(acc_bits=20)
    h = (fir2d.FILTER_BANK_2D[case] if case in BANK else rng.uniform(
        -7.5, 7.5, size=tuple(int(d) for d in case.split("x"))))
    h_fixed = qf.quantize_coeffs(h).astype(np.int32)
    taps_r, taps_c = h_fixed.shape
    x_ext = rng.integers(0, 256, size=(16 + taps_r - 1, 24 + taps_c - 1)
                         ).astype(np.int32)
    got = fir2d.fixed_fir2d_prehaloed_i32(
        torch.from_numpy(x_ext), h_fixed, taps_r, taps_c, qf.frac_bits,
        qf.acc_bits)
    want = jax_fir2d.fixed_fir2d_prehaloed_i32(
        x_ext, h_fixed, taps_r, taps_c, qf.frac_bits, qf.acc_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fixed_torch_wraparound(rng):
    """``tests/test_fir2d.py:57``: a 5×5 of 7.5s needs the 20-bit wrap."""
    qf = QFormat(acc_bits=20)
    h = np.full((5, 5), 7.5)
    x = rng.integers(0, 256, size=(16, 24), dtype=np.uint8)
    np.testing.assert_array_equal(
        fir2d.fir2d_fixed_torch(torch.from_numpy(x), h, qf).numpy(),
        fir2d.fir2d_fixed_golden(x, h, qf))


def test_wide_accumulator_rejected_as_jax_does():
    x = torch.zeros((4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="int32 TPU sim path") as port:
        fir2d.fir2d_fixed_torch(x, np.ones((3, 3)), QFormat(acc_bits=48))
    with pytest.raises(ValueError, match="int32 TPU sim path") as ref:
        jax_fir2d.fir2d_fixed_jnp(x.numpy(), np.ones((3, 3)),
                                  QFormat(acc_bits=48))
    assert str(port.value) == str(ref.value)


def test_ideal_torch_gauss5_512(rng):
    x = rng.integers(0, 256, size=(512, 512), dtype=np.uint8)
    h = fir2d.FILTER_BANK_2D["gauss5"]
    got = fir2d.fir2d_ideal_torch(torch.from_numpy(x), h)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), fir2d.fir2d_ideal_golden(x, h),
                               atol=1e-2)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_fir2d.fir2d_ideal_jnp(x, h)),
                               atol=1e-2)


def test_config3_through_auto():
    """BASELINE config 3 as ``bench_configs.py:72-92`` runs it (seed 3)."""
    x = np.random.default_rng(3).integers(0, 256, size=(512, 512),
                                          dtype=np.uint8)
    h = fir2d.FILTER_BANK_2D["gauss5"]
    sim = fir2d_fixed_auto(torch.from_numpy(x), h).numpy()
    np.testing.assert_array_equal(sim, fir2d.fir2d_fixed_golden(x, h))
    model = fir2d.fir2d_ideal_golden(x, h)
    rmse = float(np.sqrt(np.mean((sim.astype(np.float64) - model) ** 2)))
    assert rmse < 0.5
