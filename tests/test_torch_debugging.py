"""The port's ``nan_guard`` and ``assert_deterministic`` against the JAX
package's.

The JAX guard sets ``jax_debug_nans`` only, so under both guards an op
that produces a NaN (``0/0``) raises ``FloatingPointError`` and one that
produces an Inf (``1/0``) passes.  The port's guard also reaches the
hand-written kernels, which the dispatcher never sees: on a CPU tensor
their plain versions run as aten ops, and on a CUDA one their wrappers
check the output (``check_kernel_output``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.ops.fir1d import fir1d_fixed_rows_jnp
from warmup_fir_filter_tpu.utils import debugging as jax_debugging
from warmup_fir_filter_tpu_torch.kernels.fft import fft_rows
from warmup_fir_filter_tpu_torch.kernels.fir_float import (
    FloatFir1d,
    fir_float,
)
from warmup_fir_filter_tpu_torch.kernels.resample import (
    PolyphaseResampler,
    resample,
)
from warmup_fir_filter_tpu_torch.ops.fir1d import fir1d_fixed_rows_torch
from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass
from warmup_fir_filter_tpu_torch.utils.debugging import (
    assert_deterministic,
    check_kernel_output,
    nan_guard,
    nan_guard_active,
)


def _jax_divide(numerator: float):
    return jax.jit(lambda x: x / 0.0)(jnp.float32(numerator)).block_until_ready()


def _port_divide(numerator: float):
    return torch.tensor(numerator, dtype=torch.float32) / 0.0


def test_zero_over_zero_raises_under_both_guards():
    with jax_debugging.nan_guard():
        with pytest.raises(FloatingPointError):
            _jax_divide(0.0)
    with nan_guard():
        with pytest.raises(FloatingPointError, match="div"):
            _port_divide(0.0)


def test_one_over_zero_passes_under_both_guards():
    with jax_debugging.nan_guard():
        want = float(_jax_divide(1.0))
    with nan_guard():
        got = float(_port_divide(1.0))
    assert got == want == float("inf")


def test_complex_nan_raises():
    z = torch.complex(torch.zeros(2), torch.zeros(2))
    with nan_guard():
        with pytest.raises(FloatingPointError):
            z / 0.0


def test_state_restored_on_exit():
    before = jax.config.jax_debug_nans
    with jax_debugging.nan_guard():
        pass
    assert jax.config.jax_debug_nans == before
    assert not nan_guard_active()
    with nan_guard():
        assert nan_guard_active()
    assert not nan_guard_active()
    assert torch.isnan(_port_divide(0.0))


def test_state_restored_after_an_exception():
    with pytest.raises(FloatingPointError):
        with nan_guard():
            _port_divide(0.0)
    assert not nan_guard_active()
    with pytest.raises(KeyError):
        with nan_guard():
            raise KeyError("boom")
    assert not nan_guard_active()


def test_nested_guards():
    """As with the JAX flag: the inner guard changes nothing and leaves
    the outer one active when it exits."""
    with jax_debugging.nan_guard():
        with jax_debugging.nan_guard():
            pass
        assert jax.config.jax_debug_nans
    with nan_guard():
        with nan_guard():
            with pytest.raises(FloatingPointError):
                _port_divide(0.0)
        assert nan_guard_active()
        with pytest.raises(FloatingPointError):
            _port_divide(0.0)
    assert not nan_guard_active()


def test_disabled_passthrough():
    with jax_debugging.nan_guard(enabled=False):
        out = jax.jit(lambda x: x * 0.0)(jnp.float32(1.0))
    assert float(out) == 0.0
    with nan_guard(enabled=False):
        assert not nan_guard_active()
        assert torch.isnan(_port_divide(0.0))


def test_views_and_allocations_are_not_checked():
    """A view or a fresh allocation produces no value; the first op that
    computes from the NaN raises."""
    x = torch.tensor([1.0, float("nan")])
    with nan_guard():
        torch.empty(1000)
        x[1:]
        with pytest.raises(FloatingPointError, match="add"):
            x + 0.0


def _nan_rows(shape, dtype=torch.float32) -> torch.Tensor:
    x = torch.ones(shape, dtype=dtype)
    x[0, shape[1] // 2] = float("nan")
    return x


@pytest.mark.parametrize("kernel", ["fir_float", "resample", "fft_rows"])
def test_plain_kernel_nan_output_raises(kernel):
    """A kernel's plain version (its CPU path) under the guard raises at
    its first op, and runs without a guard."""
    run = {
        "fir_float": lambda x: fir_float(x, FloatFir1d(np.ones(5) / 5,
                                                       "cpu")),
        "resample": lambda x: resample(x, PolyphaseResampler(
            design_lowpass(31, 0.2), 2, 3, "cpu")),
        "fft_rows": lambda x: fft_rows(x, None, inverse=False),
    }[kernel]
    x = _nan_rows((2, 64))
    out = run(x)
    assert torch.isnan(out[0] if isinstance(out, tuple) else out).any()
    with nan_guard():
        with pytest.raises(FloatingPointError, match="nan_guard"):
            run(x)
        run(torch.ones(2, 64))


def test_kernel_output_check_only_under_a_guard():
    nan = _nan_rows((1, 4))
    check_kernel_output("fir_float", nan)  # no guard: costs a look only
    with nan_guard():
        check_kernel_output("fir_float", torch.ones(3),
                            torch.ones(2, dtype=torch.uint8))
        with pytest.raises(FloatingPointError, match="kernel fft_rows"):
            check_kernel_output("fft_rows", torch.ones(3), nan)


def test_assert_deterministic_passes_for_fixed_path(rng):
    x = rng.integers(0, 256, size=(3, 64), dtype=np.uint8)
    h = [0.25, 0.5, 0.25]
    jax_debugging.assert_deterministic(lambda: fir1d_fixed_rows_jnp(x, h))
    assert_deterministic(lambda: fir1d_fixed_rows_torch(torch.from_numpy(x), h))
    assert_deterministic(fir1d_fixed_rows_torch, torch.from_numpy(x), h,
                         runs=3)


def test_assert_deterministic_walks_trees():
    out = {"a": (torch.ones(2), torch.zeros(3, dtype=torch.bfloat16)),
           "b": [np.arange(4), 7]}
    assert_deterministic(lambda: out)


def _flaky():
    state = {"n": 0}

    def run():
        state["n"] += 1
        return np.array([state["n"]])

    return run


@pytest.mark.parametrize("wrap", [np.asarray, torch.as_tensor,
                                  lambda a: {"y": (torch.as_tensor(a),)}],
                         ids=["numpy", "tensor", "tree"])
def test_assert_deterministic_detects_mutation(wrap):
    messages = []
    for check in (jax_debugging.assert_deterministic, assert_deterministic):
        flaky = _flaky()
        with pytest.raises(AssertionError, match="Non-deterministic") as info:
            check(lambda: wrap(flaky()))
        messages.append(str(info.value))
    assert messages[0] == messages[1]
