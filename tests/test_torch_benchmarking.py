"""The port's ``chained_throughput`` against the JAX package's contract.

Same signature and return keys, and the same rules for the headline (the
best positive slope over the sweeps) and the median; on a CPU tensor the
chain runs the plain versions timed by the host clock.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.utils.benchmarking import (
    chained_throughput as jax_chained_throughput,
)
from warmup_fir_filter_tpu_torch.kernels.dispatch import fir1d_fixed_rows_auto
from warmup_fir_filter_tpu_torch.utils import benchmarking
from warmup_fir_filter_tpu_torch.utils.benchmarking import chained_throughput

H5 = [0.1, 0.2, 0.4, 0.2, 0.1]
TINY = dict(chain_short=1, chain_long=3, repeats=1)


def test_keys_equal_the_jax_helpers(rng):
    from warmup_fir_filter_tpu.kernels.dispatch import (
        fir1d_fixed_rows_auto as jax_auto,
    )

    x = rng.integers(0, 256, size=(2, 128), dtype=np.uint8)
    want = jax_chained_throughput(lambda y: jax_auto(y, H5), jnp.asarray(x),
                                  **TINY)
    got = chained_throughput(lambda y: fir1d_fixed_rows_auto(y, H5),
                             torch.from_numpy(x), **TINY)
    assert got.keys() == want.keys()
    assert got["num_samples"] == want["num_samples"] == x.size
    assert got["best_of"] == want["best_of"] == 1
    assert got["times"].keys() == want["times"].keys() == {1, 3}
    assert len(got["slopes"]) == len(want["slopes"]) == 1


def test_a_sleeping_step_takes_its_sleep():
    """One-sided: a loaded worker can only make the chain slower."""

    def step(y):
        time.sleep(0.002)
        return y

    out = chained_throughput(step, torch.zeros(4, 8, dtype=torch.uint8),
                             chain_short=1, chain_long=5, repeats=3)
    assert out["seconds_per_apply"] >= 1.5e-3
    assert out["samples_per_second"] == pytest.approx(
        32 / out["seconds_per_apply"])


@pytest.mark.parametrize("slopes,best,median", [
    ((-1.0, 2.0, 3.0), 2.0, 2.5),
    ((4.0, 2.0, 3.0), 2.0, 3.0),
    ((-1.0, -2.0, -3.0), -1.0, -1.0),  # none positive: the first sweep's
])
def test_best_positive_slope_and_median(monkeypatch, slopes, best, median):
    """The JAX rules: the headline is the least positive slope, the median
    that of the positive slopes, and the first sweep's slope when none is
    positive."""
    chain_short, chain_long = 2, 6
    # Each sweep times chain_short then chain_long; warm-up calls first.
    seconds = [0.0, 0.0]
    for slope in slopes:
        seconds += [1.0, 1.0 + slope * (chain_long - chain_short)]
    calls = iter(seconds)
    monkeypatch.setattr(benchmarking, "_chain_seconds",
                        lambda step_fn, x, k: next(calls))
    out = chained_throughput(None, torch.zeros(2, 5, dtype=torch.uint8),
                             chain_short=chain_short, chain_long=chain_long,
                             repeats=1, best_of=len(slopes))
    assert out["slopes"] == pytest.approx(list(slopes))
    assert out["seconds_per_apply"] == pytest.approx(best)
    assert out["seconds_per_apply_median"] == pytest.approx(median)
    assert out["best_of"] == len(slopes)
    want_rate = 10 / best if best > 0 else 0.0
    assert out["samples_per_second"] == pytest.approx(want_rate)
