"""Numerical-safety / determinism checks (SURVEY.md §5.2 equivalents).

The port's counterparts of ``warmup_fir_filter_tpu/utils/debugging.py``:

- :func:`nan_guard` — context manager under which any op that produces a
  NaN raises ``FloatingPointError`` at that op, as ``jax_debug_nans`` does
  for the JAX package (±Inf passes under both: the JAX guard sets only
  ``jax_debug_nans``).  Every aten op is seen through a
  ``TorchDispatchMode``; the hand-written kernels launch through ctypes,
  which the dispatcher never sees, so the float kernels' wrappers call
  :func:`check_kernel_output` on what they return;
- :func:`assert_deterministic` — executes a function twice and asserts
  bit-identical outputs (the determinism check appropriate for a
  framework whose contract *is* bit-exactness).
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)

_aten = torch.ops.aten
#: Ops whose outputs hold whatever the allocator handed out: no op produced
#: those values, so they are not checked (JAX has no such op).
_UNINITIALIZED = frozenset({
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.empty_permuted,
})


def _holds_nan(value) -> bool:
    return (isinstance(value, torch.Tensor)
            and (value.is_floating_point() or value.is_complex())
            and bool(torch.isnan(value).any()))


class _NanCheck(TorchDispatchMode):
    """Raises at the first aten op whose floating-point (real or complex)
    output holds a NaN.  Views are skipped: they produce no value."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket in _UNINITIALIZED:
            return out
        if any(_holds_nan(leaf) for leaf in pytree.tree_leaves(out)):
            raise FloatingPointError(f"NaN produced by {func} (nan_guard)")
        return out


def nan_guard_active() -> bool:
    """True inside an enabled :func:`nan_guard`."""
    return any(isinstance(mode, _NanCheck)
               for mode in _get_current_dispatch_mode_stack())


@contextmanager
def nan_guard(enabled: bool = True):
    """Raise on NaN production by any op within the scope.

    A guard inside an active one, or ``enabled=False``, changes nothing;
    the previous state comes back on exit, also after an exception.
    """
    if not enabled or nan_guard_active():
        yield
        return
    with _NanCheck():
        yield


def check_kernel_output(kernel: str, *outputs: torch.Tensor) -> None:
    """Raise ``FloatingPointError`` if a guard is active and a float output
    of ``kernel`` holds a NaN.  Checks only; it never reruns anything.
    Costs one look at the dispatch-mode stack when no guard is active."""
    if nan_guard_active() and any(_holds_nan(out) for out in outputs):
        raise FloatingPointError(f"NaN in the output of kernel {kernel} "
                                 "(nan_guard)")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)  # numpy has no bf16: its bits
        return leaf.numpy()
    return np.asarray(leaf)


def assert_deterministic(fn, *args, runs: int = 2) -> None:
    """Assert that repeated executions produce bit-identical outputs."""
    reference = [_host(leaf) for leaf in pytree.tree_leaves(fn(*args))]
    for _ in range(runs - 1):
        again = [_host(leaf) for leaf in pytree.tree_leaves(fn(*args))]
        for ref, new in zip(reference, again):
            if not np.array_equal(ref, new):
                raise AssertionError(
                    "Non-deterministic execution detected: outputs differ "
                    "between runs."
                )
