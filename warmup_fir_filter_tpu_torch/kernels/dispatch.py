"""Kernel choice for the bit-exact fixed-point FIR.

Counterpart of ``warmup_fir_filter_tpu/kernels/dispatch.py:46-64``.  The
choice is made by tap count alone, as the JAX package makes it, and runs
on the input's device:

- L ≤ 257: the band kernel (kernel A, ``fir_band``), which ports K1 and K2;
- 258 ≤ L ≤ 4,096: the windowed kernel (kernel C, ``fir_window``), which
  ports K3;
- L > 4,096: the direct-form kernel (kernel B, ``fir_direct``), which
  ports K4 and is the only route past kernel C's 4,096 taps.  B walks
  kernel C's int8 tensor-core core over chunks of the taps, each chunk's
  digit planes trimmed to its nonzero taps, so it runs at C's rate per
  nonzero tap for any L; up to 32 taps (the CLI's ``--backend pallas``)
  it runs kernel A's short-tap core.
- ``acc_bits > 32`` fits none of them: on a CUDA tensor (or a host array,
  which goes to the card) it raises, as ``FixedFir1d.from_numpy`` does;
  on a CPU tensor it runs the host golden.
  The fixed stage sends such formats to the golden before any tensor is
  made (``pipeline/stages.py::_fixed_compute``), as the JAX package's
  stage does.

:func:`prepare_fixed_fir` quantizes a filter and uploads its buffers once,
for callers that filter many blocks (``ops/streaming.py``); a module's
forward takes a CPU or a CUDA tensor on the module's device.  On a CUDA
tensor the chosen kernel launches or raises; on a CPU tensor the same
choice runs its plain version.  Nothing falls back from one to the other.

:func:`fir2d_fixed_auto` is the 2-D counterpart (``dispatch.py:67-85``):
an (Lr, Lc) filter with Lc ≤ 257 goes to ``fir2d_fixed_mxu``, whose
``"auto"`` layout takes the overlapped frame (kernel F, K7) for
``0 < Lc - 1 ≤ 96`` and the plain frame (kernel E, K6) otherwise; any other
filter goes to ``fir2d_fixed_torch``, the int32 path.
:func:`prepare_fixed_fir2d` makes that choice once and prepares the filter
for it, for callers that filter many pieces of an image
(``parallel/halo.py``).
"""

from __future__ import annotations

from collections.abc import Callable
from functools import partial

import numpy as np
import torch
from torch import nn

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels.fir2d import (
    FixedFir2d,
    as_image,
    fir2d_fixed_image,
)
from warmup_fir_filter_tpu_torch.kernels.fir_band import MAX_TAPS, FixedFir1d
from warmup_fir_filter_tpu_torch.kernels.fir_direct import FixedFirDirect
from warmup_fir_filter_tpu_torch.kernels.fir_window import (
    MAX_TAPS as MAX_TAPS_WINDOWED,
    FixedFirWindow,
)
from warmup_fir_filter_tpu_torch.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu_torch.ops.fir2d import fir2d_fixed_torch
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.utils.profiling import span


def prepare_fixed_fir(h, qformat: QFormat = QFormat(),
                      device: torch.device | str = "cuda") -> nn.Module:
    """The filter prepared for its kernel on ``device`` (the card unless
    the caller names another), chosen by tap count.

    ``FixedFir1d`` (kernel A) for L ≤ 257, ``FixedFirWindow`` (kernel C)
    for 258-4,096 and ``FixedFirDirect`` (kernel B) beyond.  Raises for
    ``acc_bits > 32``.  The whole preparation is one ``fir.prepare`` span
    under a profiler (``utils/profiling.py::span``).
    """
    with span("fir.prepare"):
        num_taps = int(np.asarray(h).size)
        if num_taps <= MAX_TAPS:
            return FixedFir1d.from_numpy(h, qformat, device)
        if num_taps <= MAX_TAPS_WINDOWED:
            return FixedFirWindow.from_numpy(h, qformat, device)
        return FixedFirDirect(h, qformat, device)


def fir1d_fixed_rows_auto(x_u8: torch.Tensor, h,
                          qformat: QFormat = QFormat()) -> torch.Tensor:
    """Bit-exact fixed FIR over (B, N) uint8 rows on ``x_u8.device`` (a
    host array goes to the card, ``_build.as_rows``)."""
    x_u8 = _build.as_rows(x_u8)
    if not qformat.tpu_native:
        if x_u8.device.type != "cpu":
            raise ValueError(
                f"acc_bits={qformat.acc_bits} > 32 fits no int32 kernel; "
                "call fir1d_fixed_golden_rows on the host."
            )
        return torch.from_numpy(
            fir1d_fixed_golden_rows(x_u8.numpy(), np.asarray(h), qformat))
    return prepare_fixed_fir(h, qformat, x_u8.device)(x_u8)


def fir2d_fixed_auto(x_u8: torch.Tensor, h,
                     qformat: QFormat = QFormat()) -> torch.Tensor:
    """Bit-exact fixed 2-D FIR over an (H, W) uint8 image on
    ``x_u8.device`` (a host array goes to the card, ``as_image``): the
    frame kernels when the column taps fit a band (Lc ≤ 257), else the
    int32 path.  Raises for ``acc_bits > 32``."""
    x_u8 = as_image(x_u8)
    return prepare_fixed_fir2d(h, qformat, x_u8.device)(x_u8)


def prepare_fixed_fir2d(
    h, qformat: QFormat = QFormat(), device: torch.device | str = "cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """:func:`fir2d_fixed_auto`'s route for ``h``, with the filter prepared
    once on ``device`` (the card unless the caller names another): a
    function of an (H, W) uint8 image there.  The
    frame kernels over one :class:`FixedFir2d` when the column taps fit a
    band (Lc ≤ 257), else the int32 path."""
    h = np.asarray(h)
    if h.ndim == 2 and h.shape[1] <= MAX_TAPS:
        return partial(fir2d_fixed_image,
                       fir=FixedFir2d.from_numpy(h, qformat, device))
    return lambda x_u8: fir2d_fixed_torch(x_u8, h, qformat)
