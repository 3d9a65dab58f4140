"""Kernel choice for the bit-exact fixed-point FIR.

Counterpart of ``warmup_fir_filter_tpu/kernels/dispatch.py:46-64``.  The
choice is made by tap count alone and runs on the input's device:

- L ≤ 257: the band kernel (kernel A, ``fir_band``), which ports K1 and K2;
- L > 257: the direct-form kernel (kernel B, ``fir_direct``), which ports
  K4.  The JAX package sends 258-4,096 taps to its windowed band kernel
  (K3); K3 is not ported yet (ROADMAP), so those tap counts take kernel B.
- ``acc_bits > 32`` fits neither kernel: on a CUDA tensor it raises, as
  ``FixedFir1d.from_numpy`` does; on a CPU tensor it runs the host golden.
  The fixed stage sends such formats to the golden before any tensor is
  made (``pipeline/stages.py::_fixed_compute``), as the JAX package's
  stage does.

On a CUDA tensor the chosen kernel launches or raises; on a CPU tensor the
same choice runs its plain version.  Nothing falls back from one to the
other.  ``fir2d_fixed_auto`` is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from warmup_fir_filter_tpu_torch.kernels.fir_band import MAX_TAPS, FixedFir1d
from warmup_fir_filter_tpu_torch.kernels.fir_direct import fir_direct
from warmup_fir_filter_tpu_torch.reference import (
    QFormat,
    fir1d_fixed_golden_rows,
)


def fir1d_fixed_rows_auto(x_u8: torch.Tensor, h,
                          qformat: QFormat = QFormat()) -> torch.Tensor:
    """Bit-exact fixed FIR over (B, N) uint8 rows on ``x_u8.device``."""
    if not qformat.tpu_native:
        if x_u8.device.type != "cpu":
            raise ValueError(
                f"acc_bits={qformat.acc_bits} > 32 fits no int32 kernel; "
                "call fir1d_fixed_golden_rows on the host."
            )
        return torch.from_numpy(
            fir1d_fixed_golden_rows(x_u8.numpy(), np.asarray(h), qformat))
    if np.asarray(h).size <= MAX_TAPS:
        return FixedFir1d.from_numpy(h, qformat, x_u8.device)(x_u8)
    return fir_direct(x_u8, h, qformat)
