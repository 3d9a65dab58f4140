"""Kernel B: the direct-form fixed-point FIR for any tap count (ports K4).

Counterpart of ``warmup_fir_filter_tpu/kernels/fir_pallas.py:62-186``.
:func:`fir_direct` launches ``csrc/fir_direct.cu`` on a CUDA tensor; on a
CPU tensor it runs the plain version,
:func:`~warmup_fir_filter_tpu_torch.ops.fir1d.fir1d_fixed_rows_torch`.
"""

from __future__ import annotations

import numpy as np
import torch

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.ops.fir1d import (
    fir1d_fixed_rows_torch,
    require_int32_format,
)
from warmup_fir_filter_tpu_torch.reference import QFormat


def fir_direct(x_u8: torch.Tensor, h, qformat: QFormat = QFormat()) -> torch.Tensor:
    """Bit-exact fixed FIR over (B, N) uint8 rows, direct form, any L.

    Kernel B on a CUDA tensor; the plain version on a CPU tensor.  Raises
    on a tensor that is not 2-D uint8, a non-contiguous CUDA tensor, an
    ``acc_bits`` above 32, a failed build or a failed launch.  Counts its
    launches in ``fir_direct.launches``.
    """
    _build.check_rows_u8(x_u8)
    require_int32_format(qformat)
    if x_u8.device.type == "cpu":
        return fir1d_fixed_rows_torch(x_u8, h, qformat)
    _build.check_launchable(x_u8)
    if not 1 <= qformat.frac_bits <= 31:
        raise ValueError(f"direct kernel needs 1 <= frac_bits <= 31, "
                         f"got {qformat.frac_bits}")
    h_fixed = qformat.quantize_coeffs(h).astype(np.int32)
    taps = torch.from_numpy(h_fixed).to(x_u8.device)
    y = torch.empty_like(x_u8)
    if x_u8.numel() == 0:
        return y
    lib = _build.load_library()
    with torch.cuda.device(x_u8.device):
        code = lib.wft_fir_direct(
            x_u8.data_ptr(), y.data_ptr(), x_u8.shape[0], x_u8.shape[1],
            taps.data_ptr(), int(h_fixed.size), qformat.frac_bits,
            qformat.acc_bits, _build.stream_of(x_u8),
        )
    _build.check_launch(lib, code, "fir_direct")
    fir_direct.launches += 1
    return y


fir_direct.launches = 0
