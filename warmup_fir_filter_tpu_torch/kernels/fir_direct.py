"""Kernel B: the direct-form fixed-point FIR for any tap count (ports K4).

Counterpart of ``warmup_fir_filter_tpu/kernels/fir_pallas.py:62-186``.
:func:`fir_direct` launches ``csrc/fir_direct.cu`` on a CUDA tensor; on a
CPU tensor it runs the plain version,
:func:`~warmup_fir_filter_tpu_torch.ops.fir1d.fir1d_fixed_rows_torch`.
:class:`FixedFirDirect` quantizes and uploads the taps once, for callers
that filter many blocks with one filter.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.ops.fir1d import (
    fir1d_fixed_rows_torch,
    require_int32_format,
)
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat


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
    taps = torch.from_numpy(qformat.quantize_coeffs(h).astype(np.int32))
    return _launch(x_u8, taps.to(x_u8.device), qformat)


def _launch(x_u8: torch.Tensor, taps: torch.Tensor,
            qformat: QFormat) -> torch.Tensor:
    """Kernel B over CUDA rows with int32 taps already on their device."""
    _build.check_launchable(x_u8)
    _build.check_same_device(x_u8, taps, "taps")
    if not 1 <= qformat.frac_bits <= 31:
        raise ValueError(f"direct kernel needs 1 <= frac_bits <= 31, "
                         f"got {qformat.frac_bits}")
    y = torch.empty_like(x_u8)
    if x_u8.numel() == 0:
        return y
    lib = _build.load_library()
    with torch.cuda.device(x_u8.device):
        code = lib.wft_fir_direct(
            x_u8.data_ptr(), y.data_ptr(), x_u8.shape[0], x_u8.shape[1],
            taps.data_ptr(), taps.numel(), qformat.frac_bits,
            qformat.acc_bits, _build.stream_of(x_u8),
        )
    _build.check_launch(lib, code, "fir_direct")
    fir_direct.launches += 1
    return y


fir_direct.launches = 0


class FixedFirDirect(nn.Module):
    """Kernel B's filter, quantized once, with its int32 taps as a buffer
    (``h_fixed``) on one device."""

    def __init__(self, h, qformat: QFormat = QFormat(),
                 device: torch.device | str = "cpu"):
        super().__init__()
        require_int32_format(qformat)
        self.h = np.asarray(h, dtype=np.float64)
        self.qformat = qformat
        h_fixed = qformat.quantize_coeffs(self.h).astype(np.int32)
        self.num_taps = int(h_fixed.size)
        self.register_buffer("h_fixed",
                             torch.as_tensor(h_fixed, device=device))

    def forward(self, x_u8: torch.Tensor) -> torch.Tensor:
        _build.check_rows_u8(x_u8)
        if x_u8.device.type == "cpu":
            return fir1d_fixed_rows_torch(x_u8, self.h, self.qformat)
        return _launch(x_u8, self.h_fixed, self.qformat)


def fir1d_fixed_rows_pallas(x_u8: torch.Tensor, h,
                            qformat: QFormat = QFormat()) -> torch.Tensor:
    """Bit-exact fixed FIR over (B, N) uint8 rows, any L, on
    ``x_u8.device``: the JAX ``fir_pallas.py::fir1d_fixed_rows_pallas``
    entry (its TPU blocking knobs dropped) over kernel B."""
    return fir_direct(x_u8, h, qformat)
