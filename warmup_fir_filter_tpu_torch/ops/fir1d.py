"""1-D FIR paths in plain PyTorch: the fixed-point sim path and the f32 model.

Counterpart of ``warmup_fir_filter_tpu/ops/fir1d.py`` (``:34-148``).  Both
functions run on the device their input tensor lies on:

- :func:`fir1d_fixed_rows_torch` is the bit-exact int32 path (the JAX
  package's ``"tpu"`` jnp path), the independent reference the tests hold
  the direct-form kernel and its plain version (``kernels/fir_direct.py``)
  against.  Products and sums run in int32 and
  wrap mod 2^32 like the reference's; the epilogue runs in int64 so that
  no step of it can overflow.
- :func:`fir1d_ideal_rows_torch` is the f32 model path, within
  ``atol=1e-2, rtol=1e-5`` of the float64 golden for the reference banks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from warmup_fir_filter_tpu_torch.ops.qformat import QFormat


def pad_rows_same_mode(x: torch.Tensor, num_taps: int) -> torch.Tensor:
    """Zero-pad (B, N) rows for same-mode center-aligned convolution.

    Left pad ``L-1-center``, right pad ``center`` with ``center = L // 2``,
    so ``y[n] = Σ_k h[k] * xp[n + (L-1) - k]``.
    """
    center = num_taps // 2
    return F.pad(x, (num_taps - 1 - center, center))


def fixed_epilogue_i32(acc: torch.Tensor, frac_bits: int,
                       acc_bits: int) -> torch.Tensor:
    """Wraparound → bias-round-shift → saturate, as ``ops/fir1d.py:68-87``.

    ``acc`` holds int32 values (any integer dtype); the arithmetic runs in
    int64, where the truncate-and-sign-extend to ``acc_bits`` is a mask and
    an xor and nothing can overflow.
    """
    acc = acc.to(torch.int64)
    if acc_bits < 32:
        sign = 1 << (acc_bits - 1)
        acc = ((acc & ((1 << acc_bits) - 1)) ^ sign) - sign
    low = acc & ((1 << frac_bits) - 1)
    carry = (low + (1 << (frac_bits - 1))) >> frac_bits
    final = (acc >> frac_bits) + carry
    return final.clamp_(0, 255).to(torch.uint8)


def fixed_fir_prehaloed_i32(
    x_ext_i32: torch.Tensor,
    h_fixed: list[int],
    frac_bits: int,
    acc_bits: int,
) -> torch.Tensor:
    """Fixed FIR over int32 rows whose halo columns are already attached.

    ``x_ext`` has width ``N + L - 1``: ``L-1-center`` left halo columns and
    ``center`` right ones.  ``h_fixed`` are the quantized taps as Python
    ints, so the loop never reads the device.
    """
    num_taps = len(h_fixed)
    n = x_ext_i32.shape[1] - (num_taps - 1)
    acc = torch.zeros((x_ext_i32.shape[0], n), dtype=torch.int32,
                      device=x_ext_i32.device)
    for k, tap in enumerate(h_fixed):
        start = num_taps - 1 - k
        # int32 multiply-add: wraps mod 2^32 like the reference's int32.
        acc.add_(x_ext_i32[:, start : start + n], alpha=tap)
    return fixed_epilogue_i32(acc, frac_bits, acc_bits)


def require_int32_format(qformat: QFormat) -> None:
    if not qformat.tpu_native:
        raise ValueError(
            f"acc_bits={qformat.acc_bits} > 32 is not representable in the "
            "int32 sim path; use models.golden.fir1d_fixed_golden_rows."
        )


def fir1d_fixed_rows_torch(
    x_u8: torch.Tensor, h, qformat: QFormat = QFormat()
) -> torch.Tensor:
    """Bit-exact fixed-point FIR over (B, N) uint8 rows on ``x_u8.device``.

    Requires ``qformat.tpu_native`` (acc_bits ≤ 32); wider accumulators
    belong to the host golden model.
    """
    require_int32_format(qformat)
    h_fixed = [int(v) for v in qformat.quantize_coeffs(h).astype(np.int64)]
    xp = pad_rows_same_mode(x_u8.to(torch.int32), len(h_fixed))
    return fixed_fir_prehaloed_i32(xp, h_fixed, qformat.frac_bits,
                                   qformat.acc_bits)


def fir1d_ideal_rows_torch(x_u8: torch.Tensor, h) -> torch.Tensor:
    """Float32 ideal FIR over (B, N) uint8 rows. Unclamped f32 output."""
    h32 = torch.as_tensor(np.asarray(h, dtype=np.float64),
                          dtype=torch.float32, device=x_u8.device)
    num_taps = int(h32.numel())
    x = x_u8.to(torch.float32)
    n = x.shape[1]
    xp = pad_rows_same_mode(x, num_taps)
    acc = torch.zeros_like(x)
    for k in range(num_taps):
        start = num_taps - 1 - k
        acc = acc + h32[k] * xp[:, start : start + n]
    return acc
