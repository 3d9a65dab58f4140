"""2-D FIR in plain PyTorch and numpy: the golden, the int32 sim path, the f32 model.

Counterpart of ``warmup_fir_filter_tpu/ops/fir2d.py``, which imports jax at
module level, so its numpy parts are copied here rather than imported:

- :func:`fir2d_fixed_golden` and :func:`fir2d_ideal_golden` are the numpy
  oracles (``ops/fir2d.py:49-81``): same-mode, center-aligned in both axes
  (``center = L // 2`` per axis), zero padding outside the image, one
  accumulator wraparound to ``acc_bits``, bias-round-shift, saturation;
- :data:`FILTER_BANK_2D` is the filter bank (``:176-188``);
- :func:`fir2d_fixed_torch` is the bit-exact int32 path (``fir2d_fixed_jnp``,
  ``:130``): one int32 multiply-add per tap, wrapping mod 2^32 like the
  reference's, then the epilogue of ``ops/fir1d.py``;
- :func:`fir2d_ideal_torch` is the f32 model (``fir2d_ideal_jnp``, ``:165``).

Both torch paths run on the device their input tensor lies on (a host
array goes to the card), as shifted slices and adds.  No ``conv2d``: on
the card that runs through cuDNN, in TF32 by default.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.ops.fir1d import fixed_epilogue_i32
from warmup_fir_filter_tpu_torch.ops.qformat import (
    QFormat,
    bias_round_shift_np,
    saturate_pixel_np,
    wrap_to_acc_bits_np,
)

FILTER_BANK_2D: dict[str, np.ndarray] = {
    "box3": np.full((3, 3), 1.0 / 9.0),
    "gauss5": (
        np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]).astype(np.float64) / 256.0
    ),
    "laplacian": np.array(
        [[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]]
    ),
    "sharpen5": (
        -np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]).astype(np.float64) / 256.0
        + np.pad([[2.0]], 2)
    ),
}


def _margins(taps_r: int, taps_c: int) -> tuple[int, int, int, int]:
    """(top, bottom, left, right) zero margins of same-mode filtering."""
    cr, cc = taps_r // 2, taps_c // 2
    return taps_r - 1 - cr, cr, taps_c - 1 - cc, cc


def pad_2d(x, taps_r: int, taps_c: int):
    """Same-mode zero pad of an (H, W) numpy array or tensor (``_pad_2d``)."""
    top, bottom, left, right = _margins(taps_r, taps_c)
    if isinstance(x, torch.Tensor):
        return F.pad(x, (left, right, top, bottom))
    return np.pad(x, ((top, bottom), (left, right)))


def _shifted_sum(xp: np.ndarray, h: np.ndarray, rows: int, cols: int,
                 acc: np.ndarray) -> np.ndarray:
    taps_r, taps_c = h.shape
    for kr in range(taps_r):
        for kc in range(taps_c):
            acc += h[kr, kc] * xp[
                taps_r - 1 - kr : taps_r - 1 - kr + rows,
                taps_c - 1 - kc : taps_c - 1 - kc + cols,
            ]
    return acc


def fir2d_ideal_golden(x_u8: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Float64 ideal 2-D FIR over an (H, W) image. Unclamped output."""
    h64 = np.asarray(h, dtype=np.float64)
    rows, cols = x_u8.shape
    xp = pad_2d(x_u8.astype(np.float64), *h64.shape)
    return _shifted_sum(xp, h64, rows, cols, np.zeros((rows, cols), np.float64))


def fir2d_fixed_golden(
    x_u8: np.ndarray, h: np.ndarray, qformat: QFormat = QFormat()
) -> np.ndarray:
    """Bit-accurate Q-format fixed-point 2-D FIR (the host oracle)."""
    h_fixed = qformat.quantize_coeffs(np.asarray(h)).astype(np.int64)
    rows, cols = x_u8.shape
    xp = pad_2d(x_u8.astype(np.int64), *h_fixed.shape)
    acc = _shifted_sum(xp, h_fixed, rows, cols, np.zeros((rows, cols), np.int64))
    acc = wrap_to_acc_bits_np(acc, qformat.acc_bits)
    return saturate_pixel_np(bias_round_shift_np(acc, qformat.frac_bits))


def require_int32_format(qformat: QFormat) -> None:
    if not qformat.tpu_native:
        raise ValueError(
            f"acc_bits={qformat.acc_bits} > 32 is not representable in the "
            "int32 TPU sim path; use fir2d_fixed_golden."
        )


def fixed_fir2d_prehaloed_i32(
    x_ext: torch.Tensor, h_i32, taps_r: int, taps_c: int, frac_bits: int,
    acc_bits: int,
) -> torch.Tensor:
    """Fixed 2-D FIR core over a pre-haloed int32 block (``ops/fir2d.py:103``).

    ``x_ext`` carries ``taps_r - 1 - taps_r//2`` extra rows on top,
    ``taps_r//2`` at the bottom, and the analogous ``taps_c`` margins on the
    columns; the output is the margin-stripped core.  ``h_i32`` is the
    quantized (taps_r, taps_c) kernel; its taps are read once as Python
    ints, so the loop never reads the device.  Products and sums are int32
    and wrap mod 2^32.
    """
    taps = np.asarray(h_i32.cpu() if isinstance(h_i32, torch.Tensor)
                      else h_i32, dtype=np.int64).reshape(taps_r, taps_c)
    rows = x_ext.shape[0] - (taps_r - 1)
    cols = x_ext.shape[1] - (taps_c - 1)
    acc = torch.zeros((rows, cols), dtype=torch.int32, device=x_ext.device)
    for kr in range(taps_r):
        for kc in range(taps_c):
            tap = int(taps[kr, kc])
            if tap:
                r0, c0 = taps_r - 1 - kr, taps_c - 1 - kc
                acc.add_(x_ext[r0 : r0 + rows, c0 : c0 + cols], alpha=tap)
    return fixed_epilogue_i32(acc, frac_bits, acc_bits)


def fir2d_fixed_torch(
    x_u8: torch.Tensor, h, qformat: QFormat = QFormat()
) -> torch.Tensor:
    """Bit-exact fixed-point 2-D FIR over an (H, W) uint8 image on
    ``x_u8.device`` (the int32 sim path, ``fir2d_fixed_jnp``; a host array
    goes to the card, ``_build.as_rows``)."""
    require_int32_format(qformat)
    h_fixed = qformat.quantize_coeffs(np.asarray(h)).astype(np.int64)
    taps_r, taps_c = h_fixed.shape
    x = _build.as_rows(x_u8, torch.int32)
    return fixed_fir2d_prehaloed_i32(
        pad_2d(x, taps_r, taps_c), h_fixed, taps_r, taps_c,
        qformat.frac_bits, qformat.acc_bits)


def fir2d_ideal_torch(x_u8: torch.Tensor, h) -> torch.Tensor:
    """Float32 ideal 2-D FIR over an (H, W) uint8 image. Unclamped.

    One f32 multiply and add per tap over shifted slices, in the order of
    ``fir2d_ideal_jnp``; elementwise, so no TF32 setting applies.  A host
    array goes to the card (``_build.as_rows``).
    """
    h32 = np.asarray(h, dtype=np.float64).astype(np.float32)
    taps_r, taps_c = h32.shape
    x = _build.as_rows(x_u8, torch.float32)
    rows, cols = x.shape
    xp = pad_2d(x, taps_r, taps_c)
    acc = torch.zeros_like(x)
    for kr in range(taps_r):
        for kc in range(taps_c):
            r0, c0 = taps_r - 1 - kr, taps_c - 1 - kc
            acc = acc + float(h32[kr, kc]) * xp[r0 : r0 + rows, c0 : c0 + cols]
    return acc
