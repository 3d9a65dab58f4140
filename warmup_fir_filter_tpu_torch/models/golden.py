"""Trusted host-side golden models (vectorized numpy).

These are the *oracles*: bit-for-bit re-derivations of the reference's
scalar Python models, vectorized over whole row batches so a 13.5-Mpixel
image is one numpy pass instead of millions of interpreted MAC loops.

Bit-exactness arguments (each is covered by tests against hand-computed
vectors and by randomized cross-checks):

- **ideal (float64)**: the reference accumulates ``acc += h[k] * x[idx]``
  for k = 0..L-1 in float64 (``fir_1d_ref.py:55-63``).  The vectorized
  form runs the *same* recurrence in the *same* k-order on whole rows
  (``acc = fl(acc + fl(h[k] * x_k))`` elementwise), so every output sample
  sees an identical sequence of float64 roundings → identical bits.

- **fixed (integer)**: the reference MACs exact Python ints, then masks to
  ``acc_bits`` once per output sample (``fir_1d_fixed_ref.py:95-115``).
  Here terms and sums are int64; reduction mod 2^64 commutes with the final
  reduction mod 2^acc_bits (ring homomorphism), so wrapping at the end in
  int64 equals the reference's unbounded-int-then-mask — provided no int64
  product overflows, which holds for pixel·coeff ≤ 255·2^31 ≪ 2^63 and
  row lengths ≪ 2^23.
"""

from __future__ import annotations

import numpy as np

from warmup_fir_filter_tpu_torch.ops.qformat import (
    QFormat,
    bias_round_shift_np,
    saturate_pixel_np,
    wrap_to_acc_bits_np,
)
from warmup_fir_filter_tpu_torch.ops.validation import (
    preprocess_x,
    validate_h_coefficients,
)

# Safety bound for the modular-arithmetic argument above: with L taps the
# worst-case |sum| is L * 255 * 2^31 and must stay below 2^63.
_MAX_ROW_TAPS = 1 << 22


def _padded_rows(x_u8: np.ndarray, num_taps: int, dtype) -> np.ndarray:
    """Zero-pad rows for same-mode center-aligned convolution.

    Output index n reads input indices ``n - k + center`` for k = 0..L-1
    with ``center = L // 2`` and zeros outside [0, N)
    (``fir_1d_ref.py:49-60``).  Padding ``L-1-center`` on the left and
    ``center`` on the right makes every read in-bounds:
    ``y[n] = Σ_k h[k] * xp[n + (L-1) - k]``.
    """
    center = num_taps // 2
    left, right = num_taps - 1 - center, center
    return np.pad(x_u8.astype(dtype), ((0, 0), (left, right)))


def fir1d_ideal_golden_rows(x_u8: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Float64 ideal FIR over a batch of rows. No output clamp.

    Args:
        x_u8: (B, N) uint8 preprocessed samples.
        h: (L,) float64 validated coefficients.

    Returns:
        (B, N) float64 unclamped outputs (ideal spec: pass-through output
        for dynamic-range analysis, ``fir_1d_ideal_spec_v1.md:43-45``).
    """
    x_u8 = np.ascontiguousarray(x_u8)
    h64 = np.asarray(h, dtype=np.float64)
    num_taps = h64.size
    batch, n = x_u8.shape
    xp = _padded_rows(x_u8, num_taps, np.float64)
    acc = np.zeros((batch, n), dtype=np.float64)
    # Same k-order float64 recurrence as the reference scalar loop.
    for k in range(num_taps):
        start = num_taps - 1 - k
        acc += h64[k] * xp[:, start : start + n]
    return acc


def fir1d_fixed_golden_rows(
    x_u8: np.ndarray,
    h: np.ndarray,
    qformat: QFormat = QFormat(),
) -> np.ndarray:
    """Bit-accurate Q-format fixed-point FIR over a batch of rows.

    The full hardware contract of ``fir_1d_fixed_ref.py:75-130``:
    coefficient quantization (rint/clip), integer MAC, accumulator
    wraparound to ``acc_bits``, bias rounding, right shift by ``frac_bits``,
    saturation to uint8.

    Args:
        x_u8: (B, N) uint8 preprocessed samples.
        h: (L,) float64 coefficients already validated against the
            Q-format real range.
        qformat: number format (default Q4.12 / acc 32 / coeff 16).

    Returns:
        (B, N) uint8 saturated outputs.
    """
    x_u8 = np.ascontiguousarray(x_u8)
    h_fixed = qformat.quantize_coeffs(h).astype(np.int64)
    num_taps = h_fixed.size
    if num_taps > _MAX_ROW_TAPS:
        raise ValueError(
            f"num_taps={num_taps} exceeds the int64 exactness bound "
            f"({_MAX_ROW_TAPS}) of the vectorized golden model."
        )
    batch, n = x_u8.shape
    xp = _padded_rows(x_u8, num_taps, np.int64)
    acc = np.zeros((batch, n), dtype=np.int64)
    for k in range(num_taps):
        start = num_taps - 1 - k
        acc += h_fixed[k] * xp[:, start : start + n]
    acc = wrap_to_acc_bits_np(acc, qformat.acc_bits)
    final = bias_round_shift_np(acc, qformat.frac_bits)
    return saturate_pixel_np(final)


def _as_1d(x_u8: np.ndarray) -> np.ndarray:
    if x_u8.ndim != 1:
        raise ValueError(
            f"Invalid x: expected a 1-D sample sequence, got shape "
            f"{x_u8.shape}; use the *_rows functions for batched input."
        )
    return x_u8


def fir1d_ideal_golden(x, h) -> np.ndarray:
    """1-D convenience wrapper: validate + preprocess, then ideal FIR."""
    h64 = validate_h_coefficients(h)
    x_u8 = _as_1d(preprocess_x(x))
    return fir1d_ideal_golden_rows(x_u8[None, :], h64)[0]


def fir1d_fixed_golden(x, h, qformat: QFormat = QFormat()) -> np.ndarray:
    """1-D convenience wrapper: full validation chain, then fixed FIR."""
    h64 = validate_h_coefficients(h)
    x_u8 = _as_1d(preprocess_x(x))
    qformat.validate_h_range(h64)
    return fir1d_fixed_golden_rows(x_u8[None, :], h64, qformat)[0]
