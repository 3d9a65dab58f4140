"""Input/coefficient validation contracts.

Reproduces the exact ValueError surface of the reference models
(``fir_1d/model/python/fir_1d_ref.py:9-41``) as vectorized numpy checks:
same messages, same order of checks, but O(1) numpy scans instead of
per-element Python loops (the first offending index is still reported).

These run eagerly on the host *before* any jit-compiled compute — value
checks cannot live inside a traced function (SURVEY.md §7.3 item 6).
"""

from __future__ import annotations

import numpy as np

from warmup_fir_filter_tpu_torch.ops.qformat import (
    MAX_ABS_H_COEFF,
    clamp_pixel_np,
    round_half_up_np,
)


def validate_h_coefficients(h) -> np.ndarray:
    """Validate filter coefficients; returns them as a float64 array.

    Contract (reference ``fir_1d_ref.py:9-24``):
    - empty h                → ValueError "Invalid h: ..."
    - non-finite h[i]        → ValueError "Invalid h[i]=...: ... finite."
    - |h[i]| > 8.0           → ValueError "Invalid h[i]=...: |h| must be <= 8.0."
    """
    h64 = np.asarray(h, dtype=np.float64)
    if h64.ndim != 1 or h64.size == 0:
        raise ValueError("Invalid h: h coefficients must not be empty.")

    finite = np.isfinite(h64)
    if not finite.all():
        index = int(np.argmin(finite))
        raise ValueError(
            f"Invalid h[{index}]={h64[index]}: h coefficients must be finite."
        )

    too_big = np.abs(h64) > MAX_ABS_H_COEFF
    if too_big.any():
        index = int(np.argmax(too_big))
        raise ValueError(
            f"Invalid h[{index}]={h64[index]}: |h| must be <= {MAX_ABS_H_COEFF}."
        )
    return h64


def validate_x(x) -> np.ndarray:
    """Validate input samples are finite; returns a float64 array.

    Contract (reference ``fir_1d_ref.py:27-33``). Accepts 1-D or 2-D input;
    the reported index is the flat index for 1-D inputs (matching the
    reference, which only ever sees rows).
    """
    x64 = np.asarray(x, dtype=np.float64)
    finite = np.isfinite(x64)
    if not finite.all():
        flat = finite.reshape(-1)
        index = int(np.argmin(flat))
        value = x64.reshape(-1)[index]
        raise ValueError(f"Invalid x[{index}]={value}: x must be finite.")
    return x64


def preprocess_x(x) -> np.ndarray:
    """Full input preprocessing: validate → round-half-up → clamp → uint8.

    Composition of the reference's ``_validate_x`` → ``_round_half_up_x`` →
    ``_clamp_x`` chain (``fir_1d_ref.py:27-41``, reused by the golden model
    at ``fir_1d_fixed_ref.py:34-36``).
    """
    x64 = validate_x(x)
    return clamp_pixel_np(round_half_up_np(x64)).astype(np.uint8)
