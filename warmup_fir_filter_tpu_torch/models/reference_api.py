"""Drop-in parity API matching the reference models' call surface.

A user of the reference's Python models (``fir_1d.model.python``) can
switch to these functions and get the same signatures, same validation
errors, and bit-identical outputs:

- ``fir_1d_ideal(x, h) -> list[float]``       (ref ``fir_1d_ref.py:43-65``)
- ``fir_1d_fixed_golden(x, h, frac_bits=12, acc_bits=32, coeff_bits=16)
  -> np.uint8 array``                        (ref ``fir_1d_fixed_ref.py:12-130``)

Internally these route to the vectorized golden oracle
(:mod:`warmup_fir_filter_tpu.models.golden`), so they are orders of
magnitude faster than the reference's interpreted MAC loops while keeping
the bit-exact contract.
"""

from __future__ import annotations

import numpy as np
import numpy.typing as npt

from warmup_fir_filter_tpu_torch.models import golden
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat


def fir_1d_ideal(x, h) -> list[float]:
    """Float64 ideal same-mode 1D FIR; returns a Python list of floats."""
    return golden.fir1d_ideal_golden(x, h).tolist()


def fir_1d_fixed_golden(
    x,
    h,
    frac_bits: int = 12,
    acc_bits: int = 32,
    coeff_bits: int = 16,
) -> npt.NDArray[np.uint8]:
    """Bit-accurate fixed-point golden 1D FIR; returns a uint8 array.

    Validation order matches the reference: h coefficients → x samples →
    bit-width parameters → Q-format real-range check
    (``fir_1d_fixed_ref.py:34-72``).
    """
    from warmup_fir_filter_tpu_torch.ops.validation import (
        preprocess_x,
        validate_h_coefficients,
    )

    h64 = validate_h_coefficients(h)
    x_u8 = preprocess_x(x)
    qformat = QFormat(
        coeff_bits=coeff_bits, frac_bits=frac_bits, acc_bits=acc_bits
    )
    qformat.validate_h_range(h64)
    return golden.fir1d_fixed_golden_rows(x_u8[None, :], h64, qformat)[0]
