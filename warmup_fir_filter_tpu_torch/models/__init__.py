"""Models: the filter banks, the numpy golden oracle, the reference-parity
API and the DSP chain."""

from warmup_fir_filter_tpu_torch.models.golden import (
    fir1d_ideal_golden_rows,
    fir1d_fixed_golden_rows,
)
from warmup_fir_filter_tpu_torch.models.reference_api import (
    fir_1d_ideal,
    fir_1d_fixed_golden,
)

__all__ = [
    "fir1d_ideal_golden_rows",
    "fir1d_fixed_golden_rows",
    "fir_1d_ideal",
    "fir_1d_fixed_golden",
]
