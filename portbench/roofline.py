"""The table of peaks and the least time a piece of work can take.

Copied from ``chip_smoke.py``'s ``PEAK_BYTES``, ``PEAK_OPS`` and ``bound``
(and ``benches/_common.py``'s ``PEAK_BYTES_PER_S``): the published rates of
one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit).  A metric
that holds a kernel to its roofline counts the work of the call the caller
asked for, from its shapes, and never the buffers a kernel happens to use.
"""

from __future__ import annotations

import math

#: Device memory bytes/s.
PEAK_BYTES_PER_S = 3.35e12
#: Operations/s by type (a multiply-add is two operations).
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def least_seconds(nbytes: float, ops: float, kind: str) -> float:
    """The larger of ``nbytes`` at the memory rate and ``ops`` at the peak
    for ``kind``."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def fft_ops(n: int) -> float:
    """A complex ``n``-point transform: ``5 n log2 n`` operations."""
    return 5.0 * n * math.log2(n)


def real_filter_ops(n: int) -> float:
    """One real window of an ``n``-point overlap-save: two real windows
    share one complex forward transform, spectrum product and inverse, so
    each costs half of ``2 fft_ops(n) + 6 n`` (``chip_smoke.py``'s
    ``filter_ops``, the count as corrected in its review)."""
    return fft_ops(n) + 3.0 * n
