"""Named test-filter banks (3-tap and 5-tap).

Capability parity with the reference coefficient bank
(``fir_1d/sim/vector/h_coeff.py:3-16``): four named filters per tap count —
a moving average, a binomial low-pass, a central-difference edge detector,
and an unsharp-mask sharpener.  These are standard textbook kernels; the
exact values below match the reference so that published accuracy baselines
(SURVEY.md §6) are reproducible.
"""

from __future__ import annotations

FILTER_BANK_3TAP: dict[str, list[float]] = {
    "moving_avg": [1.0 / 3.0, 1.0 / 3.0, 1.0 / 3.0],
    "simple_lp": [0.25, 0.5, 0.25],
    "edge": [-1.0, 0.0, 1.0],
    "sharpen": [-0.125, 1.25, -0.125],
}

FILTER_BANK_5TAP: dict[str, list[float]] = {
    "moving_avg": [0.2, 0.2, 0.2, 0.2, 0.2],
    "simple_lp": [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0],
    "edge": [-1.0 / 8.0, -2.0 / 8.0, 0.0, 2.0 / 8.0, 1.0 / 8.0],
    "sharpen": [-1.0 / 16.0, -4.0 / 16.0, 26.0 / 16.0, -4.0 / 16.0, -1.0 / 16.0],
}

FILTER_BANKS: dict[int, dict[str, list[float]]] = {
    3: FILTER_BANK_3TAP,
    5: FILTER_BANK_5TAP,
}


def filter_bank(num_taps: int) -> dict[str, list[float]]:
    if num_taps not in FILTER_BANKS:
        raise ValueError(
            f"No filter bank for num_taps={num_taps}; "
            f"available: {sorted(FILTER_BANKS)}"
        )
    return FILTER_BANKS[num_taps]
