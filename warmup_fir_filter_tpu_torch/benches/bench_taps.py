"""Tap-count sweep of the bit-exact fixed FIR dispatch (one JSON line).

Port of ``bench_taps.py``.  For each L of ``TAP_SWEEP`` a
``design_lowpass(L, 0.25)`` filter is prepared once by the dispatch's
choice (``kernels/dispatch.py::prepare_fixed_fir``, as
``fir1d_fixed_rows_auto`` makes it: kernel A up to 257 taps, kernel C to
4,096), held bit for bit against the numpy golden on 16 rows, and timed by
``chained_throughput`` (CUDA events, chains of 8 and 104, 3 repeats) over
19,456 × 8,192 uint8 rows.  A backend that misses the golden ends the
sweep with an error line and a non-zero exit.

Usage: ``python -m warmup_fir_filter_tpu_torch.benches.bench_taps
[--quick] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.benches import _common
from warmup_fir_filter_tpu_torch.kernels.dispatch import prepare_fixed_fir
from warmup_fir_filter_tpu_torch.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

METRIC = "fixed_fir_tap_sweep"
UNIT = "Msamples/s/chip at 63 taps (bit-exact gated)"
TAP_SWEEP = (5, 63, 257, 1001, 4096)
BATCH, WIDTH = 19456, 8192  # headline-scale stream, ~159.4 Msamples
QUICK_BATCH, QUICK_WIDTH = 512, 4096
SEED = 20260820
GATE_ROWS = 16
#: The JAX bench's keys under another name here, and those with no
#: counterpart.
RENAMED: dict[str, str] = {}
DROPPED: dict[str, str] = {}
#: The kernel that carries each prepared filter class.
KERNEL_OF = {"FixedFir1d": "fir_band (A)", "FixedFirWindow": "fir_window (C)",
             "FixedFirDirect": "fir_direct (B)"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help=f"{QUICK_BATCH} x {QUICK_WIDTH} rows")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    def body() -> dict:
        start = time.perf_counter()
        device = _build.resolve_device(args.device)
        batch, width = (QUICK_BATCH, QUICK_WIDTH) if args.quick else (
            BATCH, WIDTH)
        qf = QFormat()
        rng = np.random.default_rng(SEED)
        x = rng.integers(0, 256, size=(batch, width), dtype=np.uint8)
        x_dev = torch.from_numpy(x).to(device)
        check = x[:GATE_ROWS].copy()
        check_dev = torch.from_numpy(check).to(device)
        del x
        per_taps: dict[str, float] = {}
        details: dict[str, dict] = {}
        for taps in TAP_SWEEP:
            h = design_lowpass(taps, 0.25)
            fir = prepare_fixed_fir(h, qf, device)
            golden = fir1d_fixed_golden_rows(check, h, qf)
            if not np.array_equal(fir(check_dev).cpu().numpy(), golden):
                raise AssertionError(f"{taps} taps "
                                     f"({type(fir).__name__}): not "
                                     "bit-exact vs golden")
            r = _common.throughput(fir, x_dev, chain_short=8, chain_long=104,
                                   repeats=3)
            rate = round(_common.msps(x_dev.numel(), r["seconds_per_apply"],
                                      device), 1)
            per_taps[str(taps)] = rate
            details[str(taps)] = {
                "bit_exact": True, "msps": rate,
                "kernel": KERNEL_OF[type(fir).__name__],
                "ms": r["seconds_per_apply"] * 1e3}
        value = per_taps.get("63", 0.0)
        return {
            "metric": METRIC,
            "value": value,
            "unit": UNIT,
            "vs_baseline": round(value / _common.REFERENCE_MSPS, 1),
            "per_taps_msps": per_taps,
            "details": details,
            "workload": f"Q4.12 fixed FIR over {batch}x{width} uint8",
            "backend": device.type,
            **_common.card(device),
            "elapsed_s": round(time.perf_counter() - start, 1),
        }

    return _common.run(METRIC, UNIT, body)


if __name__ == "__main__":
    raise SystemExit(main())
