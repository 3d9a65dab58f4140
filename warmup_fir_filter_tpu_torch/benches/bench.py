"""Headline benchmark: 5-tap fixed-point FIR throughput on one card.

Port of ``bench.py``.  Measures the bit-exact Q4.12 5-tap FIR (the
reference's headline workload, ``pipeline_fir_1d.py`` stage 3; ``sharpen``
from the 5-tap bank) over 19,456 × 8,192 uint8 rows through kernel A, the
filter prepared once, and prints one JSON line::

    {"metric": "fixed5_fir_msps_per_chip", "value": N,
     "unit": "Msamples/s/chip", "vs_baseline": N, ...}

- gate: the first 64 rows equal the numpy golden bit for bit, through the
  kernel at 64 rows and at the timed shape;
- timing: ``chained_throughput`` (CUDA events), best of 5 sweeps, every
  sweep in ``runs_msps``; the large leg (81,920 × 8,192) best of 3;
- ``sol_msps``: 2 bytes a sample at the H100's 3.35 TB/s;
- ``wall_msps``: kernel N (``copy_rows_``, the roofline's in-place copy)
  timed in the same run on the same rows;
- ``vs_baseline``: against the reference's scalar golden model, timed live
  on this host from ``--reference-dir`` (a checkout of the reference), else
  the recorded 0.57 Msamples/s of a host CPU, as ``reference_source`` says.

Kernel B (``fir1d_fixed_rows_pallas``'s kernel), the plain int32 path
(``fir1d_fixed_rows_torch``) and a widen/narrow pass go to stderr as
``# extras``, each gated like the headline.  ``--quick`` skips the large
leg and shortens the sweeps.

Usage: ``python -m warmup_fir_filter_tpu_torch.benches.bench [--quick]
[--device cuda|cpu] [--reference-dir DIR]``
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.benches import _common
from warmup_fir_filter_tpu_torch.kernels.copy_rows import copy_rows_
from warmup_fir_filter_tpu_torch.kernels.fir_band import FixedFir1d
from warmup_fir_filter_tpu_torch.kernels.fir_direct import FixedFirDirect
from warmup_fir_filter_tpu_torch.models.filters import FILTER_BANK_5TAP
from warmup_fir_filter_tpu_torch.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu_torch.ops.fir1d import fir1d_fixed_rows_torch
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

METRIC = "fixed5_fir_msps_per_chip"
UNIT = "Msamples/s/chip"
SEED = 20260817
BATCH, WIDTH = 19456, 8192  # ~159.4 Msamples, ≈160 MB in + 160 MB out
BATCH_LARGE = 81920  # ≈640 MB in + 640 MB out
GATE_ROWS = 64
#: The reference's golden model, relative to a checkout of the reference.
REFERENCE_MODEL = Path("fir_1d/model/python/fir_1d_fixed_ref.py")
#: The JAX bench's keys under another name here, and those with no
#: counterpart (none: its wall constant became a measurement).
RENAMED: dict[str, str] = {}
DROPPED: dict[str, str] = {}


def reference_msps(h: np.ndarray, reference_dir: str | None
                   ) -> tuple[float, str]:
    """Msamples/s of the reference's scalar golden on 100,000 samples of
    this host, timed live from ``reference_dir``; without one, the
    recorded host-CPU figure.  Returns the rate and where it came from."""
    if reference_dir is None:
        return _common.REFERENCE_MSPS, (
            "recorded: the reference's scalar golden model on a host CPU")
    root = Path(reference_dir).resolve()
    if not (root / REFERENCE_MODEL).is_file():
        raise FileNotFoundError(f"no {REFERENCE_MODEL} under {root}")
    sys.path.insert(0, str(root))
    try:
        from fir_1d.model.python.fir_1d_fixed_ref import fir_1d_fixed_golden
    finally:
        sys.path.remove(str(root))
    n = 100_000
    x = (np.arange(n) % 256).tolist()
    start = time.perf_counter()
    fir_1d_fixed_golden(x, list(h))
    return n / (time.perf_counter() - start) / 1e6, (
        f"timed live on this host's CPU from {root}")


def gate(name: str, fn, x_dev: torch.Tensor, check: np.ndarray,
         golden: np.ndarray) -> None:
    """Raise unless ``fn`` gives the golden on the check rows, alone and
    as the first rows of the timed array."""
    device = x_dev.device
    alone = fn(torch.from_numpy(check).to(device)).cpu().numpy()
    first = fn(x_dev)[: check.shape[0]].cpu().numpy()
    if not (np.array_equal(alone, golden) and np.array_equal(first, golden)):
        raise AssertionError(f"backend {name} is not bit-exact vs golden")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help="no large leg, shorter sweeps")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--reference-dir", default=None,
                        help="a checkout of the reference, to time its "
                             "scalar golden live")
    args = parser.parse_args(argv)

    def body() -> dict:
        start = time.perf_counter()
        device = _build.resolve_device(args.device)
        qf = QFormat()
        h = np.asarray(FILTER_BANK_5TAP["sharpen"])
        rng = np.random.default_rng(SEED)
        x = rng.integers(0, 256, size=(BATCH, WIDTH), dtype=np.uint8)
        x_dev = torch.from_numpy(x).to(device)
        samples = x.size
        check = x[:GATE_ROWS].copy()
        golden = fir1d_fixed_golden_rows(check, h, qf)
        del x
        ref_msps, ref_source = reference_msps(h, args.reference_dir)
        best_of = 2 if args.quick else 5

        fir = FixedFir1d.from_numpy(h, qf, device)
        gate("fir_band", fir, x_dev, check, golden)
        res = _common.throughput(fir, x_dev, best_of=best_of)
        value = _common.msps(samples, res["seconds_per_apply"], device)
        wall = _common.throughput(copy_rows_, x_dev, best_of=best_of)
        wall_msps = _common.msps(samples, wall["seconds_per_apply"], device)
        headline = {
            "metric": METRIC,
            "value": round(value, 1),
            "unit": UNIT,
            "vs_baseline": round(value / ref_msps, 1),
            "backend": "fir_band",
            "workload": f"5-tap Q4.12 fixed FIR over {BATCH}x{WIDTH} uint8",
            **_common.card(device),
            "reference_msps": round(ref_msps, 3),
            "reference_source": ref_source,
            "sol_msps": round(_common.SOL_MSPS, 1),
            "sol_fraction": round(value / _common.SOL_MSPS, 3),
            "wall_msps": round(wall_msps, 1),
            "wall_fraction": (round(value / wall_msps, 3) if wall_msps
                              else 0.0),
            "wall_runs_msps": sorted(round(samples / s / 1e6, 1)
                                     for s in wall["slopes"] if s > 0),
            "runs_msps": sorted(round(samples / s / 1e6, 1)
                                for s in res["slopes"] if s > 0),
            "bit_exact_vs_golden": True,
        }

        if args.quick:
            headline["large_skipped"] = "--quick"
        else:
            xl = rng.integers(0, 256, size=(BATCH_LARGE, WIDTH),
                              dtype=np.uint8)
            check_l = xl[:GATE_ROWS].copy()
            xl_dev = torch.from_numpy(xl).to(device)
            del xl
            gate("fir_band (large)", fir, xl_dev, check_l,
                 fir1d_fixed_golden_rows(check_l, h, qf))
            n_l = xl_dev.numel()
            res_l = _common.throughput(fir, xl_dev, repeats=3, best_of=3)
            wall_l = _common.throughput(copy_rows_, xl_dev, repeats=3,
                                        best_of=3)
            l_msps = _common.msps(n_l, res_l["seconds_per_apply"], device)
            l_wall = _common.msps(n_l, wall_l["seconds_per_apply"], device)
            headline.update({
                "large_workload": (f"same kernel over {BATCH_LARGE}x{WIDTH} "
                                   f"uint8 (~{n_l / 1e6:.0f} MB in)"),
                "large_msps": round(l_msps, 1),
                "large_sol_fraction": round(l_msps / _common.SOL_MSPS, 3),
                "large_wall_msps": round(l_wall, 1),
                "large_wall_fraction": (round(l_msps / l_wall, 3)
                                        if l_wall else 0.0),
                "large_runs_msps": sorted(round(n_l / s / 1e6, 1)
                                          for s in res_l["slopes"] if s > 0),
                "large_bit_exact_vs_golden": True,
            })
            del xl_dev

        # Comparison backends, gated like the headline, on stderr.
        short = ({"chain_short": 2, "chain_long": 6, "repeats": 1}
                 if args.quick else {})
        backends = {"fir_band": round(value, 1)}
        fir_b = FixedFirDirect(h, qf, device)
        for name, fn in (("fir_direct", fir_b),
                         ("fir1d_fixed_rows_torch",
                          lambda a: fir1d_fixed_rows_torch(a, h, qf))):
            gate(name, fn, x_dev, check, golden)
            r = _common.throughput(fn, x_dev, **short)
            backends[name] = round(
                _common.msps(samples, r["seconds_per_apply"], device), 1)
        ceiling = _common.throughput(
            lambda a: (a.to(torch.int32) + 1).clamp_(0, 255).to(torch.uint8),
            x_dev, **short)
        ceiling_msps = _common.msps(samples, ceiling["seconds_per_apply"],
                                    device)
        _common.extras({
            "backends_msps": backends,
            "practical_ceiling_msps": round(ceiling_msps, 1),
            "ceiling_fraction": (round(value / ceiling_msps, 3)
                                 if ceiling_msps else 0.0),
            "elapsed_s": round(time.perf_counter() - start, 1)})
        headline["elapsed_s"] = round(time.perf_counter() - start, 1)
        return headline

    return _common.run(METRIC, UNIT, body)


if __name__ == "__main__":
    raise SystemExit(main())
