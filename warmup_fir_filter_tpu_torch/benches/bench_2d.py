"""2-D FIR throughput on one card (BASELINE config 3's roofline; one JSON
line).

Port of ``bench_2d.py``.  The bit-exact fixed 5×5 ``sharpen5`` filter over
an 8192² uint8 image (seed 20260819) in Msamples/s, each path chained as a
streaming consumer uses it: two applies a step, ping-ponging two frames
through ``out`` (``scratch`` in the JAX entries), timed by
``chained_throughput`` (CUDA events), best of 5 sweeps.

- Primary: the overlapped frame, kernel F (``fir2d_oframe``).
- Comparisons on stderr: the plain frame (kernel E), the bf16 path
  (kernel G), ``fir2d_fixed_torch`` (the int32 path) and, in the full run,
  ``gauss5`` on kernel F.  Every path is held bit for bit against the
  numpy golden on a 256 × 512 slice first; a miss ends the run.
- Speed of light: the larger of two bounds, two bytes a sample at the
  H100's 3.35 TB/s and two operations a nonzero tap at its int8 peak of
  1,979 TOP/s (``sol_ops_msps``, which takes the place of the TPU's
  band-MAC bound ``sol_mxu_band_msps``).

Usage: ``python -m warmup_fir_filter_tpu_torch.benches.bench_2d [--quick]
[--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.benches import _common
from warmup_fir_filter_tpu_torch.kernels.fir2d import (
    FixedFir2d,
    crop_frame_overlap,
    fir2d_bf16,
    fir2d_frame,
    fir2d_oframe,
    pad_frame,
    pad_frame_overlap,
    quantize_2d,
)
from warmup_fir_filter_tpu_torch.ops.fir2d import (
    FILTER_BANK_2D,
    fir2d_fixed_golden,
    fir2d_fixed_torch,
)
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

METRIC = "fixed2d_5x5_msps_per_chip"
UNIT = "Msamples/s/chip"
SEED = 20260819
SIZE, QUICK_SIZE = 8192, 2048
#: Published int8 peak of one H100 SXM (NVIDIA's data sheet, dense, 700 W).
PEAK_INT8_OPS_PER_S = 1979e12
#: The JAX bench's keys under another name here, and those with no
#: counterpart.
RENAMED = {"sol_mxu_band_msps": "sol_ops_msps"}
DROPPED: dict[str, str] = {}
#: Each frame kernel: its frame layout ("overlap" or "plain") and wrapper.
PATHS = {"fir2d_oframe": ("overlap", fir2d_oframe),
         "fir2d_frame": ("plain", fir2d_frame),
         "fir2d_bf16": ("overlap", fir2d_bf16)}


def frame_of(layout: str, x: torch.Tensor, taps: tuple[int, int]):
    """``(frame, core)`` of ``x`` in ``layout``."""
    if layout == "overlap":
        frame, geo = pad_frame_overlap(x, *taps)
    else:
        frame, geo = pad_frame(x, taps[0])
    return frame, geo[:3]


def crop(layout: str, frame: torch.Tensor, taps, core) -> torch.Tensor:
    t0, h_img, w_img = core
    if layout == "overlap":
        return crop_frame_overlap(frame, taps[1], core)
    return frame[t0 : t0 + h_img, 128 : 128 + w_img]


def gate(kind: str, fir: FixedFir2d, check: torch.Tensor,
         golden: np.ndarray) -> None:
    """Raise unless kernel ``kind`` gives the golden on ``check``."""
    layout, kernel = PATHS[kind]
    frame, core = frame_of(layout, check, fir.taps)
    got = crop(layout, kernel(frame, fir, core), fir.taps, core)
    if not np.array_equal(got.cpu().numpy(), golden):
        raise AssertionError(f"backend {kind} is not bit-exact vs golden")


def frame_step_msps(kind: str, fir: FixedFir2d, x: torch.Tensor,
                    best_of: int) -> tuple[float, list[float]]:
    """Best and every sweep's Msamples/s of kernel ``kind`` chained two
    applies a step over the frame of ``x``, the second apply writing back
    into the step's input frame."""
    layout, kernel = PATHS[kind]
    frame, core = frame_of(layout, x, fir.taps)
    spare = torch.empty_like(frame)

    def step(y: torch.Tensor) -> torch.Tensor:
        return kernel(kernel(y, fir, core, out=spare), fir, core, out=y)

    r = _common.throughput(step, frame, repeats=5, best_of=best_of)
    samples = 2 * core[1] * core[2]  # two core-image applies a step
    runs = sorted(round(samples / s / 1e6, 1) for s in r["slopes"] if s > 0)
    return _common.msps(samples, r["seconds_per_apply"], x.device), runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help=f"a {QUICK_SIZE}² image, fewer sweeps")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    def body() -> dict:
        start = time.perf_counter()
        device = _build.resolve_device(args.device)
        qf = QFormat()
        size = QUICK_SIZE if args.quick else SIZE
        h = np.asarray(FILTER_BANK_2D["sharpen5"])
        taps_r, taps_c = h.shape
        rng = np.random.default_rng(SEED)
        x = rng.integers(0, 256, size=(size, size), dtype=np.uint8)
        x_dev = torch.from_numpy(x).to(device)
        check = x[:256, :512].copy()
        check_dev = torch.from_numpy(check).to(device)
        golden = fir2d_fixed_golden(check, h, qf)
        del x

        nnz = int(np.count_nonzero(quantize_2d(h, qf)))
        sol_mem = _common.SOL_MSPS
        sol_ops = PEAK_INT8_OPS_PER_S / (2 * nnz) / 1e6
        sol = min(sol_mem, sol_ops)

        fir = FixedFir2d.from_numpy(h, qf, device)
        for kind in PATHS:
            gate(kind, fir, check_dev, golden)
        if not np.array_equal(fir2d_fixed_torch(check_dev, h, qf).cpu()
                              .numpy(), golden):
            raise AssertionError("backend fir2d_fixed_torch is not "
                                 "bit-exact vs golden")

        best_of = 2 if args.quick else 5
        value, runs = frame_step_msps("fir2d_oframe", fir, x_dev, best_of)
        headline = {
            "metric": METRIC,
            "value": round(value, 1),
            "unit": UNIT,
            "vs_baseline": round(value / sol, 3),
            "backend": "fir2d_oframe",
            "workload": (f"{taps_r}x{taps_c} fixed 2-D FIR over "
                         f"{size}x{size} u8"),
            **_common.card(device),
            "sol_mem_msps": round(sol_mem, 1),
            "sol_ops_msps": round(sol_ops, 1),
            "sol_fraction": round(value / sol, 3),
            "bit_exact_vs_golden": True,
            "runs_msps": runs,
        }

        # Comparisons, each gated above, on stderr.
        extras = {"fir2d_oframe": round(value, 1)}
        for kind in ("fir2d_frame", "fir2d_bf16"):
            extras[kind] = round(frame_step_msps(kind, fir, x_dev, 1)[0], 1)
        r = _common.throughput(lambda a: fir2d_fixed_torch(a, h, qf), x_dev,
                               chain_short=2, chain_long=10, repeats=2)
        extras["fir2d_fixed_torch"] = round(
            _common.msps(x_dev.numel(), r["seconds_per_apply"], device), 1)
        if not args.quick:
            # gauss5: one digit plane fewer than sharpen5, still bit-exact.
            h_g = np.asarray(FILTER_BANK_2D["gauss5"])
            fir_g = FixedFir2d.from_numpy(h_g, qf, device)
            gate("fir2d_oframe", fir_g, check_dev,
                 fir2d_fixed_golden(check, h_g, qf))
            m_g, runs_g = frame_step_msps("fir2d_oframe", fir_g, x_dev,
                                          best_of)
            extras["gauss5_overlap"] = {"best_msps": round(m_g, 1),
                                        "runs_msps": runs_g,
                                        "bit_exact": True}
        extras["elapsed_s"] = round(time.perf_counter() - start, 1)
        _common.extras(extras)
        headline["elapsed_s"] = extras["elapsed_s"]
        return headline

    return _common.run(METRIC, UNIT, body)


if __name__ == "__main__":
    raise SystemExit(main())
