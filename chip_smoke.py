#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Every phase raises on failure, so the process exits non-zero unless all
of them pass:

1. device   CUDA is present; print the card's name and power limit
            (``nvidia-smi``); note whether Pillow is installed.
2. build    compile ``warmup_fir_filter_tpu_torch/csrc/*.cu`` with nvcc
            from a clean build directory; print the seconds.
3. kernels  each kernel against its plain PyTorch version (``torch.equal``,
            tolerance 0) over taps × widths × Q-formats, at the main path's
            shapes, and against the host golden on the small shapes.
4. main     the port's CLI (``--backend auto --device cuda``) over a
            synthetic corpus at the reference corpus's size (seven images,
            67,975,252 samples per tap group); every fixed output against
            the host golden; the band kernel must have carried every fixed
            output.  Then the same fixed stage with ``--backend direct``,
            which kernel B must carry.  Launch counts are zeroed once
            before both runs: ``launches`` is their total, and
            ``launches_auto`` / ``launches_backend_direct`` split it.
5. times    CUDA-event medians (per call, over windows of back-to-back
            calls) of kernel A, kernel B and the plain direct path on one
            19,456 × 8,192 uint8 array, 5-tap sharpen, Q4.12.

Then one JSON line per the kernels, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Inputs come from numpy/torch
generators seeded with ``SEED``.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.cli import main as cli_main
from warmup_fir_filter_tpu_torch.kernels.fir_band import (
    FixedFir1d,
    fir_band,
    fir_band_plain,
)
from warmup_fir_filter_tpu_torch.kernels.fir_direct import fir_direct
from warmup_fir_filter_tpu_torch.ops.fir1d import fir1d_fixed_rows_torch
from warmup_fir_filter_tpu_torch.reference import (
    FILTER_BANKS,
    ArtifactStore,
    QFormat,
    fir1d_fixed_golden_rows,
    render_image,
    save_gray_png,
    save_npy,
    write_json,
)

SEED = 20261016
REPO_ROOT = Path(__file__).resolve().parent
WORK_DIR = REPO_ROOT / "artifacts" / "chip_smoke"

#: (coeff_bits, frac_bits, acc_bits) of the SWEEP cells of
#: tests/test_qformat_sweep.py:30-40 (wrap-needing and multi-digit ones).
FORMATS = ((8, 4, 32), (8, 7, 16), (16, 12, 32), (16, 12, 20), (16, 8, 24),
           (16, 15, 31), (32, 24, 32), (32, 12, 28), (16, 1, 8))
BAND_TAPS = (1, 2, 3, 4, 5, 63, 129, 256, 257)
BAND_WIDTHS = (1, 64, 127, 150, 400, 4499, 32768, 32769, 40000)
DIRECT_TAPS = (1, 5, 258, 300, 4097, 5000)
DIRECT_WIDTHS = (1, 127, 4499, 40000)
ROWS = 4
GOLDEN_MAX_WIDTH = 4499
#: The seven images of the reference corpus by size (W×H 1280×853,
#: 640×762, 1280×854, 64×64, 64×64 noise, 4499×2999, 1280×641), rendered
#: by the reference's synthetic generator as (rows, cols).  Its "stripes"
#: kind renders a single row whatever the shape, so it is not used.
CORPUS = (
    ("img_001_gradient", "gradient", (853, 1280)),
    ("img_002_checker", "checker", (762, 640)),
    ("img_003_steps", "steps", (854, 1280)),
    ("img_004_tiny", "gradient", (64, 64)),
    ("img_005_noise", "noise", (64, 64)),
    ("img_006_large_mix", "mix", (2999, 4499)),
    ("img_007_checker", "checker", (641, 1280)),
)
FIXED_OUTPUTS = len(CORPUS) * 4 * 2  # images × filters × tap groups
BENCH_SHAPE = (19456, 8192)
TIMING_WARMUP = 2
TIMING_REPS = 7      # timed windows per path; the median is reported
TIMING_LAUNCHES = 10  # back-to-back calls per window


def phase(name: str) -> None:
    print(f"[chip_smoke] phase {name}", flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def random_taps(rng: np.random.Generator, qf, num_taps: int) -> np.ndarray:
    """Taps spread over the format's range, as the sweep tests draw them."""
    span = min(qf.max_coeff_real, 8.0)
    return np.clip(rng.uniform(-span, span, size=num_taps),
                   max(qf.min_coeff_real, -8.0), span)


class Agreement:
    """Counts kernel-vs-plain comparisons and their largest difference."""

    def __init__(self):
        self.count = 0
        self.max_abs_err = 0

    def check(self, got, want, label: str) -> None:
        got = got.cpu()
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) \
            if got.numel() else 0
        self.max_abs_err = max(self.max_abs_err, err)
        self.count += 1
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: kernel != plain (max |diff| {err})")


def check_kernels(agree_band: Agreement, agree_direct: Agreement) -> None:
    golden = fir1d_fixed_golden_rows
    rng = np.random.default_rng(SEED)

    def gate_golden(got, x, h, qf, label):
        if x.shape[1] <= GOLDEN_MAX_WIDTH and not np.array_equal(
                got.cpu().numpy(), golden(x, h, qf)):
            raise AssertionError(f"{label}: kernel != host golden")

    cells = [(QFormat(*f), L, random_taps(rng, QFormat(*f), L))
             for f in FORMATS for L in BAND_TAPS]
    # Q4.12 moving average: 1365 needs two digit planes.
    cells.append((QFormat(), 3, np.asarray(FILTER_BANKS[3]["moving_avg"])))
    for qf, num_taps, h in cells:
        fir = FixedFir1d.from_numpy(h, qf, "cuda")
        fir_cpu = FixedFir1d.from_numpy(h, qf, "cpu")
        for n in BAND_WIDTHS:
            x = rng.integers(0, 256, size=(ROWS, n), dtype=np.uint8)
            label = (f"band L={num_taps} N={n} fmt=({qf.coeff_bits},"
                     f"{qf.frac_bits},{qf.acc_bits})")
            got = fir(torch.from_numpy(x).cuda())
            agree_band.check(got, fir_band_plain(torch.from_numpy(x),
                                                        fir_cpu), label)
            gate_golden(got, x, h, qf, label)
    for f in FORMATS:
        qf = QFormat(*f)
        for num_taps in DIRECT_TAPS:
            h = random_taps(rng, qf, num_taps)
            for n in DIRECT_WIDTHS:
                x = rng.integers(0, 256, size=(ROWS, n), dtype=np.uint8)
                label = f"direct L={num_taps} N={n} fmt={f}"
                got = fir_direct(torch.from_numpy(x).cuda(), h, qf)
                want = fir1d_fixed_rows_torch(torch.from_numpy(x), h, qf)
                agree_direct.check(got, want, label)
                gate_golden(got, x, h, qf, label)
    print(f"[chip_smoke] grid: band {agree_band.count} cells, direct "
          f"{agree_direct.count} cells, all torch.equal", flush=True)

    # The main path's own shapes and filters.
    qf = QFormat()
    for shape in sorted({spec[2] for spec in CORPUS}):
        x = torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))
        xd = x.cuda()
        for tap in (3, 5):
            for name, h in FILTER_BANKS[tap].items():
                label = f"{name} {tap}tap shape={shape}"
                agree_band.check(
                    FixedFir1d.from_numpy(h, qf, "cuda")(xd),
                    fir_band_plain(x, FixedFir1d.from_numpy(h, qf)),
                    f"band {label}")
                agree_direct.check(
                    fir_direct(xd, h, qf),
                    fir1d_fixed_rows_torch(x, h, qf),
                    f"direct {label}")
    torch.cuda.synchronize()
    print(f"[chip_smoke] kernels: band {agree_band.count} comparisons, "
          f"direct {agree_direct.count}, max |diff| "
          f"{max(agree_band.max_abs_err, agree_direct.max_abs_err)}",
          flush=True)


def write_corpus(have_pil: bool) -> tuple[Path | None, list[str]]:
    """Render the corpus; PNGs when Pillow exists, else input vectors."""
    rng = np.random.default_rng(SEED)
    images = [(stem, render_image(kind, shape, rng))
              for stem, kind, shape in CORPUS]
    if have_pil:
        image_dir = WORK_DIR / "img"
        for stem, img in images:
            save_gray_png(image_dir / f"{stem}.png", img)
        return image_dir, []
    store = ArtifactStore(WORK_DIR / "artifacts")
    cases = []
    for idx, (stem, img) in enumerate(sorted(images, key=lambda s: s[0].lower())):
        case = store.case_name(idx, stem)
        save_npy(store.input_vector_path(case), img)
        cases.append({"case_name": case, "image_name": f"{stem}.png",
                      "width": int(img.shape[1]), "height": int(img.shape[0]),
                      "dtype": "uint8",
                      "data_npy": store.input_vector_path(case).name})
    write_json(store.manifest_path(), {
        "note": "FIR input vectors rendered in memory (no Pillow).",
        "num_images": len(cases), "cases": cases,
    })
    print("[chip_smoke] Pillow missing: stage 1 (PNG decode) and stage 5 "
          "(PNG restore) skipped; input vectors written directly", flush=True)
    return None, ["--skip-input", "--skip-restore"]


def check_fixed_outputs(store, goldens: dict) -> None:
    count = 0
    for in_path in store.iter_input_vectors():
        case = store.case_stem_of_input(in_path)
        x = np.load(in_path)
        for tap in (3, 5):
            for name, h in FILTER_BANKS[tap].items():
                key = (case, tap, name)
                if key not in goldens:
                    goldens[key] = fir1d_fixed_golden_rows(
                        x, np.asarray(h), QFormat())
                y = np.load(store.output_vector_path("fixed", tap, case, name))
                if not np.array_equal(y, goldens[key]):
                    raise AssertionError(f"fixed output {key} != host golden")
                count += 1
    if count != FIXED_OUTPUTS:
        raise AssertionError(f"{count} fixed outputs, expected {FIXED_OUTPUTS}")


def run_main_path(have_pil: bool) -> dict:
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    image_dir, skips = write_corpus(have_pil)
    root = WORK_DIR / "artifacts"
    store = ArtifactStore(root)
    argv = ["--artifact-root", str(root), "--device", "cuda"]
    if image_dir is not None:
        argv += ["--image-dir", str(image_dir)]

    def counts() -> dict:
        return {"fir_band": fir_band.launches, "fir_direct": fir_direct.launches}

    # The main path is two CLI runs: the 5-stage pipeline with the default
    # backend (kernel A), then the fixed stage with --backend direct
    # (kernel B), which no 3- or 5-tap filter reaches through "auto".
    fir_band.launches = fir_direct.launches = 0
    start = time.perf_counter()
    cli_main(argv + ["--backend", "auto"] + skips)
    auto_s = time.perf_counter() - start
    auto = counts()
    print(f"[chip_smoke] main path --backend auto: {auto_s:.3f} s host clock, "
          f"launches {auto}", flush=True)
    if auto["fir_band"] < FIXED_OUTPUTS or auto["fir_direct"] != 0:
        raise AssertionError(f"launch counts {auto}: expected fir_band >= "
                             f"{FIXED_OUTPUTS} and fir_direct == 0")
    for tap in (3, 5):
        summary = store.report_dir(tap) / f"compare_{tap}tap_summary.json"
        if not summary.is_file():
            raise AssertionError(f"missing compare summary {summary}")
        overall = json.loads(summary.read_text())["overall"]
        print(f"[chip_smoke] {tap}tap compare: {overall['num_cases']} cases, "
              f"{overall['num_samples_total']} samples", flush=True)
    goldens: dict = {}
    check_fixed_outputs(store, goldens)
    print(f"[chip_smoke] {FIXED_OUTPUTS} fixed outputs == host golden "
          "(band kernel)", flush=True)

    start = time.perf_counter()
    cli_main([
        "--artifact-root", str(root), "--device", "cuda", "--backend",
        "direct", "--skip-input", "--skip-ideal", "--skip-report",
        "--skip-restore", "--overwrite-vectors"])
    direct_s = time.perf_counter() - start
    total = counts()
    direct = {name: total[name] - auto[name] for name in total}
    print(f"[chip_smoke] fixed stage --backend direct: {direct_s:.3f} s host "
          f"clock, launches {direct}", flush=True)
    if direct["fir_direct"] < FIXED_OUTPUTS or direct["fir_band"] != 0:
        raise AssertionError("direct backend did not run through kernel B alone")
    check_fixed_outputs(store, goldens)
    print(f"[chip_smoke] {FIXED_OUTPUTS} fixed outputs == host golden "
          "(direct kernel)", flush=True)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    return {name: {"launches": total[name], "launches_auto": auto[name],
                   "launches_backend_direct": direct[name]}
            for name in total}


def time_kernels(card: str) -> dict:
    qf = QFormat()
    h = FILTER_BANKS[5]["sharpen"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randint(0, 256, BENCH_SHAPE, dtype=torch.uint8, device="cuda",
                      generator=gen)
    fir = FixedFir1d.from_numpy(h, qf, "cuda")
    runs = {
        "fir_band": lambda: fir(x),
        "fir_direct": lambda: fir_direct(x, h, qf),
        "torch_direct": lambda: fir1d_fixed_rows_torch(x, h, qf),
    }
    x64 = x[:64].cpu().numpy()
    want64 = fir1d_fixed_golden_rows(x64, np.asarray(h), qf)
    outs = {name: fn() for name, fn in runs.items()}
    for name, out in outs.items():
        if not np.array_equal(out[:64].cpu().numpy(), want64):
            raise AssertionError(f"{name} != host golden on 64 rows")
        if not torch.equal(out, outs["torch_direct"]):
            raise AssertionError(f"{name} != torch_direct on the full array")
    del outs
    for _ in range(TIMING_WARMUP):
        for fn in runs.values():
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in runs}
    for _ in range(TIMING_REPS):
        for name, fn in runs.items():  # interleaved, one card, one process
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(TIMING_LAUNCHES):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / TIMING_LAUNCHES)
    samples = BENCH_SHAPE[0] * BENCH_SHAPE[1]
    medians = {}
    for name, ms in times.items():
        med = statistics.median(ms)
        medians[name] = med
        print(f"[chip_smoke] time {name}: median {med:.4f} ms of "
              f"{TIMING_REPS}x{TIMING_LAUNCHES} calls (min {min(ms):.4f}, "
              f"max {max(ms):.4f}) "
              f"{samples / med / 1e3:.1f} Msamples/s "
              f"{2 * samples / med / 1e6:.1f} GB/s effective "
              f"[{BENCH_SHAPE[0]}x{BENCH_SHAPE[1]} u8, 5-tap sharpen, Q4.12; "
              f"{card}]", flush=True)
    return medians


def main() -> int:
    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[chip_smoke] card: {card}", flush=True)
    print(f"[chip_smoke] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    try:
        import PIL  # noqa: F401

        have_pil = True
    except ImportError:
        have_pil = False
    print(f"[chip_smoke] Pillow installed: {have_pil}", flush=True)

    phase("2 build")
    shutil.rmtree(_build.DEFAULT_BUILD_DIR, ignore_errors=True)
    start = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - start
    print(f"[chip_smoke] build: {build_s:.2f} s (nvcc {_build.find_nvcc()}, "
          f"{len(_build.kernel_sources())} sources)", flush=True)

    phase("3 kernels vs plain")
    agree_band, agree_direct = Agreement(), Agreement()
    check_kernels(agree_band, agree_direct)

    phase("4 main path")
    launches = run_main_path(have_pil)

    phase("5 times")
    medians = time_kernels(card)

    kernels = [
        {"name": "fir_band", "route": "cuda",
         "source": "warmup_fir_filter_tpu_torch/csrc/fir_band.cu",
         "replaces": "warmup_fir_filter_tpu/kernels/fir_mxu.py:248",
         "also_replaces": "warmup_fir_filter_tpu/kernels/fir_mxu.py:371",
         **launches["fir_band"],
         "max_abs_err": agree_band.max_abs_err,
         "comparisons": agree_band.count,
         "ms": medians["fir_band"], "plain_ms": medians["torch_direct"]},
        {"name": "fir_direct", "route": "cuda",
         "source": "warmup_fir_filter_tpu_torch/csrc/fir_direct.cu",
         "replaces": "warmup_fir_filter_tpu/kernels/fir_pallas.py:62",
         **launches["fir_direct"],
         "max_abs_err": agree_direct.max_abs_err,
         "comparisons": agree_direct.count,
         "ms": medians["fir_direct"], "plain_ms": medians["torch_direct"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
