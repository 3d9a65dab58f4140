#!/usr/bin/env python3
"""Probe of kernels A (``fir_band``) and K (``fft_rows``) on one GPU.

    python3 warmup_fir_filter_tpu_torch/probe_kernels.py check
        build with ``-Xptxas -v`` (registers, stack and spills of
        ``fir_band.cu`` and ``fft_rows.cu``), then kernel A against its
        plain version over taps 1-257 x Q-formats x widths 1-40,000 and
        misaligned inputs (``torch.equal``), and kernel K against its
        float64 plain version at every size 2-16,384 (SNR >= 120 dB, within
        2e-4 of ``torch.fft``); exits 1 on a mismatch.
    python3 warmup_fir_filter_tpu_torch/probe_kernels.py times TREE LABEL
        CUDA-event medians (7 windows of 10 calls) of kernel A at 19,456 x
        8,192 u8 for 3-257 taps and on the 5-tap stream's 4,000 x 16,256
        window rows, a ``copy_``, and kernel K and ``torch.fft.fft`` at
        8,192 x 2,048, 1,024 x 16,384 and 65,536 x 256, for the port in
        the checkout at TREE (this one, or an older commit unpacked with
        ``git archive``), each line tagged LABEL.

Run it from the repository root; ``chip_smoke.py`` is the full check.
"""
import os
import statistics
import subprocess
import sys
import time


def check() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    from warmup_fir_filter_tpu_torch import _build
    from warmup_fir_filter_tpu_torch.kernels.fft import (
        fft_rows, fft_rows_plain)
    from warmup_fir_filter_tpu_torch.kernels.fir_band import (
        FixedFir1d, fir_band_plain)
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

    nvcc = _build.find_nvcc()
    _build.DEFAULT_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for src in ("fir_band.cu", "fft_rows.cu"):
        obj = _build.DEFAULT_BUILD_DIR / f"ptxas_{src}.o"
        t0 = time.perf_counter()
        p = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                            str(_build.CSRC_DIR), "-c", "-o", str(obj),
                            str(_build.CSRC_DIR / src)], capture_output=True,
                           text=True)
        obj.unlink(missing_ok=True)
        lines = [ln for ln in p.stderr.splitlines()
                 if "registers" in ln or "spill" in ln or "error" in ln]
        print(f"[ptxas] {src} rc={p.returncode} "
              f"{time.perf_counter() - t0:.1f} s")
        for ln in lines:
            if "error" in ln or "Used" in ln or (
                    "spill" in ln and " 0 bytes spill" not in ln):
                print("  ", ln.strip())
        if p.returncode:
            print(p.stderr[-3000:])
            return 1
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(1)
    fails = 0
    count = 0
    for fmt in ((16, 12, 32), (16, 12, 20), (8, 7, 16), (32, 12, 28)):
        qf = QFormat(*fmt)
        for taps in (1, 2, 3, 4, 5, 16, 17, 31, 32, 33, 63, 129, 257):
            span = min(qf.max_coeff_real, 8.0)
            h = np.clip(rng.uniform(-span, span, taps),
                        max(qf.min_coeff_real, -8), span)
            fir = FixedFir1d.from_numpy(h, qf, "cuda")
            fir_cpu = FixedFir1d.from_numpy(h, qf)
            for rows, n in ((3, 1), (7, 15), (3, 16), (9, 17), (2, 31),
                            (5, 127), (3, 4499), (2, 8192), (3, 16256),
                            (1, 40000)):
                x = rng.integers(0, 256, size=(rows, n), dtype=np.uint8)
                got = fir(torch.from_numpy(x).cuda()).cpu()
                want = fir_band_plain(torch.from_numpy(x), fir_cpu)
                count += 1
                if not torch.equal(got, want):
                    fails += 1
                    print("A MISMATCH", fmt, taps, rows, n,
                          int((got.int() - want.int()).abs().max()))
            # Misaligned input rows: a view at byte offset 1, 7 or 15.
            buf = torch.from_numpy(rng.integers(0, 256, size=5 * 333 + 16,
                                                dtype=np.uint8)).cuda()
            for off in (1, 7, 15):
                xv = buf[off:off + 5 * 333].view(5, 333)
                got = fir(xv).cpu()
                want = fir_band_plain(xv.cpu(), fir_cpu)
                count += 1
                if not torch.equal(got, want):
                    fails += 1
                    print("A MISALIGNED MISMATCH", fmt, taps, off)
    torch.cuda.synchronize()
    print(f"[A] {count} comparisons, {fails} mismatches")

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 200.0
    kf = 0
    for b in range(1, 15):
        n = 1 << b
        for batch in (1, 5, 1000):
            xr = torch.randn((batch, n), device="cuda", generator=gen)
            xi = torch.randn((batch, n), device="cuda", generator=gen)
            for mode, im, inv in (("c", xi, False), ("r", None, False),
                                  ("i", xi, True)):
                got = torch.stack(fft_rows(xr, im, inverse=inv)).double()
                want = torch.stack(fft_rows_plain(xr, im, inverse=inv))
                noise = float((got - want).square().mean())
                snr = (10 * np.log10(float(want.square().mean()) / noise)
                       if noise else 999)
                worst = min(worst, snr)
                x64 = torch.complex(xr.double(), torch.zeros_like(
                    xr, dtype=torch.float64) if im is None else im.double())
                ref = torch.fft.ifft(x64) if inv else torch.fft.fft(x64)
                err = float((torch.complex(got[0], got[1]) - ref).abs().max())
                if snr < 120 or err > 2e-4 * float(ref.abs().max()):
                    kf += 1
                    print("K FAIL", n, batch, mode, snr, err)
    torch.cuda.synchronize()
    print(f"[K] min SNR {worst:.1f} dB, {kf} failures")
    return 1 if fails or kf else 0


def times(tree: str, label: str) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    from warmup_fir_filter_tpu_torch import _build
    from warmup_fir_filter_tpu_torch.kernels.fft import fft_rows
    from warmup_fir_filter_tpu_torch.kernels.fir_band import FixedFir1d
    from warmup_fir_filter_tpu_torch.models.filters import FILTER_BANKS
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
    from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

    t0 = time.perf_counter()
    _build.load_library()
    print(f"[{label}] build {time.perf_counter() - t0:.2f} s", flush=True)

    def med(fn, reps=7, calls=10):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) / calls)
        return statistics.median(out), min(out), max(out)

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randint(0, 256, (19456, 8192), dtype=torch.uint8, device="cuda",
                      generator=gen)
    win = torch.randint(0, 256, (4000, 16256), dtype=torch.uint8,
                        device="cuda", generator=gen)
    qf = QFormat()
    runs = {}
    for taps in (3, 5, 16, 32, 33, 63, 129, 257):
        h = (np.asarray(FILTER_BANKS[taps]["sharpen"]) if taps in (3, 5)
             else design_lowpass(taps, 0.2))
        fir = FixedFir1d.from_numpy(h, qf, "cuda")
        runs[f"A {taps} taps 19456x8192"] = (lambda f=fir: f(x))
    fir5 = FixedFir1d.from_numpy(FILTER_BANKS[5]["sharpen"], qf, "cuda")
    runs["A 5 taps stream windows 4000x16256"] = lambda: fir5(win)
    dst = torch.empty_like(x)
    runs["copy 19456x8192 u8"] = lambda: dst.copy_(x)
    for rows, n in ((8192, 2048), (1024, 16384), (65536, 256)):
        xr = torch.randn((rows, n), device="cuda", generator=gen)
        xi = torch.randn((rows, n), device="cuda", generator=gen)
        c = torch.complex(xr, xi)
        runs[f"K {rows}x{n}"] = (lambda a=xr, b=xi:
                                 fft_rows(a, b, inverse=False))
        runs[f"torch.fft.fft {rows}x{n}"] = (lambda cc=c: torch.fft.fft(cc))
    for name, fn in runs.items():
        m, lo, hi = med(fn)
        print(f"[{label}] {name}: median {m:.4f} ms (min {lo:.4f}, "
              f"max {hi:.4f})", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["check"]:
        sys.exit(check())
    if sys.argv[1:2] == ["times"] and len(sys.argv) == 4:
        times(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(__doc__)
