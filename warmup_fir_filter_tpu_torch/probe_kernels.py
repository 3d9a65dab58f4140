#!/usr/bin/env python3
"""Probe of kernels A (``fir_band``), B (``fir_direct``), C (``fir_window``),
E (``fir2d_frame``),
F (``fir2d_oframe``), G (``fir2d_bf16``), H (``fir_float``), I
(``resample``), J (``chain_fused``), K (``fft_rows``), L (``osfilt``) and
M (``osfilt_stream``) on one GPU.

    python3 warmup_fir_filter_tpu_torch/probe_kernels.py check [chain|direct]
        ``nvcc -Xptxas -v`` on ``fir_band.cu``, ``fir_direct.cu``,
        ``fir_window.cu``,
        ``fir2d_frame.cu``, ``fir2d_bf16.cu``, ``fft_rows.cu``,
        ``osfilt.cu``, ``osfilt_stream.cu``, ``fir_float.cu``,
        ``resample.cu`` and ``chain_fused.cu`` (registers, stack and spills
        of each kernel, and how many ``IMMA``, ``HMMA``, ``LDS`` and
        ``FFMA`` instructions its SASS from ``cuobjdump -sass`` holds, all
        compiles started together), then kernel A against its plain
        version over taps 1-257 x Q-formats x widths 1-40,000 and
        misaligned inputs (``torch.equal``), kernel C over taps 1-4,096 x
        widths 1-4,099 x rows 1-33 x Q-formats and misaligned inputs,
        kernels E, F and G over whole frames (E: Lc 1-257 x Lr 1-33 x
        widths 1-4,099; F: Lc 2-97 x Lr 1-33; G: Lc 2-97 x Lr 1-17; each
        over formats, noise frames and frames at byte offsets; E and F
        ``torch.equal``, G too where its f32 sums are exact, else within
        1), kernel K against
        its float64 plain version at every size 2-16,384 (SNR >= 120 dB,
        within 2e-4 of ``torch.fft``), kernel L at every nfft 2-16,384 and
        kernel M over its stream cases and window-plan edges against their
        float64 plain versions (SNR >= 120 dB; u8 out within 1 on under
        0.1%), kernel I over RESAMPLE_CHECK_RATES x widths 1-40,001
        (>= 120 dB) and kernel J over CHAIN_CHECK_GEOMETRIES and
        ``rs_bounds`` windows in "highest" (>= 95 dB) and "bf16" (> 60 dB
        against its plain version); exits 1 on a mismatch.  With ``chain``:
        only ``fir_float.cu``, ``resample.cu`` and ``chain_fused.cu``, and
        only kernels I and J.  With ``direct``: only ``fir_direct.cu``,
        ``fir_float.cu`` and ``fir_window.cu``, then kernel B against its
        plain version and the int32 path over 1-8,193 taps x widths x
        Q-formats x chunk lengths and against kernels A and C at 19,456 x
        8,192, kernel H against its plain version at every alignment, and
        kernel C's grid.
    python3 warmup_fir_filter_tpu_torch/probe_kernels.py check band
        ``-Xptxas -v`` and the SASS counts of ``fir_band.cu`` alone, then
        kernel A against its plain version over BAND_CHECK_TAPS x
        Q-formats (one to five digit planes) x widths 1-40,000 and inputs
        at byte offsets 1-15 (``torch.equal``).
    python3 warmup_fir_filter_tpu_torch/probe_kernels.py times TREE LABEL band
        Kernel A at 19,456 x 8,192 u8 for BAND_TIMING_TAPS and
        BAND_CROSSOVER_TAPS (the sharpen filters at 3 and 5 taps,
        ``design_lowpass(L, 0.2)`` beyond, Q4.12) with the SHA-256 of its
        outputs, kernel C's entry (``FixedFirWindow``) on the same filters
        from 33 taps (kernel A's yardstick), and, where the tree has it,
        A's digit-plane route alone (``wft_fir_band_planes``) at
        BAND_CROSSOVER_TAPS: the crossover with the short-tap route.
    python3 warmup_fir_filter_tpu_torch/probe_kernels.py times TREE LABEL [chain|direct]
        CUDA-event medians (7 windows of 10 calls) at BASELINE config 5's
        shapes of kernel I (32 x 2,000,000, 2/3, 63 taps) and its
        ``F.conv1d`` yardstick, kernel H (32 x 1,333,334, 63 taps), kernel
        J (16 x 2,000,000 I/Q) in "highest" and "bf16" and
        ``chain_forward`` "auto" and staged "mxu", with the SHA-256 of I's
        and J's outputs; then (unless ``chain``) kernel A at 19,456 x
        8,192 u8 for 3-257 taps and on the 5-tap stream's 4,000 x 16,256
        window rows, a ``copy_``, kernel K and ``torch.fft.fft`` at 8,192 x
        2,048, 1,024 x 16,384 and 65,536 x 256, kernel C (``fir_window``)
        at 258, 1,001, 2,048 and 4,096 taps at 19,456 x 8,192 and at 1,001
        taps on a long-tap stream block (16 x 4,001,000 u8), kernels E, F
        and G and a frame ``copy_`` at ``bench_2d.py``'s 8192² for sharpen5
        and gauss5, E also for the 3 x 129 and 3 x 257 filters
        ``fir2d_fixed_auto`` sends it, and
        at BASELINE config 4 (16 x 10,000,000, 63 taps) kernel M (f32, and
        u8 in and out), kernel L over the stream framed at nfft 2,048,
        ``F.conv1d`` (TF32 off) and the ``torch.fft`` overlap-save, for the
        port in the checkout at TREE (this one, or an older commit unpacked
        with ``git archive``), each line tagged LABEL.  With ``direct``:
        only kernel B at 19,456 x 8,192 u8 for 5, 1,001, 4,097 and 8,193
        taps of ``design_lowpass(L, 0.25)``, Q4.12, with its outputs'
        SHA-256, and kernels C at 4,096 taps and A at 5 beside it.
    python3 warmup_fir_filter_tpu_torch/probe_kernels.py variant TREE LABEL
        For a variant of the FFT kernels' sources in the checkout at TREE:
        ``-Xptxas -v`` of ``fft_rows.cu``, ``osfilt.cu`` and
        ``osfilt_stream.cu`` as one line a source (registers of each
        instance, and its stack and spill bytes where not 0), kernels M
        and L against their plain versions at config 4 (SNR), and the
        CUDA-event medians of M (f32; u8 in and out), L over config 4
        framed at nfft 2,048 and K at 8,192 x 2,048.
    python3 warmup_fir_filter_tpu_torch/probe_kernels.py planes TREE LABEL
        For a variant of kernel A's digit-plane route in the checkout at
        TREE (``wft_band.cuh`` with one part removed or one constant
        changed, to see what each part costs): the route alone, through
        ``wft_fir_band_planes``, at 19,456 x 8,192 u8 for PLANES_TAPS of
        ``design_lowpass(L, 0.2)``, Q4.12, as one line of CUDA-event
        medians.  A removed part leaves wrong outputs, so nothing is
        compared; time the variants beside this tree in one call.

Run it from the repository root; ``chip_smoke.py`` is the full check.
"""
import os
import statistics
import subprocess
import sys
import time

# The checkout's root, searched after any tree the probe is pointed at:
# its yardsticks.py (no port imports) serves every tree.
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: Kernel M's (C, T, L, off) in ``check``: chip_smoke.py's STREAM_FFT_CASES.
STREAM_CASES = ((3, 2000, 63, 0), (2, 1111, 63, 31), (1, 700, 5, 0),
                (4, 4096, 129, 64), (2, 900, 257, 128), (2, 513, 63, 62),
                (3, 300, 63, 0), (2, 257, 1, 0), (2, 1, 63, 0),
                (2, 511, 63, 0), (2, 40001, 63, 0), (2, 3000, 1, 0),
                (2, 3000, 2, 0), (2, 3000, 129, 0), (2, 3000, 257, 0),
                (2, 449, 63, 0), (2, 450, 63, 0), (2, 451, 63, 0),
                (2, 3000, 63, 31), (2, 3000, 63, 62))
PTXAS_SOURCES = ("fir_band.cu", "fir_direct.cu", "fir_window.cu",
                 "fir2d_frame.cu", "fir2d_bf16.cu", "fft_rows.cu", "osfilt.cu",
                 "osfilt_stream.cu", "fir_float.cu", "resample.cu",
                 "chain_fused.cu")
CHAIN_SOURCES = ("fir_float.cu", "resample.cu", "chain_fused.cu")
DIRECT_SOURCES = ("fir_direct.cu", "fir_float.cu", "fir_window.cu")
#: Kernel B's tap counts in ``check direct``: each side of the short
#: route's 32 taps, of kernel C's 4,096, and several chunks.
DIRECT_CHECK_TAPS = (1, 5, 32, 33, 258, 1001, 4096, 4097, 5000, 8193)
#: The instructions counted in each kernel's SASS: tensor-core products,
#: shared-memory loads and f32 FMAs.
SASS_OPS = ("IMMA", "HMMA", "LDS", "FFMA")
#: Kernel I's rates in ``check`` (up, down, taps): PERF.md's and
#: chip_smoke.py's grid, a pure upsample, 1/4, and on the compact route a
#: rate past the compiled cores (2/9), 1/16 and 1/56.
RESAMPLE_CHECK_RATES = ((2, 3, 63), (4, 3, 47), (2, 1, 33), (8, 5, 63),
                        (1, 2, 31), (2, 3, 95), (2, 3, 160), (1, 1, 31),
                        (4, 5, 63), (1, 4, 31), (128, 3, 400), (2, 9, 63),
                        (1, 16, 63), (1, 56, 63))
#: Kernel I with 15,000 taps a branch at 2/1 (the compact route): each
#: output within the bound of a recursive f32 sum (chip_smoke.py's
#: RESAMPLE_LONG_BRANCH).
RESAMPLE_LONG_BRANCH = (2, 1, 29999)
#: Kernel J's geometries in ``check`` (up, down, rs_taps, ch_taps, channels),
#: 2/9 and a 10,001-tap branch at 2/1 on the compact route.
CHAIN_CHECK_GEOMETRIES = ((2, 3, 63, 63, 16), (4, 3, 47, 31, 8),
                          (2, 1, 33, 97, 8), (8, 5, 63, 129, 16),
                          (1, 2, 31, 63, 8), (2, 3, 95, 257, 24),
                          (4, 5, 63, 2, 8), (2, 9, 63, 63, 8),
                          (1, 4, 31, 63, 8), (2, 1, 20001, 63, 8))
#: Kernel J at 1/8 and 1/15 (the compact route) on planes whose FM signal
#: is narrowed by P/Q to fit the band the chain keeps (chip_smoke.py's
#: CHAIN_LOW_RATES).
CHAIN_CHECK_LOW_RATES = ((1, 8, 63, 63, 8), (1, 15, 63, 63, 8))
#: Kernels I and J's rates in ``times`` (up, down), 63 taps: each compiled
#: core's Q (1-5), and rates whose shapes take the compact route.
RATE_TIMINGS = ((2, 1), (1, 2), (2, 3), (1, 3), (1, 4), (4, 5), (1, 5),
                (1, 8), (1, 16))
FFT_SOURCES = ("fft_rows.cu", "osfilt.cu", "osfilt_stream.cu")
#: Kernel A's tap counts in ``check band``: either side of the crossover
#: (6, 7) and of each chunk count of the digit planes.
BAND_CHECK_TAPS = (1, 5, 6, 7, 16, 17, 24, 31, 32, 33, 34, 47, 48, 63, 64,
                   65, 80, 97, 112, 129, 144, 176, 208, 255, 256, 257)
#: Kernel A's timed tap counts in ``times band``: the 5-tap bank, the
#: short-tap route's crossover, and the digit planes' range.
BAND_TIMING_TAPS = (5, 16, 24, 32, 33, 63, 129, 257)
#: Kernel A's tap counts in ``planes``: one chunk, two (aligned rows), three
#: (misaligned rows), five and nine.
PLANES_TAPS = (16, 33, 63, 129, 257)
#: Tap counts of the short-tap route at which ``times band`` also times the
#: digit-plane route alone (``wft_fir_band_planes``), where the tree has it.
BAND_CROSSOVER_TAPS = (3, 5, 6, 7, 8, 12, 16, 24, 32)


def ptxas(label: str, sources=PTXAS_SOURCES) -> int:
    """``nvcc -Xptxas -v`` on ``sources``, all started together: one line a
    source with each kernel instance's registers, and its stack and spill
    bytes where they are not 0, then each kernel's count of ``IMMA`` and
    ``HMMA`` instructions (``cuobjdump -sass``).  Returns the number of
    failed compiles."""
    import re

    from warmup_fir_filter_tpu_torch import _build

    nvcc = _build.find_nvcc()
    _build.DEFAULT_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {src: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(_build.CSRC_DIR), "-c", "-o",
         str(_build.DEFAULT_BUILD_DIR / f"ptxas_{src}.o"),
         str(_build.CSRC_DIR / src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src in sources}
    def kernel_name(mangled: str) -> str:
        """``name<template arguments>`` of a mangled entry: the
        length-prefixed part that ends in ``_kernel``, then its arguments'
        ints and types (``f`` f32, ``t`` the bf16 bits)."""
        types = {"f": "f32", "t": "bf16", "h": "u8"}
        for m in re.finditer(r"\d+", mangled):
            for k in range(m.start(), m.end()):  # a hash may end in digits
                part = mangled[m.end():m.end() + int(mangled[k:m.end()])]
                if part.endswith("_kernel"):
                    rest = mangled[m.end() + len(part):].split("EEv")[0]
                    args = re.findall(r"L[ib](-?\d+)E|^I?([fth])(?=L|$)",
                                      rest)
                    return f"{part}<{','.join(a or types[b] for a, b in args)}>"
        return mangled

    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    failed = 0
    for src, proc in procs.items():
        _, err = proc.communicate()
        obj = _build.DEFAULT_BUILD_DIR / f"ptxas_{src}.o"
        ops = {}
        if proc.returncode == 0 and os.path.exists(cuobjdump):
            sass = subprocess.run([cuobjdump, "-sass", str(obj)],
                                  capture_output=True, text=True).stdout
            fn = None
            for ln in sass.splitlines():
                m = re.search(r"Function : (\w+)", ln)
                if m:
                    fn = kernel_name(m.group(1))
                    ops[fn] = dict.fromkeys(SASS_OPS, 0)
                elif fn:
                    for op in SASS_OPS:
                        ops[fn][op] += re.search(rf"\b{op}\b", ln) is not None
        obj.unlink(missing_ok=True)
        name, rows = None, []
        for ln in err.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                name = kernel_name(m.group(1))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                rows.append(f"{name}:{m.group(1)}r")
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill", ln)
            if m and (m.group(1) != "0" or m.group(2) != "0"):
                rows.append(f"[{name} stack {m.group(1)} spill {m.group(2)}]")
            if "error" in ln:
                rows.append(ln.strip())
        print(f"[{label}] ptxas {src} rc={proc.returncode}: " + " ".join(rows),
              flush=True)
        print(f"[{label}] sass {src}: " + (" ".join(
            f"{fn}:" + ",".join(f"{op}={n}" for op, n in counts.items() if n)
            for fn, counts in ops.items()) or "cuobjdump not run"),
              flush=True)
        failed += proc.returncode != 0
    print(f"[{label}] ptxas {time.perf_counter() - t0:.1f} s", flush=True)
    return failed


def median_ms(fn, reps=7, calls=10) -> tuple[float, float, float]:
    """Median, least and most ms a call of ``fn`` over ``reps`` CUDA-event
    windows of ``calls`` back-to-back calls, after one warm-up call."""
    import torch

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


def snr_db(want, got) -> float:
    import numpy as np

    noise = float((got.double() - want.double()).square().sum())
    return (10 * np.log10(float(want.double().square().sum()) / noise)
            if noise else 999.0)


def fm_planes_on_card(channels: int, time_len: int, gen, k_f: float = 0.05,
                      band: float = 1.0):
    """FM I/Q planes made on the card, as chip_smoke.py's ``fm_planes``:
    white noise low-passed at 0.05 and scaled to a peak of 1 (the message
    the bf16 bound of tests/test_demod_chain.py:198-214 assumes), phase
    ``2 pi k_f`` times its running sum in float64; ``band`` scales the
    cutoff and ``k_f``."""
    import math

    import torch

    from warmup_fir_filter_tpu_torch.ops.fir1d import fir1d_ideal_rows_torch
    from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

    msg = fir1d_ideal_rows_torch(torch.randn(
        (channels, time_len), device="cuda", generator=gen),
        design_lowpass(63, 0.05 * band)).double()
    phase = torch.cumsum(msg / msg.abs().max(), dim=1) * (
        2 * math.pi * k_f * band)
    return torch.cos(phase).float(), torch.sin(phase).float()


def check_chain(rng) -> int:
    """Kernel I against ``resample_plain`` over RESAMPLE_CHECK_RATES x
    widths 1-40,001 (SNR >= 120 dB), inputs at a 4-byte offset included,
    and at RESAMPLE_LONG_BRANCH within the f32 summation bound; kernel J
    against ``chain_fused_plain`` over CHAIN_CHECK_GEOMETRIES and
    CHAIN_CHECK_LOW_RATES in "highest" (>= 95 dB, message 0 = 0) and
    "bf16" (> 60 dB against its own plain version, > 40 against the f32
    one without a window), and over ``rs_bounds`` windows at 2/3.  Returns
    the failures."""
    import numpy as np
    import torch

    from warmup_fir_filter_tpu_torch.kernels.chain_fused import (
        FusedChain, chain_fused, chain_fused_plain)
    from warmup_fir_filter_tpu_torch.kernels.resample import (
        PolyphaseResampler, resample, resample_plain)
    from warmup_fir_filter_tpu_torch.models.chain import ChainConfig
    from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

    gen = torch.Generator(device="cuda").manual_seed(3)
    fails, worst_i, count_i = 0, 999.0, 0
    for up, down, taps in RESAMPLE_CHECK_RATES:
        rs = PolyphaseResampler(design_lowpass(taps, 0.9 / max(up, down),
                                               gain=up), up, down, "cuda")
        for n in (1, 7, 1535, 1537, 3457, 40001):
            buf = torch.randn(3 * n + 1, device="cuda", generator=gen)
            for x in (buf[:3 * n].view(3, n), buf[1:].view(3, n)):
                snr = snr_db(resample_plain(x, rs), resample(x, rs))
                worst_i, count_i = min(worst_i, snr), count_i + 1
                if snr < 120:
                    fails += 1
                    print("I FAIL", up, down, taps, n, snr)
    up, down, taps = RESAMPLE_LONG_BRANCH
    h = design_lowpass(taps, 0.9 / max(up, down), gain=up)
    rs = PolyphaseResampler(h, up, down, "cuda")
    rs_abs = PolyphaseResampler(np.abs(h), up, down, "cuda")
    gamma = rs.branch_len * 2.0 ** -24 / (1 - rs.branch_len * 2.0 ** -24)
    for n in (1, 7, 3457, 40001):
        x = torch.randn((3, n), device="cuda", generator=gen)
        want = resample_plain(x, rs)
        err = (resample(x, rs).double() - want).abs()
        ratio = float((err / (gamma * resample_plain(x.abs(), rs_abs))
                       .clamp_min(1e-300)).max())
        print(f"[I] {up}/{down} L={taps} N={n}: at most {ratio:.3g} of the "
              "f32 summation bound", flush=True)
        if ratio > 1:
            fails += 1
            print("I FAIL", up, down, taps, n, ratio)
    torch.cuda.synchronize()
    print(f"[I] {count_i} comparisons, min SNR {worst_i:.1f} dB, {fails} "
          "failures", flush=True)

    fj, worst = 0, {"highest": 999.0, "bf16": 999.0, "bf16_vs_f32": 999.0}
    cases = [(g, None, 1.0) for g in CHAIN_CHECK_GEOMETRIES] + [
        ((2, 3, 63, 63, 8), b, 1.0) for b in ((37, -50), (-300, 200),
                                              (2500, -2600))] + [
        (g, None, g[0] / g[1]) for g in CHAIN_CHECK_LOW_RATES]
    for (up, down, rs_taps, ch_taps, channels), bounds, band in cases:
        cfg = ChainConfig(resample_up=up, resample_down=down,
                          resample_taps=rs_taps, channelizer_taps=ch_taps)
        re, im = fm_planes_on_card(channels, 3 * 2304 * down // up + 333, gen,
                                   band=band)
        out_len = -(-re.shape[1] * up // down)
        rs_bounds = (None if bounds is None
                     else (bounds[0], out_len + bounds[1]))
        args = (cfg.resample_filter(), cfg.channelizer_filter(), up, down,
                cfg.demod_k_f)
        chain = FusedChain(*args, precision="highest", device="cuda")
        want = chain_fused_plain(re, im, chain, rs_bounds)
        got = chain_fused(re, im, chain, rs_bounds)
        snr = snr_db(want, got)
        worst["highest"] = min(worst["highest"], snr)
        chain16 = FusedChain(*args, precision="bf16", device="cuda")
        got16 = chain_fused(re.bfloat16(), im.bfloat16(), chain16, rs_bounds)
        own = snr_db(chain_fused_plain(re, im, chain16, rs_bounds), got16)
        vs32 = snr_db(want, got16)
        worst["bf16"] = min(worst["bf16"], own)
        worst["bf16_vs_f32"] = min(worst["bf16_vs_f32"], vs32)
        zero = bool((got[:, 0] == 0).all() and (got16[:, 0] == 0).all())
        # Inside an rs_bounds window's edges both channelized samples of a
        # message can be exactly zero, where bf16's and f32's signed zeros
        # give atan2 different multiples of pi: no bf16-vs-f32 bound there.
        if snr < 95 or own <= 60 or (vs32 <= 40 and bounds is None) \
                or not zero:
            fj += 1
            print("J FAIL", up, down, rs_taps, ch_taps, bounds, snr, own,
                  vs32, zero)
    torch.cuda.synchronize()
    print(f"[J] {len(cases)} geometries x 2 modes, min SNR " + ", ".join(
        f"{k} {v:.1f} dB" for k, v in worst.items()) + f", {fj} failures",
          flush=True)
    return fails + fj


def check_direct(rng) -> int:
    """Kernel B against its plain version on the card (float64 products)
    and the independent int32 path over DIRECT_CHECK_TAPS x widths 1-40,000
    x Q-formats (wrapping ones among them) x chunk lengths 64, 2,048 and
    4,096, inputs at byte offsets; against kernel A at 5 taps and kernel C
    at 258 and 4,096 taps on 19,456 x 8,192 (``torch.equal``); kernel H
    against its float64 plain version (SNR >= 120 dB) over taps 1-257 x
    widths 1-40,001, u8 and f32, rows at every alignment.  Returns the
    failures."""
    import numpy as np
    import torch

    from warmup_fir_filter_tpu_torch.kernels.fir_band import FixedFir1d
    from warmup_fir_filter_tpu_torch.kernels.fir_direct import (
        FixedFirDirect, fir_direct_plain)
    from warmup_fir_filter_tpu_torch.kernels.fir_float import (
        FloatFir1d, fir_float, fir_float_plain)
    from warmup_fir_filter_tpu_torch.kernels.fir_window import FixedFirWindow
    from warmup_fir_filter_tpu_torch.ops.fir1d import fir1d_fixed_rows_torch
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
    from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

    fails = count = 0
    formats = ((16, 12, 32), (16, 12, 20), (8, 7, 16), (32, 12, 28),
               (32, 24, 32))
    for i, taps in enumerate(DIRECT_CHECK_TAPS):
        for j, n in enumerate((1, 17, 511, 513, 4499, 40000)):
            qf = QFormat(*formats[(i + j) % len(formats)])
            span = min(qf.max_coeff_real, 8.0)
            h = np.clip(rng.uniform(-span, span, taps),
                        max(qf.min_coeff_real, -8), span)
            if taps > 64:
                h /= 64
            chunk = (64, 2048, 4096)[(i + 2 * j) % 3]
            fir = FixedFirDirect(h, qf, "cuda", chunk_taps=chunk)
            x = torch.from_numpy(rng.integers(0, 256, size=(3, n),
                                              dtype=np.uint8)).cuda()
            got = fir(x)
            count += 1
            for name, want in (("plain", fir_direct_plain(x, fir)),
                               ("int32", fir1d_fixed_rows_torch(x, h, qf))):
                if not torch.equal(got, want):
                    fails += 1
                    print("B MISMATCH", name, taps, n, qf, chunk,
                          int((got != want).sum()))
    buf = torch.from_numpy(rng.integers(0, 256, size=5 * 1001 + 16,
                                        dtype=np.uint8)).cuda()
    for taps in (5, 300):
        fir = FixedFirDirect(design_lowpass(taps, 0.2), QFormat(), "cuda",
                             chunk_taps=128)
        for off in (1, 2, 3, 7, 15):
            x = buf[off:off + 5 * 1001].view(5, 1001)
            count += 1
            if not torch.equal(fir(x), fir_direct_plain(x, fir)):
                fails += 1
                print("B MISALIGNED MISMATCH", taps, off)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randint(0, 256, (19456, 8192), dtype=torch.uint8,
                      device="cuda", generator=gen)
    qf = QFormat()
    for taps, other in ((5, FixedFir1d), (258, FixedFirWindow),
                        (4096, FixedFirWindow)):
        h = design_lowpass(taps, 0.2)
        count += 1
        if not torch.equal(FixedFirDirect(h, qf, "cuda")(x),
                           other.from_numpy(h, qf, "cuda")(x)):
            fails += 1
            print("B MISMATCH against", other.__name__, taps)
    del x
    torch.cuda.synchronize()
    print(f"[B] {count} comparisons, {fails} mismatches", flush=True)

    fh, worst = 0, 999.0
    for taps in (1, 2, 5, 9, 10, 63, 64, 129, 257):
        fir = FloatFir1d(rng.standard_normal(taps) / np.sqrt(taps), "cuda")
        for n in (1, 17, 2304, 2305, 40001):
            for dtype in (torch.uint8, torch.float32):
                size = 3 * n + 16
                if dtype == torch.uint8:
                    flat = torch.randint(0, 256, (size,), dtype=dtype,
                                         device="cuda", generator=gen)
                else:
                    flat = torch.randn(size, device="cuda", generator=gen)
                for off in (0, 1, 2, 3):
                    x = flat[off:off + 3 * n].view(3, n)
                    snr = snr_db(fir_float_plain(x, fir), fir_float(x, fir))
                    worst = min(worst, snr)
                    if not snr >= 120:
                        fh += 1
                        print("H FAIL", taps, n, dtype, off, snr)
    torch.cuda.synchronize()
    print(f"[H] min SNR {worst:.1f} dB, {fh} failures", flush=True)
    return fails + fh


def check_band(rng) -> int:
    """Kernel A against its plain version: BAND_CHECK_TAPS x formats of one
    to five digit planes x widths around its items, ragged row counts, and
    views at byte offsets 1-15; returns the mismatches."""
    import numpy as np
    import torch

    from warmup_fir_filter_tpu_torch.kernels.fir_band import (
        FixedFir1d, fir_band_plain)
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

    fails = count = 0
    for fmt in ((16, 12, 32), (16, 12, 20), (8, 7, 16), (32, 12, 28),
                (32, 24, 32)):
        qf = QFormat(*fmt)
        for taps in BAND_CHECK_TAPS:
            span = min(qf.max_coeff_real, 8.0)
            h = np.clip(rng.uniform(-span, span, taps),
                        max(qf.min_coeff_real, -8), span)
            fir = FixedFir1d.from_numpy(h, qf, "cuda")
            fir_cpu = FixedFir1d.from_numpy(h, qf)
            for rows, n in ((3, 1), (7, 15), (3, 16), (9, 17), (2, 31),
                            (5, 127), (13, 513), (3, 4499), (2, 8192),
                            (3, 16256), (1, 40000)):
                x = rng.integers(0, 256, size=(rows, n), dtype=np.uint8)
                got = fir(torch.from_numpy(x).cuda()).cpu()
                want = fir_band_plain(torch.from_numpy(x), fir_cpu)
                count += 1
                if not torch.equal(got, want):
                    fails += 1
                    print("A MISMATCH", fmt, taps, rows, n, len(fir.exponents),
                          int((got.int() - want.int()).abs().max()))
            buf = torch.from_numpy(rng.integers(0, 256, size=5 * 333 + 16,
                                                dtype=np.uint8)).cuda()
            for off in range(1, 16):
                xv = buf[off:off + 5 * 333].view(5, 333)
                count += 1
                if not torch.equal(fir(xv).cpu(),
                                   fir_band_plain(xv.cpu(), fir_cpu)):
                    fails += 1
                    print("A MISALIGNED MISMATCH", fmt, taps, off)
    torch.cuda.synchronize()
    print(f"[A] {count} comparisons, {fails} mismatches", flush=True)
    return fails


def check(mode: str | None = None) -> int:
    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    from warmup_fir_filter_tpu_torch import _build
    from warmup_fir_filter_tpu_torch.kernels.fft import (
        FilterSpectrum, _stream_geometry, _u8_stage, fft_rows, fft_rows_plain,
        osfilt, osfilt_plain, osfilt_stream, osfilt_stream_plain)
    from warmup_fir_filter_tpu_torch.kernels.fir_band import (
        FixedFir1d, fir_band_plain)
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
    from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

    sources = {"chain": CHAIN_SOURCES, "direct": DIRECT_SOURCES,
               "band": ("fir_band.cu",)}.get(mode, PTXAS_SOURCES)
    if ptxas("check", sources):
        return 1
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(1)
    if mode == "chain":
        return 1 if check_chain(rng) else 0
    if mode == "direct":
        return 1 if check_direct(rng) + check_window(rng) else 0
    if mode == "band":
        return 1 if check_band(rng) else 0
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
    fails += check_window(rng) + check_frames(rng)

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
                snr = snr_db(want, got)
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

    def u8_ok(got, want64) -> tuple[bool, int, float]:
        diff = (got.int() - _u8_stage(want64.float()).int()).abs()
        share = float((diff != 0).double().mean()) if diff.numel() else 0.0
        top = int(diff.max()) if diff.numel() else 0
        return top <= 1 and share < 1e-3, top, share

    fl, worst_l = 0, 200.0
    for b in range(1, 15):
        nfft = 1 << b
        for taps in (2, 9, 63):
            if taps > nfft:
                continue
            spec = FilterSpectrum(rng.uniform(0.0, 2.0 / taps, taps), nfft,
                                  device="cuda")
            for batch in (7, 1001):
                seg = torch.from_numpy(rng.integers(
                    0, 256, size=(batch, nfft), dtype=np.uint8)).cuda()
                want = osfilt_plain(seg, spec)
                for x in (seg, seg.float()):
                    snr = snr_db(want, osfilt(x, spec, out_u8=False))
                    worst_l = min(worst_l, snr)
                    ok, top, share = u8_ok(osfilt(x, spec, out_u8=True), want)
                    if snr < 120 or not ok:
                        fl += 1
                        print("L FAIL", nfft, taps, batch, x.dtype, snr, top,
                              share)
    torch.cuda.synchronize()
    print(f"[L] min SNR {worst_l:.1f} dB, {fl} failures")

    fm, worst_m = 0, 200.0
    for channels, time_len, taps, off in STREAM_CASES:
        if taps == 1:
            h = np.array([1.0])
        elif taps == 2:
            golden = (np.sqrt(5.0) - 1.0) / 2.0
            h = np.array([golden, 1.0 - golden])
        else:
            h = design_lowpass(taps, 0.2)
        tables = FilterSpectrum(h, 512, d=_stream_geometry(taps, off)[1],
                                device="cuda")
        shape = (channels, time_len + off)
        x = torch.randn(shape, device="cuda", generator=gen)
        snr = snr_db(osfilt_stream_plain(x, tables, off=off, out_len=time_len),
                     osfilt_stream(x, tables, off=off, out_len=time_len,
                                   out_u8=False))
        worst_m = min(worst_m, snr)
        x8 = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                           generator=gen)
        ok, top, share = u8_ok(
            osfilt_stream(x8, tables, off=off, out_len=time_len, out_u8=True),
            osfilt_stream_plain(x8, tables, off=off, out_len=time_len))
        if snr < 120 or not ok:
            fm += 1
            print("M FAIL", channels, time_len, taps, off, snr, top, share)
    torch.cuda.synchronize()
    print(f"[M] min SNR {worst_m:.1f} dB, {fm} failures")
    fails += check_chain(rng)
    return 1 if fails or kf or fl or fm else 0


def check_window(rng) -> int:
    """Kernel C against ``fir_window_plain``: every tap count of the grid at
    every width, the row counts in turn, four Q-formats, a plane with
    exponent 32, the all-zero filter and inputs at byte offsets 1-15.
    Returns the mismatches."""
    import numpy as np
    import torch

    from warmup_fir_filter_tpu_torch.kernels.fir_window import (
        FixedFirWindow, fir_window_plain)
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

    fails = count = 0

    def one(x, fir, fir_cpu, label):
        nonlocal fails, count
        got = fir(x).cpu()
        want = fir_window_plain(x.cpu(), fir_cpu)
        count += 1
        if not torch.equal(got, want):
            fails += 1
            print("C MISMATCH", label, int((got != want).sum()))

    formats = ((16, 12, 32), (16, 12, 20), (8, 7, 16), (32, 12, 28))
    for i, taps in enumerate((1, 5, 33, 257, 258, 1001, 2048, 4096)):
        for j, n in enumerate((1, 17, 511, 512, 513, 4099)):
            rows = (1, 15, 16, 17, 33)[(i + j) % 5]
            qf = QFormat(*formats[(i + j) % 4])
            span = min(qf.max_coeff_real, 8.0)
            h = np.clip(rng.uniform(-span, span, taps),
                        max(qf.min_coeff_real, -8), span)
            fir = FixedFirWindow.from_numpy(h, qf, "cuda")
            x = torch.from_numpy(rng.integers(0, 256, size=(rows, n),
                                              dtype=np.uint8))
            one(x.cuda(), fir, FixedFirWindow.from_numpy(h, qf),
                f"L={taps} {rows}x{n} {qf}")
    qf = QFormat(32, 12, 32)
    h_fixed = np.array([2**31 - 1, -(2**31 - 1), 12345, 2**30 + 7] * 70)
    for fir_cpu in (FixedFirWindow(h_fixed, qf),
                    FixedFirWindow.from_numpy(np.zeros(300))):
        fir = FixedFirWindow(fir_cpu.h_fixed.numpy(), fir_cpu.qformat, "cuda")
        x = torch.from_numpy(rng.integers(0, 256, size=(3, 700),
                                          dtype=np.uint8))
        one(x.cuda(), fir, fir_cpu, f"planes {fir_cpu.exponents}")
    buf = torch.from_numpy(rng.integers(0, 256, size=5 * 1001 + 16,
                                        dtype=np.uint8)).cuda()
    h = rng.uniform(-0.01, 0.01, 1001)
    fir, fir_cpu = (FixedFirWindow.from_numpy(h, QFormat(), dev)
                    for dev in ("cuda", "cpu"))
    for off in (1, 2, 3, 7, 15):
        one(buf[off:off + 5 * 1001].view(5, 1001), fir, fir_cpu,
            f"offset {off}")
    torch.cuda.synchronize()
    print(f"[C] {count} comparisons, {fails} mismatches")
    return fails


def check_frames(rng) -> int:
    """Kernels E, F and G against their plain versions (on the card), whole
    output frames: the bank on images, noise frames and frames at byte
    offsets (staged and written byte by byte); E over Lc 1-257 x Lr 1-33 x
    widths 1-4,099, F over Lc 2-97 x Lr 1-33, each over four formats
    (wrapping ones among them), E also with the all-zero filter and a plane
    at exponent 32; G over Lc 2-97 x Lr 1-17 with taps scaled so that its
    f32 sums stay exact, and the bank.  E and F ``torch.equal``; G too where
    its f32 sums are exact (``bf16_sums_exact``), else within 1.  Returns
    the mismatches."""
    import numpy as np
    import torch

    from warmup_fir_filter_tpu_torch.kernels.fir2d import (
        FixedFir2d, fir2d_bf16, fir2d_bf16_plain, fir2d_frame,
        fir2d_frame_plain, fir2d_oframe, fir2d_oframe_plain, pad_frame,
        pad_frame_overlap)
    from warmup_fir_filter_tpu_torch.ops.fir2d import FILTER_BANK_2D
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

    kernels = {"E": (fir2d_frame, fir2d_frame_plain),
               "F": (fir2d_oframe, fir2d_oframe_plain),
               "G": (fir2d_bf16, fir2d_bf16_plain)}
    fails = dict.fromkeys(kernels, 0)
    count = dict.fromkeys(kernels, 0)

    def shifted(t, offset):
        """A copy of ``t`` at a byte offset from an aligned allocation."""
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
        view = buf[offset:offset + t.numel()].view(t.shape)
        return view.copy_(t)

    def one(kind, fir, h_img, w_img, noise, label, offset=0):
        x = torch.from_numpy(rng.integers(0, 256, size=(h_img, w_img),
                                          dtype=np.uint8)).cuda()
        frame, geo = (pad_frame(x, fir.taps[0], block_rows=16) if kind == "E"
                      else pad_frame_overlap(x, *fir.taps, block_rows=16))
        if noise:
            frame = torch.randint_like(frame, 0, 256)
        if offset:
            frame = shifted(frame, offset)
        kernel, plain = kernels[kind]
        got = kernel(frame, fir, geo[:3], out=shifted(
            torch.full_like(frame, 0xAB), offset))
        want = plain(frame, fir, geo[:3])
        exact = kind != "G" or 255 * float(
            fir.bf16_rows.double().abs().sum()) < 2 ** 24
        diff = int((got.int() - want.int()).abs().max())
        count[kind] += 1
        if diff > (0 if exact else 1):
            fails[kind] += 1
            print(f"{kind} MISMATCH", label, fir.taps, h_img, w_img,
                  fir.qformat, offset, int((got != want).sum()), diff)

    for name, h in FILTER_BANK_2D.items():
        for kind in kernels:
            fir = FixedFir2d.from_numpy(np.asarray(h), QFormat(), "cuda")
            for noise in (False, True):
                one(kind, fir, 70, 700, noise, name)
            for offset in (1, 3, 8):
                one(kind, fir, 70, 700, False, f"{name} offset", offset)
    formats = ((16, 12, 32), (16, 12, 18), (16, 12, 20), (32, 24, 32))
    widths = (1, 127, 128, 700, 4099)
    for i, lc in enumerate((1, 2, 5, 97, 98, 129, 200, 257)):
        for k, lr in enumerate((1, 2, 5, 17, 33)):
            qf = QFormat(*formats[(i + k) % 4])
            fir = FixedFir2d.from_numpy(rng.uniform(-2, 2, (lr, lc)), qf,
                                        "cuda")
            one("E", fir, 37 + lr, widths[(i + k) % 5], False, "grid")
            one("E", fir, 20, 130 + 7 * lc, True, "noise")
    qf = QFormat(32, 12, 32)
    h_fixed = np.array([[2**31 - 1, -(2**31 - 1), 12345, 2**30 + 7] * 33,
                        [5, -3, 0, 7] * 33])
    for fir in (FixedFir2d(h_fixed, qf, "cuda"),
                FixedFir2d.from_numpy(np.zeros((3, 129)), QFormat(), "cuda")):
        one("E", fir, 40, 300, False, f"planes {fir.exponents}")
    for lc in (2, 3, 5, 33, 85, 86, 87, 90, 96, 97):
        for k, lr in enumerate((1, 2, 5, 17, 33)):
            qf = QFormat(*formats[(lc + k) % 4])
            h = rng.uniform(-2, 2, (lr, lc))
            fir = FixedFir2d.from_numpy(h, qf, "cuda")
            one("F", fir, 37 + lr, 130 + 7 * lc, False, "grid")
            one("F", fir, 20, 128 - (lc - 1), True, "three tiles")
            if lr <= 17:
                fir = FixedFir2d.from_numpy(h / (lr * lc), QFormat(), "cuda")
                one("G", fir, 37 + lr, 130 + 7 * lc, False, "grid")
                one("G", fir, 20, 128 - (lc - 1), True, "three tiles")
    torch.cuda.synchronize()
    for kind in kernels:
        print(f"[{kind}] {count[kind]} comparisons, {fails[kind]} mismatches")
    return sum(fails.values())


def time_chain(label: str, report) -> None:
    """Config 5's shapes: kernel I on the stacked 32 x 2,000,000 planes and
    its ``F.conv1d`` yardstick, kernel H on the 32 x 1,333,334 resampled
    planes and on u8 rows of that shape, kernel J on 16 x 2,000,000 I/Q in
    "highest" and "bf16", and ``chain_forward`` "auto" and staged "mxu";
    then the SHA-256 of I's, H's (both sample types) and J's outputs, so
    that two trees' bytes can be compared; then I and J at RATE_TIMINGS,
    with their outputs' SHA-256."""
    import hashlib

    import torch

    from warmup_fir_filter_tpu_torch.kernels.chain_fused import (
        FusedChain, chain_fused)
    from warmup_fir_filter_tpu_torch.kernels.fir_float import (
        FloatFir1d, fir_float)
    from warmup_fir_filter_tpu_torch.kernels.resample import (
        PolyphaseResampler, resample, resample_plain)
    from warmup_fir_filter_tpu_torch.models.chain import (
        ChainConfig, chain_forward)
    from yardsticks import conv1d_resample, conv1d_resampler

    gen = torch.Generator(device="cuda").manual_seed(5)
    cfg = ChainConfig()
    staged = ChainConfig(channelizer_backend="mxu")
    re, im = fm_planes_on_card(16, 2_000_000, gen)
    x = torch.cat([re, im], dim=0)
    h_rs, h_ch = cfg.resample_filter(), cfg.channelizer_filter()
    rs = PolyphaseResampler(h_rs, 2, 3, "cuda")
    both = resample(x, rs)
    fir = FloatFir1d(h_ch, "cuda")
    chain = FusedChain(h_rs, h_ch, 2, 3, cfg.demod_k_f, precision="highest",
                       device="cuda")
    chain16 = FusedChain(h_rs, h_ch, 2, 3, cfg.demod_k_f, precision="bf16",
                         device="cuda")
    re16, im16 = re.bfloat16(), im.bfloat16()
    both_u8 = torch.randint(0, 256, tuple(both.shape), dtype=torch.uint8,
                            device="cuda", generator=gen)
    weight, pad = conv1d_resampler(rs)
    conv_snr = snr_db(resample_plain(x[:2], rs),
                      conv1d_resample(x[:2], weight, pad, rs))
    print(f"[{label}] conv1d resampler vs resample_plain: SNR "
          f"{conv_snr:.1f} dB", flush=True)
    report({
        "I 32x2000000 2/3 63 taps": lambda: resample(x, rs),
        "I conv1d yardstick (pad, F.conv1d, interleave; TF32 off)":
            lambda: conv1d_resample(x, weight, pad, rs),
        "H 32x1333334 63 taps": lambda: fir_float(both, fir),
        "H u8 32x1333334 63 taps": lambda: fir_float(both_u8, fir),
        "J 16x2000000 highest": lambda: chain_fused(re, im, chain),
        "J 16x2000000 bf16": lambda: chain_fused(re16, im16, chain16),
        "chain_forward auto": lambda: chain_forward(re, im, cfg),
        "chain_forward staged mxu": lambda: chain_forward(re, im, staged),
    })
    for name, out in (("I", resample(x, rs)),
                      ("H", fir_float(both, fir)),
                      ("H u8", fir_float(both_u8, fir)),
                      ("J highest", chain_fused(re, im, chain)),
                      ("J bf16", chain_fused(re16, im16, chain16))):
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        print(f"[{label}] sha256 {name}: {digest}", flush=True)
    del both, both_u8
    runs, outs = {}, {}
    for up, down in RATE_TIMINGS:
        cfg_r = ChainConfig(resample_up=up, resample_down=down)
        rs_r = PolyphaseResampler(cfg_r.resample_filter(), up, down, "cuda")
        chain_r = FusedChain(cfg_r.resample_filter(),
                             cfg_r.channelizer_filter(), up, down,
                             cfg.demod_k_f, precision="highest",
                             device="cuda")
        runs[f"I {up}/{down} 32x2000000"] = lambda r=rs_r: resample(x, r)
        runs[f"J {up}/{down} 16x2000000 highest"] = (
            lambda c=chain_r: chain_fused(re, im, c))
        outs[f"I {up}/{down}"] = lambda r=rs_r: resample(x, r)
        outs[f"J {up}/{down}"] = lambda c=chain_r: chain_fused(re, im, c)
    report(runs)
    for name, fn in outs.items():
        digest = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()
        print(f"[{label}] sha256 {name}: {digest}", flush=True)


#: Kernel B's tap counts in ``times ... direct``: the main path's short
#: route, and past kernel C's 4,096 taps, where B is the only route.
DIRECT_TIMING_TAPS = (5, 1001, 4097, 8193)
#: Fixed chunk lengths kernel B is timed at beside its own choice.
DIRECT_CHUNK_VARIANTS = (1024, 2048, 4096)


def time_direct(label: str) -> None:
    """Kernel B (``FixedFirDirect``) at 19,456 x 8,192 u8 with
    ``design_lowpass(L, 0.25)`` quantized Q4.12 (``bench_taps.py``'s
    filter) for DIRECT_TIMING_TAPS, kernel C at 4,096 taps and kernel A at
    5 beside it, each output's SHA-256 (B's against the parent's: the same
    bytes), and B against C and A with ``torch.equal``."""
    import hashlib

    import torch

    from warmup_fir_filter_tpu_torch.kernels.fir_band import FixedFir1d
    from warmup_fir_filter_tpu_torch.kernels.fir_direct import FixedFirDirect
    from warmup_fir_filter_tpu_torch.kernels.fir_window import FixedFirWindow
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
    from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

    qf = QFormat()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randint(0, 256, (19456, 8192), dtype=torch.uint8, device="cuda",
                      generator=gen)
    for taps in DIRECT_TIMING_TAPS:
        h = design_lowpass(taps, 0.25)
        fir = FixedFirDirect(h, qf, "cuda")
        first = fir(x)
        torch.cuda.synchronize()
        one = median_ms(lambda f=fir: f(x), reps=1, calls=1)[0]
        # A few calls where one takes tens of ms or more (the parent).
        reps, calls = (7, 10) if one < 5.0 else (3, 1)
        m, lo, hi = median_ms(lambda f=fir: f(x), reps=reps, calls=calls)
        digest = hashlib.sha256(first.cpu().numpy().tobytes()).hexdigest()
        print(f"[{label}] B {taps} taps 19456x8192: median {m:.4f} ms (min "
              f"{lo:.4f}, max {hi:.4f}; {reps}x{calls} calls) sha256 "
              f"{digest}", flush=True)
        others = {}
        if taps == 5:
            others["A"] = FixedFir1d.from_numpy(h, qf, "cuda")
        if taps == 4097:
            h_c = design_lowpass(4096, 0.25)
            others["C 4096"] = FixedFirWindow.from_numpy(h_c, qf, "cuda")
        for name, other in others.items():
            m, lo, hi = median_ms(lambda f=other: f(x))
            print(f"[{label}] {name} 19456x8192: median {m:.4f} ms (min "
                  f"{lo:.4f}, max {hi:.4f})", flush=True)
        if taps > 4096:
            # Fixed chunk lengths beside pick_chunks' (a tree whose kernel B
            # takes no chunk length skips them).
            for chunk in DIRECT_CHUNK_VARIANTS:
                try:
                    var = FixedFirDirect(h, qf, "cuda", chunk_taps=chunk)
                except TypeError:
                    break
                m, lo, hi = median_ms(lambda f=var: f(x))
                same = torch.equal(var(x), first)
                print(f"[{label}] B {taps} taps chunk {chunk}: median "
                      f"{m:.4f} ms (min {lo:.4f}, max {hi:.4f}), equal "
                      f"{same}", flush=True)
        if taps == 5:
            print(f"[{label}] B == A at 5 taps: "
                  f"{torch.equal(first, others['A'](x))}", flush=True)
        if taps == 4097:
            b_4096 = FixedFirDirect(h_c, qf, "cuda")(x)
            print(f"[{label}] B == C at 4096 taps: "
                  f"{torch.equal(b_4096, others['C 4096'](x))}", flush=True)
            del b_4096
        del first, others


def time_band(label: str) -> None:
    """Kernel A at 19,456 x 8,192 u8 for BAND_TIMING_TAPS and
    BAND_CROSSOVER_TAPS with its outputs' SHA-256, kernel C's entry on the
    same filters from 33 taps, and A's digit-plane route alone at
    BAND_CROSSOVER_TAPS, each held equal to A; the sharpen filters at 3 and
    5 taps, ``design_lowpass(L, 0.2)`` beyond, Q4.12."""
    import ctypes
    import hashlib

    import numpy as np
    import torch

    from warmup_fir_filter_tpu_torch import _build
    from warmup_fir_filter_tpu_torch.kernels.fir_band import FixedFir1d
    from warmup_fir_filter_tpu_torch.kernels.fir_window import FixedFirWindow
    from warmup_fir_filter_tpu_torch.models.filters import FILTER_BANKS
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
    from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

    qf = QFormat()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randint(0, 256, (19456, 8192), dtype=torch.uint8, device="cuda",
                      generator=gen)
    lib = _build.load_library()
    planes_entry = getattr(lib, "wft_fir_band_planes", None)

    def planes_route(fir):
        """The digit-plane route alone, called as ``fir_band`` calls
        ``wft_fir_band``."""
        y = torch.empty_like(x)
        code = planes_entry(
            x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
            fir.digits.data_ptr(), len(fir.exponents), fir.num_taps,
            ctypes.addressof(fir.exponents_c), fir.bias_value & 0xFFFFFFFF,
            int(fir.wrap), qf.frac_bits, qf.acc_bits,
            ctypes.addressof(fir.taps_c), _build.stream_of(x))
        _build.check_launch(lib, code, "wft_fir_band_planes")
        return y

    runs = {}
    taps_list = sorted(set(BAND_TIMING_TAPS) | set(BAND_CROSSOVER_TAPS))
    for taps in taps_list:
        h = (np.asarray(FILTER_BANKS[taps]["sharpen"]) if taps in (3, 5)
             else design_lowpass(taps, 0.2))
        fir = FixedFir1d.from_numpy(h, qf, "cuda")
        got = fir(x)
        if taps in BAND_CROSSOVER_TAPS and planes_entry is not None:
            same = torch.equal(planes_route(fir), got)
            print(f"[{label}] A planes route {taps} taps == A: {same}",
                  flush=True)
            runs[f"A planes route {taps} taps 19456x8192"] = (
                lambda f=fir: planes_route(f))
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        line = f"[{label}] A {taps} taps sha256 {digest}"
        if taps > 32:
            fir_c = FixedFirWindow.from_numpy(h, qf, "cuda")
            line += f", == C {torch.equal(got, fir_c(x))}"
            runs[f"C {taps} taps 19456x8192"] = lambda f=fir_c: f(x)
        print(line, flush=True)
        del got
        runs[f"A {taps} taps 19456x8192"] = lambda f=fir: f(x)
    for kernel in ("A planes", "A", "C"):
        for name, fn in runs.items():
            if name.startswith(kernel) and (
                    kernel != "A" or not name.startswith("A planes")):
                m, lo, hi = median_ms(fn)
                print(f"[{label}] {name}: median {m:.4f} ms (min {lo:.4f}, "
                      f"max {hi:.4f})", flush=True)


def times(tree: str, label: str, mode: str | None = None) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch
    import torch.nn.functional as F

    from warmup_fir_filter_tpu_torch import _build
    from warmup_fir_filter_tpu_torch.kernels.fft import (
        FilterSpectrum, _osfilt_segments, _stream_geometry, fft_rows, osfilt,
        osfilt_stream)
    from warmup_fir_filter_tpu_torch.kernels.fir_band import FixedFir1d
    from warmup_fir_filter_tpu_torch.kernels.fir2d import (
        FixedFir2d, fir2d_bf16, fir2d_frame, fir2d_oframe, pad_frame,
        pad_frame_overlap)
    from warmup_fir_filter_tpu_torch.kernels.fir_window import FixedFirWindow
    from warmup_fir_filter_tpu_torch.models.filters import FILTER_BANKS
    from warmup_fir_filter_tpu_torch.ops.fftfilt import fir_overlap_save
    from warmup_fir_filter_tpu_torch.ops.fir2d import FILTER_BANK_2D
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
    from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[{label}] card {card.strip()}", flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[{label}] build {time.perf_counter() - t0:.2f} s", flush=True)

    def report(runs: dict) -> None:
        for name, fn in runs.items():
            m, lo, hi = median_ms(fn)
            print(f"[{label}] {name}: median {m:.4f} ms (min {lo:.4f}, "
                  f"max {hi:.4f})", flush=True)

    if mode == "direct":
        time_direct(label)
        return
    if mode == "band":
        time_band(label)
        return
    time_chain(label, report)
    if mode == "chain":
        return
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
    report(runs)
    del x, win, dst, runs

    block = torch.randint(0, 256, (16, 4_001_000), dtype=torch.uint8,
                          device="cuda", generator=gen)
    fir_c = FixedFirWindow.from_numpy(design_lowpass(1001, 0.2), qf, "cuda")
    report({"C 1001 taps stream block 16x4001000": lambda: fir_c(block)})
    del block
    x = torch.randint(0, 256, (19456, 8192), dtype=torch.uint8, device="cuda",
                      generator=gen)
    runs = {}
    for taps in (258, 1001, 2048, 4096):
        fir = FixedFirWindow.from_numpy(design_lowpass(taps, 0.2), qf, "cuda")
        runs[f"C {taps} taps 19456x8192"] = (lambda f=fir: f(x))
    report(runs)
    del x, runs

    # bench_2d.py's 8192² frames: kernels E, F and G, and a frame copy.
    image = torch.randint(0, 256, (8192, 8192), dtype=torch.uint8,
                          device="cuda", generator=gen)
    runs = {}
    for name in ("sharpen5", "gauss5"):
        h = np.asarray(FILTER_BANK_2D[name])
        fir2 = FixedFir2d.from_numpy(h, qf, "cuda")
        for kernel in (fir2d_frame, fir2d_oframe, fir2d_bf16):
            frame, geo = (pad_frame(image, 5) if kernel is fir2d_frame
                          else pad_frame_overlap(image, 5, 5))
            out = torch.empty_like(frame)
            runs[f"{kernel.__name__} {name} {tuple(frame.shape)}"] = (
                lambda k=kernel, f=frame, c=geo[:3], o=out, ff=fir2:
                k(f, ff, c, out=o))
    # The filters fir2d_fixed_auto sends to kernel E: 3 x 129 (config 3's
    # check) and 3 x 257, random taps of both signs from seed 3.
    for lc in (129, 257):
        h = np.random.default_rng(3).uniform(-1.0, 1.0, (3, lc)) * 2.0 / \
            np.sqrt(3 * lc)
        fir2 = FixedFir2d.from_numpy(h, qf, "cuda")
        frame, geo = pad_frame(image, 3)
        out = torch.empty_like(frame)
        runs[f"fir2d_frame 3x{lc} {tuple(frame.shape)}"] = (
            lambda f=frame, c=geo[:3], o=out, ff=fir2: fir2d_frame(
                f, ff, c, out=o))
    frame = pad_frame_overlap(image, 5, 5)[0]
    copy_dst = torch.empty_like(frame)
    runs[f"copy {tuple(frame.shape)} u8"] = lambda: copy_dst.copy_(frame)
    report(runs)
    del image, frame, copy_dst, runs

    # BASELINE config 4: 16 x 10,000,000 u8 (as f32 and as u8), 63 taps.
    x8 = torch.randint(0, 256, (16, 10_000_000), dtype=torch.uint8,
                       device="cuda", generator=gen)
    x4 = x8.float()
    h = design_lowpass(63, 0.25)
    tables = FilterSpectrum(h, 512, d=_stream_geometry(63, 0)[1],
                            device="cuda")
    seg, _, _ = _osfilt_segments(x4, 63, 2048)
    spec = FilterSpectrum(h, 2048, device="cuda")
    weight = torch.as_tensor(h[::-1].copy(), dtype=torch.float32,
                             device="cuda").view(1, 1, -1)
    x3 = x4.unsqueeze(1)
    out_len = x4.shape[1]
    report({
        "M config4 f32": lambda: osfilt_stream(x4, tables, off=0,
                                               out_len=out_len, out_u8=False),
        "M config4 u8": lambda: osfilt_stream(x8, tables, off=0,
                                              out_len=out_len, out_u8=True),
        f"L {seg.shape[0]}x2048 segments f32": lambda: osfilt(
            seg, spec, out_u8=False),
        "F.conv1d config4 (TF32 off)": lambda: F.conv1d(x3, weight,
                                                        padding=31),
        "torch.fft overlap-save config4": lambda: fir_overlap_save(x4, h),
    })


def planes(tree: str, label: str) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import ctypes

    import torch

    from warmup_fir_filter_tpu_torch import _build
    from warmup_fir_filter_tpu_torch.kernels.fir_band import FixedFir1d
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
    from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"[{label}] build {time.perf_counter() - t0:.1f} s", flush=True)
    qf = QFormat()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randint(0, 256, (19456, 8192), dtype=torch.uint8, device="cuda",
                      generator=gen)
    y = torch.empty_like(x)

    def call(fir):
        code = lib.wft_fir_band_planes(
            x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
            fir.digits.data_ptr(), len(fir.exponents), fir.num_taps,
            ctypes.addressof(fir.exponents_c), fir.bias_value & 0xFFFFFFFF,
            int(fir.wrap), qf.frac_bits, qf.acc_bits,
            ctypes.addressof(fir.taps_c), _build.stream_of(x))
        _build.check_launch(lib, code, "wft_fir_band_planes")

    line = []
    for taps in PLANES_TAPS:
        fir = FixedFir1d.from_numpy(design_lowpass(taps, 0.2), qf, "cuda")
        line.append(f"{taps}:{median_ms(lambda f=fir: call(f))[0]:.4f}")
    print(f"[{label}] " + " ".join(line), flush=True)


def variant(tree: str, label: str) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    from warmup_fir_filter_tpu_torch import _build
    from warmup_fir_filter_tpu_torch.kernels.fft import (
        FilterSpectrum, _osfilt_segments, _stream_geometry, fft_rows, osfilt,
        osfilt_plain, osfilt_stream, osfilt_stream_plain)
    from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass

    ptxas(label, FFT_SOURCES)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[{label}] build {time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x8 = torch.randint(0, 256, (16, 10_000_000), dtype=torch.uint8,
                       device="cuda", generator=gen)
    x4 = x8.float()
    h = design_lowpass(63, 0.25)
    tables = FilterSpectrum(h, 512, d=_stream_geometry(63, 0)[1],
                            device="cuda")
    seg, _, _ = _osfilt_segments(x4, 63, 2048)
    spec = FilterSpectrum(h, 2048, device="cuda")
    n = x4.shape[1]
    snr_m = snr_db(osfilt_stream_plain(x4, tables, off=0, out_len=n),
                   osfilt_stream(x4, tables, off=0, out_len=n, out_u8=False))
    snr_l = snr_db(osfilt_plain(seg[:20000], spec),
                   osfilt(seg[:20000], spec, out_u8=False))
    print(f"[{label}] SNR M {snr_m:.2f} dB, L {snr_l:.2f} dB", flush=True)
    xr = torch.randn((8192, 2048), device="cuda", generator=gen)
    xi = torch.randn((8192, 2048), device="cuda", generator=gen)
    for name, fn in {
        "M f32": lambda: osfilt_stream(x4, tables, off=0, out_len=n,
                                       out_u8=False),
        "M u8": lambda: osfilt_stream(x8, tables, off=0, out_len=n,
                                      out_u8=True),
        "L 2048": lambda: osfilt(seg, spec, out_u8=False),
        "K 8192x2048": lambda: fft_rows(xr, xi, inverse=False),
    }.items():
        m, lo, hi = median_ms(fn)
        print(f"[{label}] {name}: median {m:.4f} ms (min {lo:.4f}, "
              f"max {hi:.4f})", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] in (["check"], ["check", "chain"], ["check", "direct"],
                        ["check", "band"]):
        sys.exit(check((sys.argv[2:] or [None])[0]))
    if sys.argv[1:2] == ["times"] and (
            len(sys.argv) == 4 or sys.argv[4:] in (["chain"], ["direct"],
                                                   ["band"])):
        times(sys.argv[2], sys.argv[3], (sys.argv[4:] or [None])[0])
        sys.exit(0)
    if sys.argv[1:2] == ["planes"] and len(sys.argv) == 4:
        planes(sys.argv[2], sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["variant"] and len(sys.argv) == 4:
        variant(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(__doc__)
