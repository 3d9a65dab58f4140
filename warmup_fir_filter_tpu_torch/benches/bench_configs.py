"""Every BASELINE.json configuration end to end on the card (one JSON line).

Port of ``bench_configs.py``: the five configurations (BASELINE.json:6-12)
at the JAX bench's sizes and seeds, each held to its numeric contract:

1. 3-tap fixed FIR over 64 × 1,024 rows, every 3-tap bank filter bit for
   bit against the golden (kernel A);
2. 5-tap fixed FIR over a 1,000,000-sample stream, SNR > 40 dB against the
   float ideal (kernel A);
3. 5×5 fixed 2-D FIR over 512 × 512: bit-exact, RMSE < 0.5 against the
   float model (``fir2d_fixed_auto``, kernel F);
4. 63-tap FFT overlap-save over 16 × 10,000,000 u8 widened to f32,
   through ``parallel/fft_sharded.py::make_overlap_save_step`` on a mesh
   over this process's world (a world of one when there is none; kernel M
   on the card, ``torch.fft`` on the host), SNR > 70 dB against the float64
   FIR, and its Msamples/s by the slope between one and five applications;
   then the sharded dry run: the same step over a gloo world of 8 CPU ranks
   at 16 × 64,000 (``sharded_dryrun_snr_db``);
5. the chain (2/3 resample, 63-tap channelizer, FM demod) recovering a
   message (correlation > 0.99), then timed at 16 × 2,000,000 complex
   samples with the per-stage split (kernel I, kernel H, the demod) beside
   the fused chain (kernel J) and its bf16 mode.

The chain's roofline takes the H100's 3.35 TB/s and this run's f32
``copy_`` of the chain's input in place of the TPU's measured f32 wall.
``--quick`` shrinks the streams 16×.  A configuration that fails its
contract gives an ``"error"`` and a non-zero exit.

Usage: ``python -m warmup_fir_filter_tpu_torch.benches.bench_configs
[--quick] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.benches import _common
from warmup_fir_filter_tpu_torch.kernels.chain_fused import (
    chain_forward_fused,
)
from warmup_fir_filter_tpu_torch.kernels.dispatch import fir2d_fixed_auto
from warmup_fir_filter_tpu_torch.kernels.fir_band import fir1d_fixed_rows_mxu
from warmup_fir_filter_tpu_torch.kernels.fir_float import fir1d_ideal_rows_mxu
from warmup_fir_filter_tpu_torch.models.chain import ChainConfig, chain_forward
from warmup_fir_filter_tpu_torch.models.filters import (
    FILTER_BANK_3TAP,
    FILTER_BANK_5TAP,
)
from warmup_fir_filter_tpu_torch.models.golden import (
    fir1d_fixed_golden_rows,
    fir1d_ideal_golden_rows,
)
from warmup_fir_filter_tpu_torch.ops.demod import fm_demodulate, fm_modulate
from warmup_fir_filter_tpu_torch.ops.fftfilt import fir_overlap_save, snr_db
from warmup_fir_filter_tpu_torch.ops.fir2d import (
    FILTER_BANK_2D,
    fir2d_fixed_golden,
    fir2d_ideal_golden,
)
from warmup_fir_filter_tpu_torch.ops.resample import (
    design_lowpass,
    resample_poly,
)
from warmup_fir_filter_tpu_torch.parallel import make_mesh
from warmup_fir_filter_tpu_torch.parallel.distributed import (
    initialize_multihost,
)
from warmup_fir_filter_tpu_torch.parallel.fft_sharded import (
    make_overlap_save_step,
)
from warmup_fir_filter_tpu_torch.utils.debugging import nan_guard

METRIC = "baseline_configs_pass"
MODULE = "warmup_fir_filter_tpu_torch.benches.bench_configs"
#: The sharded dry run: ranks, shape and seed (bench_configs.py:95-139).
DRYRUN_RANKS = 8
DRYRUN_SHAPE = (16, 64_000)
DRYRUN_TIMEOUT_S = 600
#: The JAX bench's keys under another name here, and those with no
#: counterpart.
RENAMED: dict[str, str] = {}
DROPPED: dict[str, str] = {}


def _rows(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def config1_bit_compare(results: dict, device: torch.device) -> None:
    """3-tap fixed FIR over 1k-sample vectors, bit-compare vs golden."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, size=(64, 1024), dtype=np.uint8)
    ok = True
    for h in FILTER_BANK_3TAP.values():
        out = fir1d_fixed_rows_mxu(_rows(x, device), np.asarray(h))
        ok &= bool(np.array_equal(out.cpu().numpy(),
                                  fir1d_fixed_golden_rows(x, np.asarray(h))))
    results["config1_3tap_1k_bitexact"] = {"pass": ok}


def config2_stream_snr(results: dict, scale: int,
                       device: torch.device) -> None:
    """5-tap fixed FIR over a 1M-sample stream, SNR vs float ideal."""
    rng = np.random.default_rng(2)
    n = 1_000_000 // scale
    h = np.asarray(FILTER_BANK_5TAP["simple_lp"])
    x = rng.integers(0, 256, size=(1, n), dtype=np.uint8)
    fixed = fir1d_fixed_rows_mxu(_rows(x, device), h).cpu().numpy()
    snr = snr_db(fir1d_ideal_golden_rows(x, h), fixed.astype(np.float64))
    # Q4.12 quantization of a low-pass: error ≪ 1 LSB → very high SNR.
    results["config2_5tap_1M_snr"] = {
        "pass": snr > 40.0, "snr_db": round(snr, 2), "samples": n,
    }


def config3_fir2d(results: dict, device: torch.device) -> None:
    """5x5 fixed 2D FIR on 512x512 tiles, sim-vs-model cross-check."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=(512, 512), dtype=np.uint8)
    h = FILTER_BANK_2D["gauss5"]
    sim = fir2d_fixed_auto(_rows(x, device), h).cpu().numpy()
    bit_ok = bool(np.array_equal(sim, fir2d_fixed_golden(x, h)))
    model = fir2d_ideal_golden(x, h)
    rmse = float(np.sqrt(np.mean((sim.astype(np.float64) - model) ** 2)))
    results["config3_fir2d_512"] = {
        "pass": bit_ok and rmse < 0.5,
        "bit_exact_vs_golden": bit_ok,
        "rmse_vs_model": round(rmse, 4),
    }


def ideal_rows64(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """``fir1d_ideal_golden_rows`` on ``x``'s device: the same-mode FIR
    ``y[n] = Σ_k h[k]·x[n − k + L//2]`` in float64, zero padded, taps in
    the golden's order."""
    taps = h.size
    xp = torch.nn.functional.pad(x.to(torch.float64),
                                 (taps - 1 - taps // 2, taps // 2))
    y = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    for k in range(taps):
        y.add_(xp[:, taps - 1 - k : taps - 1 - k + x.shape[1]],
               alpha=float(h[k]))
    return y


def snr_on_device(reference: torch.Tensor, test: torch.Tensor) -> float:
    """:func:`snr_db` computed where the tensors are, in float64."""
    ref = reference.to(torch.float64)
    err = test.to(torch.float64) - ref
    power, noise = float(ref.square().mean()), float(err.square().mean())
    if noise == 0.0:
        return float("inf")
    return float(10.0 * np.log10(power / noise)) if power > 0 else float(
        "-inf")


def config4_dryrun_rank() -> None:
    """One rank of the sharded dry run: the overlap-save step over a gloo
    mesh {"data": 1, "time": world}, rank 0 reporting its SNR against the
    numpy golden."""
    initialize_multihost(device="cpu")
    try:
        world = torch.distributed.get_world_size()
        mesh = make_mesh({"data": 1, "time": world}, device_type="cpu")
        rng = np.random.default_rng(4)
        x = rng.integers(0, 256, size=DRYRUN_SHAPE, dtype=np.uint8)
        h = design_lowpass(63, 0.25)
        run = make_overlap_save_step(h, mesh=mesh, backend="jnp")
        out = run(torch.from_numpy(x).to(torch.float32)).full_tensor()
        snr = snr_db(fir1d_ideal_golden_rows(x, h),
                     out.numpy().astype(np.float64))
        _common.report_rank_result({"snr_db": round(snr, 2),
                                    "ranks": world})
    finally:
        torch.distributed.destroy_process_group()


def config4_dryrun_snr() -> float:
    """SNR of the sharded overlap-save over a gloo world of
    ``DRYRUN_RANKS`` CPU processes (the JAX bench's 8-device CPU mesh)."""
    results = _common.spawn_world(
        MODULE, DRYRUN_RANKS, ["--config4-dryrun-rank"], DRYRUN_TIMEOUT_S)
    return results[0]["snr_db"]


def config4_fft_sharded(results: dict, scale: int,
                        device: torch.device) -> None:
    """63-tap FFT overlap-save, 16ch x 10M, sharded with halo exchange
    over this process's world; SNR against the float64 FIR and, at full
    size on the card, Msamples/s by the one-to-five-applications slope."""
    with _common.world_of_one(device) as n_dev:
        mesh = make_mesh({"data": 1, "time": n_dev}, device_type=device.type)
        rng = np.random.default_rng(4)
        time_len = (10_000_000 // scale // n_dev) * n_dev
        if scale > 1:  # --quick: the smoke shape
            time_len = (10_000_000 // scale // 64 // n_dev) * n_dev
        x = rng.integers(0, 256, size=(16, time_len), dtype=np.uint8)
        h = design_lowpass(63, 0.25)
        backend = "pallas" if device.type == "cuda" else "jnp"
        x_dev = _rows(x, device).to(torch.float32)
        run1 = make_overlap_save_step(h, mesh=mesh, backend=backend)
        out = run1(x_dev).to_local()
        if not bool(torch.isfinite(out).all()):
            raise FloatingPointError("config 4: non-finite output from the "
                                     "FFT path")
        snr = snr_on_device(ideal_rows64(_rows(x, device), h), out)
        del out
        entry = {"pass": snr > 70.0, "snr_db": round(snr, 2),
                 "devices": n_dev, "backend": backend,
                 "shape": list(x.shape)}
        if device.type == "cuda" and scale == 1:
            run5 = make_overlap_save_step(h, mesh=mesh, backend=backend,
                                          steps=5)
            run5(x_dev)
            times = {}
            for k, run in ((1, run1), (5, run5)):
                best = float("inf")
                for seed in range(3):
                    _common.sync(device)
                    t0 = time.perf_counter()
                    run(x_dev, float(seed + 1))
                    _common.sync(device)
                    best = min(best, time.perf_counter() - t0)
                times[k] = best
            per_apply = _common.slope_seconds((times[5] - times[1]) / 4,
                                              device, 1e-9)
            entry["msps"] = round(x.size / per_apply / 1e6, 1)
    if n_dev == 1:
        entry["sharded_dryrun_snr_db"] = config4_dryrun_snr()
        entry["sharded_dryrun_ranks"] = DRYRUN_RANKS
        entry["pass"] = entry["pass"] and entry["sharded_dryrun_snr_db"] > 70
    results["config4_fft63_sharded"] = entry


def config5_full_chain(results: dict, scale: int,
                       device: torch.device) -> None:
    """Polyphase 2/3 resample + 63-tap channelizer + FM demod chain:
    message recovery on two channels, then the chain's throughput at 16
    channels × 2M complex samples with the per-stage split."""
    cfg = ChainConfig()
    t = np.arange(max(200_000 // scale, 20_000))
    message = np.stack([
        0.4 * np.cos(2 * np.pi * 0.001 * t),
        0.3 * np.sin(2 * np.pi * 0.0015 * t),
    ])
    re, im = fm_modulate(message, cfg.demod_k_f)
    # nan_guard: the demod is the one float path with divisions and
    # arctangents; fail at the producing op, not in the final corr.
    with nan_guard():
        out = chain_forward(_rows(re.astype(np.float32), device),
                            _rows(im.astype(np.float32), device), cfg)
    out = out.cpu().numpy().astype(np.float64)
    t_out = np.arange(out.shape[1]) * 1.5
    expected = 0.4 * np.cos(2 * np.pi * 0.001 * t_out)
    core = slice(300, -300)
    corr = float(np.corrcoef(out[0, core], expected[core])[0, 1])
    entry = {
        "pass": corr > 0.99, "message_corr": round(corr, 5),
        "out_shape": list(out.shape),
    }
    entry.update(_chain_throughput(cfg, scale, device))
    results["config5_full_chain"] = entry


def _slope_seconds(fn, args: tuple, device: torch.device,
                   k_pair=(2, 10), repeats: int = 3) -> float:
    """Per-call seconds of ``fn(*args)`` by the slope between two counts
    of back-to-back calls (CUDA events on the card); one that is not
    positive raises on the card and reads 1 µs on the CPU."""
    def chain(k: int) -> float:
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(k):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(k):
            fn(*args)
        return time.perf_counter() - t0

    fn(*args)  # warm
    _common.sync(device)
    times = {k: min(chain(k) for _ in range(repeats)) for k in k_pair}
    return _common.slope_seconds((times[k_pair[1]] - times[k_pair[0]])
                                 / (k_pair[1] - k_pair[0]), device, 1e-6)


def _chain_throughput(cfg: ChainConfig, scale: int,
                      device: torch.device) -> dict:
    """The chain and each stage in Msamples/s at a row-rich shape (16 ×
    2M on the card); the stages on their own inputs attribute the staged
    chain's time, the fused kernel J is what ``chain_forward`` runs."""
    on_card = device.type == "cuda"
    if not on_card and scale == 1:
        return {}  # full-size float chain on the host: minutes, no insight
    channels = 16
    time_len = 2_000_000 if on_card else 2_000_000 // max(scale * 8, 8)
    rng = np.random.default_rng(5)
    re = rng.standard_normal((channels, time_len)).astype(np.float32)
    im = rng.standard_normal((channels, time_len)).astype(np.float32)
    re_d, im_d = _rows(re, device), _rows(im, device)
    h_rs = cfg.resample_filter()
    h_ch = cfg.channelizer_filter()
    up, down = cfg.resample_up, cfg.resample_down

    both = torch.cat([re_d, im_d], dim=0)
    t_chain = _slope_seconds(lambda r, i: chain_forward(r, i, cfg),
                             (re_d, im_d), device)
    t_rs = _slope_seconds(lambda b: resample_poly(b, h_rs, up, down),
                          (both,), device)
    both_rs = resample_poly(both, h_rs, up, down)
    t_ch = _slope_seconds(lambda b: fir1d_ideal_rows_mxu(b, h_ch),
                          (both_rs,), device, k_pair=(4, 24))
    re_ch, im_ch = both_rs[:channels], both_rs[channels:]
    t_dm = _slope_seconds(lambda r, i: fm_demodulate(r, i, cfg.demod_k_f),
                          (re_ch, im_ch), device, k_pair=(8, 48))

    n_in = re.size  # complex input samples
    n_rs = int(both_rs.shape[1]) * channels
    stages = {
        "resample": {"seconds": t_rs, "msps": n_in / t_rs / 1e6},
        "channelize": {"seconds": t_ch, "msps": n_rs / t_ch / 1e6},
        "demod": {"seconds": t_dm, "msps": n_rs / t_dm / 1e6},
    }
    bottleneck = max(stages, key=lambda s: stages[s]["seconds"])
    # The fused chain's traffic is the input planes and the message rows;
    # the staged chain writes and reads every intermediate.
    fused_bytes = (2 * n_in + n_rs) * 4
    staged_bytes = (
        (2 * n_in + 2 * n_rs) * 4          # resample: 2 planes in/out
        + (2 * n_rs + 2 * n_rs) * 4        # channelizer: 2 planes in/out
        + (2 * n_rs + n_rs) * 4            # demod: 2 planes in, 1 out
    )
    sol_s = fused_bytes / _common.PEAK_BYTES_PER_S
    out = {
        "chain_msps": round(n_in / t_chain / 1e6, 1),
        "chain_backend": device.type,
        "chain_kernel": "fused" if on_card else "staged",
        "chain_shape": [channels, time_len],
        "stages_msps": {k: round(v["msps"], 1) for k, v in stages.items()},
        "stages_seconds": {
            k: round(v["seconds"], 5) for k, v in stages.items()},
        "bottleneck_stage": bottleneck,
        "chain_sol_fraction": round(sol_s / t_chain, 3),
        "staged_over_fused_bytes": round(staged_bytes / fused_bytes, 2),
        "stage_sum_seconds": round(t_rs + t_ch + t_dm, 5),
        "chain_seconds": round(t_chain, 5),
    }
    if on_card:
        # The card's f32 streaming wall: a copy_ of the stacked input
        # planes, read once and written once, in this run.
        dst = torch.empty_like(both)
        t_copy = _slope_seconds(lambda: dst.copy_(both), (), device)
        copy_bytes_per_s = 2 * both.numel() * 4 / t_copy
        out["f32_copy_gbps"] = round(copy_bytes_per_s / 1e9, 1)
        out["chain_f32_wall_fraction"] = round(
            fused_bytes / copy_bytes_per_s / t_chain, 3)
        del dst
        # The opt-in bf16 storage mode, with its SNR against the f32 chain
        # on a constant-envelope FM signal.
        re_b, im_b = re_d.to(torch.bfloat16), im_d.to(torch.bfloat16)
        t_b16 = _slope_seconds(
            lambda r, i: chain_forward_fused(
                r, i, h_rs, h_ch, up, down, cfg.demod_k_f,
                precision="bf16"), (re_b, im_b), device)
        msg = fir_overlap_save(
            _rows(rng.standard_normal((8, 100_000)).astype(np.float32),
                  device), design_lowpass(63, 0.05)).cpu().numpy()
        msg = msg / np.abs(msg).max()
        re_fm, im_fm = fm_modulate(msg, cfg.demod_k_f)
        planes = (_rows(re_fm.astype(np.float32), device),
                  _rows(im_fm.astype(np.float32), device))
        ref_fm = chain_forward(*planes, cfg).cpu().numpy().astype(np.float64)
        got_fm = chain_forward_fused(
            *planes, h_rs, h_ch, up, down, cfg.demod_k_f,
            precision="bf16").cpu().numpy().astype(np.float64)
        out["chain_bf16_mode"] = {
            "msps": round(n_in / t_b16 / 1e6, 1),
            "snr_vs_f32_chain_db": round(float(snr_db(ref_fm, got_fm)), 1),
            "note": "opt-in precision='bf16' storage mode",
        }
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--config4-dryrun-rank", action="store_true",
                        help="run as one rank of the sharded dry run")
    args = parser.parse_args(argv)
    if args.config4_dryrun_rank:
        config4_dryrun_rank()
        return 0
    scale = 16 if args.quick else 1
    unit = "of 5 configs"

    def body() -> dict:
        start = time.perf_counter()
        device = _build.resolve_device(args.device)
        results: dict = {}
        config1_bit_compare(results, device)
        config2_stream_snr(results, scale, device)
        config3_fir2d(results, device)
        config4_fft_sharded(results, scale, device)
        config5_full_chain(results, scale, device)
        passed = sum(int(e["pass"]) for e in results.values())
        all_pass = passed == len(results)
        payload = {
            "metric": METRIC,
            "value": passed,
            "unit": f"of {len(results)} configs",
            "vs_baseline": 1.0 if all_pass else 0.0,
            **_common.card(device),
            "elapsed_s": round(time.perf_counter() - start, 1),
            "configs": results,
        }
        if not all_pass:
            payload["error"] = "failed configs: " + ", ".join(
                name for name, e in results.items() if not e["pass"])
        return payload

    return _common.run(METRIC, unit, body)


if __name__ == "__main__":
    raise SystemExit(main())
