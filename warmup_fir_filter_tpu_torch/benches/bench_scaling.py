"""Multi-device scaling of the sharded fixed-point FIR (one JSON line).

Port of ``bench_scaling.py``.  One process a rank, over gloo on the host
(``--backend gloo``) or NCCL with a card a rank (``--backend nccl``); a
world of one runs in this process, a larger one as rank processes of this
module (``_common.spawn_world``).  The JAX bench's ``--platform cpu|tpu``
is ``--backend gloo|nccl`` here.

- ``--mode overhead`` (default): the same workload (5-tap sharpen, 8
  channels × 16,384 samples a rank, times the ranks each way) through
  ``fir1d_fixed_sharded`` sharded along time (halo exchange) and along
  channels (no collectives), interleaved, best of 7: efficiency ≈
  1 / (1 + overhead).
- ``--mode weak``: constant work a rank, one world for each m = 1, 2, 4, …
  up to ``--devices`` (a mesh's axes must multiply to its world size):
  efficiency = rate(n) / (n · rate(1)).
- In both, each sharding's output, gathered once outside the timed runs,
  must equal ``fir1d_fixed_rows_auto`` on the whole input
  (``bit_exact_vs_unsharded``).
- ``--mode pp``: pipeline overlap of stages that only wait STAGE_DELAY_S,
  against the ideal ``T·S / (T + S − 1)``: ``PipelinedChain`` in this
  process and the SPMD pipeline (``make_spmd_pipeline``) over a world of S
  ranks.  On the card a stage's wait is a spin on its stream
  (``torch.cuda._sleep``), ordered after its input as the device orders
  work; on the host a sleep (``PipelinedChain`` then runs its stages in
  order).

Usage: ``python -m warmup_fir_filter_tpu_torch.benches.bench_scaling
[--mode overhead|weak|pp] [--backend gloo|nccl] [--devices N]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.benches import _common
from warmup_fir_filter_tpu_torch.kernels.dispatch import fir1d_fixed_rows_auto
from warmup_fir_filter_tpu_torch.models.filters import FILTER_BANK_5TAP
from warmup_fir_filter_tpu_torch.parallel import (
    PipelinedChain,
    fir1d_fixed_sharded,
    make_mesh,
)
from warmup_fir_filter_tpu_torch.parallel.distributed import (
    initialize_multihost,
)
from warmup_fir_filter_tpu_torch.parallel.mesh import mesh_device
from warmup_fir_filter_tpu_torch.parallel.spmd_pipeline import (
    make_spmd_pipeline,
)

MODULE = "warmup_fir_filter_tpu_torch.benches.bench_scaling"
SEED = 7
MICROBATCHES = 8
MAX_STAGES = 4
STAGE_DELAY_S = 0.05
WORLD_TIMEOUT_S = 900
#: The backends and the device type of their ranks.
DEVICE_TYPE = {"gloo": "cpu", "nccl": "cuda"}
#: The JAX bench's keys under another name here, and those with no
#: counterpart.
RENAMED = {"platform": "backend"}
DROPPED: dict[str, str] = {}


def _sync(out) -> None:
    """Wait for this rank's block of ``out`` (a DTensor) to be computed."""
    local = out.to_local() if hasattr(out, "to_local") else out
    if local.device.type == "cuda":
        torch.cuda.synchronize(local.device)


def _world_time(fn) -> float:
    """Seconds of ``fn()`` across the world: from a barrier before it to
    a barrier after every rank has its block."""
    dist.barrier()
    t0 = time.perf_counter()
    _sync(fn())
    dist.barrier()
    return time.perf_counter() - t0


def _best_time(fn, repeats: int) -> float:
    return min(_world_time(fn) for _ in range(repeats))


def check_unsharded(out, x: np.ndarray, h: np.ndarray, label: str) -> None:
    """Raise on every rank unless ``out`` (a DTensor), gathered, equals
    ``fir1d_fixed_rows_auto`` on the whole of ``x``."""
    full = out.full_tensor()
    want = fir1d_fixed_rows_auto(torch.from_numpy(x).to(full.device), h)
    if not torch.equal(full, want):
        raise AssertionError(f"{label}: the sharded output is not equal to "
                             "the unsharded fir1d_fixed_rows_auto")


def task_overhead(args) -> dict:
    n = dist.get_world_size()
    device_type = DEVICE_TYPE[args.backend]
    h = np.asarray(FILTER_BANK_5TAP["sharpen"])
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 256, size=(args.channels * n, args.time * n),
                     dtype=np.uint8)
    mesh_time = make_mesh({"data": 1, "time": n}, device_type=device_type)
    mesh_data = make_mesh({"data": n, "time": 1}, device_type=device_type)

    def run_time():
        return fir1d_fixed_sharded(x, h, mesh=mesh_time)

    def run_data():
        return fir1d_fixed_sharded(x, h, mesh=mesh_data)

    check_unsharded(run_time(), x, h, "time-sharded")
    check_unsharded(run_data(), x, h, "channel-sharded")
    # Interleaved, so that load on a shared host hits both alike.
    t_halo = t_plain = float("inf")
    for _ in range(args.repeats):
        t_halo = min(t_halo, _world_time(run_time))
        t_plain = min(t_plain, _world_time(run_data))
    return {"time_sharded_s": t_halo, "channel_sharded_s": t_plain,
            "samples": int(x.size)}


def weak_input(channels: int, time_len: int, m: int) -> np.ndarray:
    """The input of the world of ``m``: the JAX bench draws one for each
    m = 1, 2, 4, … from one generator, so the draws are replayed up to
    this world's."""
    rng = np.random.default_rng(SEED)
    size = 1
    while True:
        x = rng.integers(0, 256, size=(channels, time_len * size),
                         dtype=np.uint8)
        if size >= m:
            return x
        size *= 2


def task_weak(args) -> dict:
    m = dist.get_world_size()
    h = np.asarray(FILTER_BANK_5TAP["sharpen"])
    x = weak_input(args.channels, args.time, m)
    mesh = make_mesh({"data": 1, "time": m},
                     device_type=DEVICE_TYPE[args.backend])

    def run():
        return fir1d_fixed_sharded(x, h, mesh=mesh)

    check_unsharded(run(), x, h, f"world of {m}")
    best = _best_time(run, args.repeats)
    return {"msps": x.size / best / 1e6, "seconds": best,
            "samples": int(x.size)}


def make_wait(delay: float, device: torch.device):
    """A stage's wait of ``delay`` seconds, ordered as the stage's work is:
    on the card a spin of ``torch.cuda._sleep`` on the current stream,
    calibrated against CUDA events (NCCL's ``wait`` and a stream's event
    order the device, not the host, so a host sleep would overlap stages
    whose inputs have not arrived); on the host a sleep."""
    if device.type != "cuda":
        return lambda: time.sleep(delay)
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
    cycles = int(delay * 10_000_000 / (start.elapsed_time(end) / 1e3))
    return lambda: torch.cuda._sleep(cycles)


def task_spmd_pp(args) -> dict:
    """The GPipe schedule over the world's ranks, a stage a rank, each
    stage waiting STAGE_DELAY_S (:func:`make_wait`): pipelined against
    the same stages applied in order on rank 0 alone."""
    num_stages = dist.get_world_size()
    device_type = DEVICE_TYPE[args.backend]
    mesh = make_mesh({"stage": num_stages}, device_type=device_type)
    device = mesh_device(mesh)
    wait = make_wait(STAGE_DELAY_S, device)

    def stage_fn(s: int, x: torch.Tensor) -> torch.Tensor:
        wait()
        return x + float(s)

    batches = torch.arange(MICROBATCHES * 4 * 8, dtype=torch.float32,
                           device=device).reshape(MICROBATCHES, 4, 8)
    run = make_spmd_pipeline(stage_fn, mesh=mesh)

    def sequential():
        out = batches.clone()
        if dist.get_rank() == 0:
            for m in range(MICROBATCHES):
                for s in range(num_stages):
                    out[m] = stage_fn(s, out[m])
        return out

    out = run(batches).to_local()
    expected = batches + sum(range(num_stages))
    if not torch.allclose(out, expected):
        raise AssertionError("spmd_pipeline output mismatch")
    pp_s = _best_time(lambda: run(batches), 3)
    seq_s = _best_time(sequential, 3)
    speedup = seq_s / pp_s
    theoretical = (MICROBATCHES * num_stages) / (
        MICROBATCHES + num_stages - 1)
    return {
        "speedup": round(speedup, 3),
        "theoretical": round(theoretical, 3),
        "fraction_of_theoretical": round(speedup / theoretical, 3),
        "sequential_s": seq_s,
        "pipelined_s": pp_s,
        "stages": num_stages,
        "microbatches": MICROBATCHES,
        "stage_delay_s": STAGE_DELAY_S,
    }


TASKS = {"overhead": task_overhead, "weak": task_weak,
         "spmd_pp": task_spmd_pp}


def rank_argv(args, task: str) -> list[str]:
    return ["--backend", args.backend, "--channels", str(args.channels),
            "--time", str(args.time), "--repeats", str(args.repeats),
            "--rank-task", task]


def run_world(args, world: int, task: str) -> dict:
    """Rank 0's result of ``task`` over a world of ``world`` ranks."""
    if world == 1:
        device = torch.device(DEVICE_TYPE[args.backend])
        with _common.world_of_one(device):
            return TASKS[task](args)
    return _common.spawn_world(MODULE, world, rank_argv(args, task),
                               WORLD_TIMEOUT_S)[0]


def pipelined_chain(args, num_stages: int) -> dict:
    """``PipelinedChain`` over ``num_stages`` waiting stages in this
    process: pipelined against ``force_sequential``."""
    if args.backend == "nccl":
        devices = [torch.device("cuda", i % torch.cuda.device_count())
                   for i in range(num_stages)]
    else:
        devices = [torch.device("cpu")] * num_stages

    def make_stage(tag: float, device: torch.device):
        wait = make_wait(STAGE_DELAY_S, device)

        def stage(x: torch.Tensor) -> torch.Tensor:
            wait()
            return x + tag

        return stage

    chain = PipelinedChain([make_stage(float(i), device)
                            for i, device in enumerate(devices)],
                           devices=devices)
    batches = [np.full((4, 8), float(m), np.float32)
               for m in range(MICROBATCHES)]
    chain.run_microbatches(batches[:1])  # warm
    chain.run_microbatches(batches[:1], force_sequential=True)
    t0 = time.perf_counter()
    seq = chain.run_microbatches(batches, force_sequential=True)
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = chain.run_microbatches(batches)
    pp_s = time.perf_counter() - t0
    want = [b + sum(range(num_stages)) for b in batches]
    if not all(np.array_equal(o.numpy(), w) and np.array_equal(s.numpy(), w)
               for o, s, w in zip(out, seq, want)):
        raise AssertionError("PipelinedChain output mismatch")
    return {"sequential_s": seq_s, "pipelined_s": pp_s,
            "devices": [str(d) for d in chain.placements]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backend", default="gloo",
                        choices=tuple(DEVICE_TYPE))
    parser.add_argument("--mode", default="overhead",
                        choices=("overhead", "weak", "pp"))
    parser.add_argument("--devices", type=int, default=8)
    parser.add_argument("--channels", type=int, default=8)
    parser.add_argument("--time", type=int, default=1 << 14)
    parser.add_argument("--repeats", type=int, default=7)
    parser.add_argument("--rank-task", choices=tuple(TASKS), default=None,
                        help="run as one rank of a world (set by the "
                             "launcher)")
    args = parser.parse_args(argv)
    if args.rank_task:
        initialize_multihost(device=DEVICE_TYPE[args.backend])
        try:
            result = TASKS[args.rank_task](args)
        finally:
            dist.destroy_process_group()
        _common.report_rank_result(result)
        return 0
    metric, unit = {
        "overhead": ("halo_sharding_efficiency",
                     "fraction (comm-overhead proxy)"),
        "weak": ("scaling_efficiency_weak", "fraction"),
        "pp": ("pipeline_parallel_overlap", "x speedup")}[args.mode]

    def body() -> dict:
        device = _build.resolve_device(DEVICE_TYPE[args.backend])
        n = args.devices
        if device.type == "cuda":
            n = min(n, torch.cuda.device_count())
        common = {"backend": args.backend,
                  **_common.card(torch.device(device.type, 0)
                                 if device.type == "cuda" else device)}
        if args.mode == "pp":
            num_stages = min(MAX_STAGES, n)
            chain = pipelined_chain(args, num_stages)
            speedup = chain["sequential_s"] / chain["pipelined_s"]
            theoretical = (MICROBATCHES * num_stages) / (
                MICROBATCHES + num_stages - 1)
            return {
                "metric": metric,
                "value": round(speedup, 3),
                "unit": f"x speedup, {num_stages} stages x {MICROBATCHES} "
                        f"microbatches (theoretical {theoretical:.2f}x)",
                "vs_baseline": round(speedup / theoretical, 3),
                **common,
                **chain,
                "stage_delay_s": STAGE_DELAY_S,
                "spmd_pipeline": run_world(args, num_stages, "spmd_pp"),
            }
        if args.mode == "overhead":
            r = run_world(args, n, "overhead")
            overhead = max(0.0, r["time_sharded_s"] / r["channel_sharded_s"]
                           - 1.0)
            efficiency = 1.0 / (1.0 + overhead)
            return {
                "metric": metric,
                "value": round(efficiency, 3),
                "unit": f"fraction at {n} devices (comm-overhead proxy)",
                "vs_baseline": round(efficiency / 0.9, 3),
                **common,
                "time_sharded_s": r["time_sharded_s"],
                "channel_sharded_s": r["channel_sharded_s"],
                "bit_exact_vs_unsharded": True,
                "workload": (f"5-tap fixed FIR, {args.channels * n}ch x "
                             f"{args.time * n} samples, {n}-device mesh"),
            }
        results = {}
        m = 1
        while m <= n:
            results[m] = run_world(args, m, "weak")["msps"]
            m *= 2
        max_n = max(results)
        efficiency = results[max_n] / (results[1] * max_n)
        return {
            "metric": metric,
            "value": round(efficiency, 3),
            "unit": f"fraction at {max_n} devices",
            "vs_baseline": round(efficiency / 0.9, 3),
            **common,
            "msps_per_n": {str(k): round(v, 3) for k, v in results.items()},
            "bit_exact_vs_unsharded": True,
            "workload": (f"5-tap fixed FIR, {args.channels}ch x "
                         f"{args.time}/device"),
        }

    return _common.run(metric, unit, body)


if __name__ == "__main__":
    raise SystemExit(main())
