"""One rank of the sharded cell: ``python -m portbench.drivers.sharded_rank``
as :mod:`portbench.drivers.sharded` starts it, with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set.

The rank joins the process group (``initialize_multihost`` on the given
localhost port: NCCL on its card, gloo for a dry run), builds the
configuration's mesh, and for each seed:

1. makes the whole ``(channels, samples)`` array on its device from the
   seed (every rank the same values) and keeps its time block and, for the
   check, that block with its halo columns from the zero-padded stream;
2. builds ``parallel/fft_sharded.py::make_overlap_save_step(h, mesh=...,
   backend=...)`` and warms it up;
3. makes calls between two barriers for ``--seconds`` of rank 0's clock,
   each one the step on the rank's block, then a synchronize; every 32
   calls rank 0 tells the others whether the window has closed (the ranks
   must make the same calls: each call exchanges halos).  The barriers and
   that word go over a gloo group on the host, so the harness runs no
   NCCL kernel on the cards and the traced device time is the step's;
4. checks a call drawn from the seed and the last against the reference,
   and prints its result line for the launcher.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from portbench import harness
from portbench.common import forbidden_loaded, report_rank_result
from portbench.drivers import device_info, memory_peak, sync_of
from portbench.drivers.rows import make_rows
from portbench.trace import CALL, Tracer, breakdown

#: Calls between two of rank 0's answers to "has the window closed?".
AGREE_EVERY = 32


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--started", type=float, required=True)
    parser.add_argument("--dry-cpu", action="store_true")
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from warmup_fir_filter_tpu_torch.parallel.distributed import (
        initialize_multihost,
    )
    from warmup_fir_filter_tpu_torch.parallel.mesh import make_mesh

    cell = harness.load_cell(args.workload, seeds=args.seeds,
                             seconds=args.seconds, trace=bool(args.trace),
                             dry=args.dry_cpu, control=args.control,
                             started=args.started)
    device_type = "cpu" if cell.dry else "cuda"
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    initialize_multihost(
        f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", world,
        rank, device=device_type)
    try:
        mesh = make_mesh(cell.config["mesh"], device_type=device_type)
        control = dist.new_group(backend="gloo")
        for seed in cell.seeds:
            outcome = run_seed(cell, seed, mesh, rank, control)
            found = forbidden_loaded()
            if found:
                print(f"loaded after the window: {', '.join(found)}",
                      file=sys.stderr)
                return 3
            report_rank_result(outcome)
    finally:
        dist.destroy_process_group()
    return 0


def run_seed(cell: harness.Cell, seed: int, mesh, rank: int,
             control) -> dict:
    import torch
    import torch.distributed as dist

    from warmup_fir_filter_tpu_torch.parallel.fft_sharded import (
        make_overlap_save_step,
    )
    from warmup_fir_filter_tpu_torch.parallel.mesh import as_dtensor

    config, traffic = cell.config, cell.traffic
    device = (torch.device("cpu") if cell.dry else
              torch.device("cuda", torch.cuda.current_device()))
    sync = sync_of(device)
    channels, samples = cell.sizes("channels", "samples")
    time_ranks = config["mesh"]["time"]
    local = samples // time_ranks
    index = mesh.get_local_rank("time")
    h = np.asarray(config["taps"], dtype=np.float64)
    center = h.size // 2
    left = h.size - 1 - center

    whole = make_rows(channels, samples, device, seed)
    lo, hi = index * local, (index + 1) * local
    x_ext = torch.nn.functional.pad(whole, (left, center))[
        :, lo : hi + left + center].to(torch.float32)
    block = whole[:, lo:hi].to(torch.float32)
    del whole
    spec = ("data", "time")
    x = as_dtensor(block, mesh, spec)
    evidence = {"config": config, "x_ext": x_ext}
    check = harness.load_module("checks", traffic["check"])
    if cell.control:
        compared = {"rel_err": {"value": check.control(evidence),
                                "limit": check.LIMIT}}
        return {"seed": seed, "correct": harness.verdict(compared),
                "attempted": 0, "failed": 0, "compared": compared,
                "metrics": {}, "device": device_info(device,
                                                     memory_peak(device))}

    step = make_overlap_save_step(h, mesh=mesh, backend=config["backend"])
    rng = np.random.default_rng(seed)
    kept = {}

    def call(i: int):
        with tracer.span(CALL):
            y = step(x)
        sync()
        return y

    tracer = Tracer(cell.trace, traffic["traced_calls"],
                    cuda=device.type == "cuda", after_s=cell.seconds / 4)
    for _ in range(traffic["warmup_calls"]):
        call(-1)
    tracer.warm_up()
    kept_at = int(rng.integers(0, traffic["checked_from_first"]))
    last = {}

    def timed(i: int) -> None:
        y = call(i)
        last["y"] = y
        if i == kept_at:
            kept[i] = y.to_local()

    def agree(done: bool) -> bool:
        """Rank 0's ``done``, on every rank (on the host)."""
        flag = torch.tensor([int(done)])
        dist.broadcast(flag, src=0, group=control)
        return bool(flag.item())

    window = harness.closed_loop(timed, cell.seconds, tracer, cell.started,
                                 barrier=lambda: dist.barrier(group=control),
                                 agree=agree, every=AGREE_EVERY)
    peak = memory_peak(device)
    kept[window.calls - 1] = last.pop("y").to_local()
    del step, x
    run = harness.Run(cell, window, tracer.trace, {
        "samples_per_call": channels * samples,
        "channels": channels, "local_time": local})
    metrics = harness.read_metrics(run) if rank == 0 else {}
    evidence["outputs"] = kept
    compared, failed = check.check(evidence)
    return {"seed": seed, "correct": harness.verdict(compared),
            "attempted": window.calls, "failed": failed, "compared": compared,
            "metrics": metrics,
            "device": device_info(device, peak, tracer.trace),
            "breakdown": breakdown(tracer.trace) if tracer.trace else None}


if __name__ == "__main__":
    raise SystemExit(main())
