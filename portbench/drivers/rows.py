"""Driver of the rows traffic: one closed-loop caller filtering a batch of
uint8 rows on the card through the fixed stage's entry.

Each call is ``kernels/dispatch.py::fir1d_fixed_rows_auto(x, h, qformat)``
on the same device-resident ``(rows, width)`` batch, made on the card from
the seed, then a synchronize.  The entry prepares the filter on every call,
as a caller of it pays today.  The outputs of ``checked_calls`` calls drawn
from the seed among the first ``checked_from_first``, and of the last call,
are kept for the check.  The control runs the same calls with the
accumulator narrowed to 16 bits, a path the entry has.
"""

from __future__ import annotations

import numpy as np

from portbench import harness
from portbench.drivers import device_of, memory_peak, sync_of, device_info
from portbench.trace import CALL, Tracer, breakdown


def make_rows(rows: int, width: int, device, seed: int):
    """The ``(rows, width)`` uint8 batch, made on ``device`` from ``seed``
    in one call."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (rows, width), dtype=torch.uint8,
                         device=device, generator=gen)


def run_cell(cell: harness.Cell) -> list[harness.Outcome]:
    return [run_seed(cell, seed) for seed in cell.seeds]


def run_seed(cell: harness.Cell, seed: int) -> harness.Outcome:
    from warmup_fir_filter_tpu_torch.kernels.dispatch import (
        fir1d_fixed_rows_auto,
    )
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

    config, traffic = cell.config, cell.traffic
    device = device_of(cell)
    sync = sync_of(device)
    rows, width = cell.sizes("rows", "width")
    x = make_rows(rows, width, device, seed)
    h = np.asarray(config["taps"], dtype=np.float64)
    qformat = QFormat(config["coeff_bits"], config["frac_bits"],
                      16 if cell.control else config["acc_bits"])
    tracer = Tracer(cell.trace, traffic["traced_calls"],
                    cuda=device.type == "cuda", after_s=cell.seconds / 4)
    rng = np.random.default_rng(seed)
    kept_at = set(rng.choice(traffic["checked_from_first"],
                             traffic["checked_calls"], replace=False).tolist())
    kept = {}

    def call(i: int):
        with tracer.span(CALL):
            y = fir1d_fixed_rows_auto(x, h, qformat)
        sync()
        if i in kept_at:
            kept[i] = y
        return y

    for _ in range(traffic["warmup_calls"]):
        call(-1)
    tracer.warm_up()
    last = {}
    window = harness.closed_loop(lambda i: last.update(y=call(i)),
                                 cell.seconds, tracer, cell.started)
    peak = memory_peak(device)
    kept[window.calls - 1] = last.pop("y")
    run = harness.Run(cell, window, tracer.trace,
                      {"samples_per_call": rows * width})
    metrics = harness.read_metrics(run)
    check = harness.load_module("checks", traffic["check"])
    compared, failed = check.check(
        {"config": config, "x": x, "outputs": kept})
    return harness.Outcome(
        seed=seed, correct=harness.verdict(compared),
        attempted=window.calls, failed=failed, compared=compared,
        metrics=metrics, device=device_info(device, peak, tracer.trace),
        breakdown=breakdown(tracer.trace) if tracer.trace else None)
