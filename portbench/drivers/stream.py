"""Driver of the stream traffic: one checkpointed stream of blocks for the
whole window.

One ``Fir1DStream(h, channels, qformat, device)`` runs throughout.  Each
call is ``ops/streaming.py::stream_scanned(stream, block_fn,
blocks_per_call, start_block=b)`` over the next blocks, continuing the
carry and the block index; it returns the checksums, which is its
synchronize.  After every ``save_every``-th call of the window the stream's
state is saved with ``FirStreamState.save`` to one file under ``TMPDIR``,
overwritten each time, inside the call's time.

The block source is ``benches/bench_streaming.py``'s (``stream_source``,
``block_tweak``), its noise table made on the card from the seed: block
``b`` is the table XOR a byte hashed from ``b``.  The control runs the
stream with the accumulator narrowed to 16 bits, a path the stream has.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np

from portbench import harness
from portbench.drivers import device_info, device_of, memory_peak
from portbench.trace import CALL, SOURCE, Tracer, breakdown

MASK32 = 0xFFFFFFFF


def block_tweak(b: int) -> int:
    """Block ``b``'s byte (``benches/bench_streaming.py::block_tweak``)."""
    s = (b * 2654435761) & MASK32
    s = ((s ^ (s >> 13)) * 1274126177) & MASK32
    return (s >> 8) & 255


def stream_source(channels: int, block: int, device, seed: int,
                  span=None):
    """Blocks ``(channels, block)`` uint8 on ``device``: a noise table made
    there from ``seed`` XOR block ``b``'s tweak
    (``benches/bench_streaming.py::stream_source``).  ``span(name)`` wraps
    each block's making (the trace's ``portbench.source``)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randint(0, 256, (channels, block), dtype=torch.uint8,
                          device=device, generator=gen)

    def block_fn(b: int):
        if span is None:
            return noise ^ block_tweak(int(b))
        with span(SOURCE):
            return noise ^ block_tweak(int(b))

    return block_fn


def run_cell(cell: harness.Cell) -> list[harness.Outcome]:
    return [run_seed(cell, seed) for seed in cell.seeds]


def run_seed(cell: harness.Cell, seed: int) -> harness.Outcome:
    from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
    from warmup_fir_filter_tpu_torch.ops.streaming import (
        Fir1DStream,
        FirStreamState,
        stream_scanned,
    )

    config, traffic = cell.config, cell.traffic
    device = device_of(cell)
    channels, width, per_call, save_every = cell.sizes(
        "channels", "block", "blocks_per_call", "save_every")
    tracer = Tracer(cell.trace, traffic["traced_calls"],
                    cuda=device.type == "cuda", after_s=cell.seconds / 4)
    block_fn = stream_source(channels, width, device, seed, tracer.span)
    h = np.asarray(config["taps"], dtype=np.float64)
    qformat = QFormat(config["coeff_bits"], config["frac_bits"],
                      16 if cell.control else config["acc_bits"])
    stream = Fir1DStream(h, channels, qformat, device)
    sums: dict[int, np.ndarray] = {}
    state = {"next": 0, "saved": None}

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "stream_state.npz"

        def call(i: int) -> None:
            start = state["next"]
            with tracer.span(CALL):
                got = stream_scanned(stream, block_fn, per_call,
                                     start_block=start)
            for j in range(per_call):
                sums[start + j] = got[j]
            state["next"] = start + per_call
            if i >= 0 and (i + 1) % save_every == 0:
                stream.state.save(path)
                state["saved"] = state["next"]

        for _ in range(traffic["warmup_calls"]):
            call(-1)
        tracer.warm_up()
        window = harness.closed_loop(call, cell.seconds, tracer, cell.started)
        peak = memory_peak(device)
        final = (stream.state.carry.copy(), stream.state.samples_seen)
        if state["saved"] is None:  # no save inside the window
            stream.state.save(path)
            state["saved"] = state["next"]
        resumed = Fir1DStream(h, channels, qformat, device)
        resumed.state = FirStreamState.load(path)
        resume = {"start": state["saved"],
                  "sums": stream_scanned(resumed, block_fn, per_call,
                                         start_block=state["saved"])}
    del stream, resumed

    first = traffic["warmup_calls"] * per_call
    last = state["next"] - 1
    rng = np.random.default_rng(seed)
    sampled = [first, last, *rng.integers(
        first, last + 1, traffic["checked_blocks"]).tolist()]
    run = harness.Run(cell, window, tracer.trace,
                      {"samples_per_call": per_call * channels * width,
                       "blocks_per_call": per_call})
    metrics = harness.read_metrics(run)
    check = harness.load_module("checks", traffic["check"])
    compared, failed = check.check({
        "config": config, "block_fn": block_fn, "sums": sums,
        "blocks_per_call": per_call, "width": width, "sampled": sampled,
        "final_state": final, "next_block": state["next"],
        "resume": resume})
    return harness.Outcome(
        seed=seed, correct=harness.verdict(compared),
        attempted=window.calls, failed=failed, compared=compared,
        metrics=metrics, device=device_info(device, peak, tracer.trace),
        breakdown=breakdown(tracer.trace) if tracer.trace else None)
