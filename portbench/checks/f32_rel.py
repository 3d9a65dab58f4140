"""The sharded float cell's check: each rank's block of a call's output
against the float64 reference over the rank's part of the whole array.

Each rank holds its block with the halo columns the zero-padded global
stream gives it (its neighbours' samples, zeros at the stream's ends), so
together the ranks' checks cover the gathered output, every shard boundary
included.  ``rel_err`` is the largest ``|y - ref|`` over the largest
``|ref|``, over the kept outputs; the launcher takes the largest over the
ranks.  Its limit lies between the program's readings over a dozen seeds
and more and its control's (the same FIR with TF32 operands summed in
float32), as PERF.md sets out."""

import torch

from portbench.reference import fir_f32_rows_f64, fir_rows_tf32

#: The limit of ``rel_err``.
LIMIT = 1e-5


def rel_err(y: torch.Tensor, want: torch.Tensor) -> float:
    scale = float(want.abs().max())
    return float((y.to(torch.float64) - want).abs().max()) / max(scale, 1e-300)


def check(evidence: dict) -> tuple[dict, int]:
    """``({"rel_err": {...}}, failed calls)``."""
    want = fir_f32_rows_f64(evidence["x_ext"], evidence["config"]["taps"])
    errors = [rel_err(y, want) for y in evidence["outputs"].values()]
    worst = max(errors)
    return ({"rel_err": {"value": worst, "limit": LIMIT}},
            sum(1 for e in errors if e > LIMIT))


def control(evidence: dict) -> float:
    """The control's ``rel_err``: the TF32 FIR in the program's place."""
    want = fir_f32_rows_f64(evidence["x_ext"], evidence["config"]["taps"])
    return rel_err(fir_rows_tf32(evidence["x_ext"],
                                 evidence["config"]["taps"]), want)
