"""Driver of the sharded traffic: the launcher of one rank process a card.

This process touches no card: it builds the port's kernel library (from the
build cache after a checkout's first run), starts the mesh's ranks with
:func:`portbench.common.spawn_world` (NCCL on the cards; gloo on the host
for a dry run) running :mod:`portbench.drivers.sharded_rank`, and joins
their results: rank 0's metrics and window, the largest number compared
over the ranks, the ranks' mean ``busy_s``, and the fullest card's peak.
"""

from __future__ import annotations

import math

from portbench import harness
from portbench.common import spawn_world

#: Seconds the ranks may take beyond the windows.
RANK_TIMEOUT_S = 300


def world_of(config: dict) -> int:
    return math.prod(config["mesh"].values())


def run_cell(cell: harness.Cell) -> list[harness.Outcome]:
    if not cell.dry:
        from warmup_fir_filter_tpu_torch import _build

        _build.build()
    argv = ["--workload", cell.name, "--seconds", str(cell.seconds),
            "--trace", str(int(cell.trace)), "--started", repr(cell.started),
            "--seeds", *map(str, cell.seeds)]
    if cell.dry:
        argv.append("--dry-cpu")
    if cell.control:
        argv.append("--control")
    ranks = spawn_world(cell.rank_module, world_of(cell.config), argv,
                        RANK_TIMEOUT_S + len(cell.seeds) * 2 * cell.seconds)
    outcomes = []
    for per_rank in zip(*ranks):
        lead = per_rank[0]
        compared = {}
        for name in lead["compared"]:
            values = [r["compared"][name]["value"] for r in per_rank]
            compared[name] = {"value": max(values),
                              "limit": lead["compared"][name]["limit"]}
        device = dict(lead["device"])
        device["count"] = len(per_rank)
        device["memory_peak_bytes"] = max(
            r["device"]["memory_peak_bytes"] for r in per_rank)
        if "busy_s" in device:
            device["busy_s"] = sum(r["device"]["busy_s"]
                                   for r in per_rank) / len(per_rank)
        outcomes.append(harness.Outcome(
            seed=lead["seed"], correct=harness.verdict(compared),
            attempted=lead["attempted"],
            failed=max(r["failed"] for r in per_rank), compared=compared,
            metrics=lead["metrics"], device=device,
            breakdown=lead.get("breakdown")))
    return outcomes
