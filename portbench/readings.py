"""Readings for the limits of a cell's check: the numbers it compares, over
many seeds in one process (one world for a sharded cell), for the port or
for its control.

Usage, from the root of a checkout on the card(s) the cell needs::

    python3 -m portbench.readings --workload NAME --seconds S --seeds A B ...
    python3 -m portbench.readings --workload NAME --seconds S --seeds A B ... --control

Each seed is a run of the cell at its own size and load with a window of
``S`` seconds; the control puts the configuration's precision a step down
(the fixed cells' accumulator at 16 bits, the float cell's FIR in TF32),
and has to come out not correct.  One JSON line a seed on standard output,
then the largest and smallest reading of each number compared.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--dry-cpu", action="store_true")
    args = parser.parse_args(argv)
    cell = harness.load_cell(args.workload, seeds=args.seeds,
                             seconds=args.seconds, trace=False,
                             dry=args.dry_cpu, control=args.control,
                             started=STARTED)
    driver = harness.load_module("drivers", cell.traffic["driver"])
    readings: dict[str, list] = {}
    for outcome in driver.run_cell(cell):
        values = {n: c["value"] for n, c in outcome.compared.items()}
        for name, value in values.items():
            readings.setdefault(name, []).append(value)
        print(json.dumps({"seed": outcome.seed, "control": args.control,
                          "correct": outcome.correct,
                          "attempted": outcome.attempted,
                          "compared": values}), flush=True)
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "seeds": len(args.seeds),
                      "largest": {n: max(v) for n, v in readings.items()},
                      "smallest": {n: min(v) for n, v in readings.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
