"""Run one cell of the port's benchmark once, and print its result line.

Usage, from the root of a checkout::

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

The cell is the entry ``NAME`` of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix, driver, check and metrics are files found by
name (``portbench/harness.py``).  The run makes its inputs on the card from
``--seed``, sets up and warms up the port (``warmup_fir_filter_tpu_torch``)
for the cell's shapes, measures for ``--seconds`` seconds, reads
``memory_peak_bytes``, frees the port's state and checks what the window
produced against the reference.  The last lines of standard error give each
number compared beside its limit; the last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer ones with ``--trace
1``), ``device``, with ``--trace 1`` ``breakdown``, and last ``compared``.

It exits non-zero and prints no result when CUDA is missing or has fewer
cards than the cell asks for, or when JAX or the JAX package
(``warmup_fir_filter_tpu``) is loaded, at set-up or once the window has
closed.  ``--dry-cpu`` runs the cell's control flow on the host at the
traffic's ``dry`` sizes through the port's plain versions: it says so,
measures nothing and prints no device metric.
"""

from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402  (the start time is taken first)
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import common, harness  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), required=True)
    parser.add_argument("--dry-cpu", action="store_true",
                        help="the control flow on the host at tiny sizes; "
                             "no measurement")
    return parser.parse_args(argv)


def fail(message: str, code: int) -> int:
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    return code


def cards_missing(chips: int) -> str | None:
    """Why the cell cannot run here, or None."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, torch.cuda.device_count() "
                f"is {torch.cuda.device_count()}")
    return None


def setup_environment() -> None:
    """Keep libraries that can load JAX by themselves from doing so."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def main(argv=None, started: float = STARTED) -> int:
    args = parse_args(argv)
    setup_environment()
    try:
        cell = harness.load_cell(args.workload, seeds=[args.seed],
                                 seconds=args.seconds,
                                 trace=bool(args.trace), dry=args.dry_cpu,
                                 started=started)
    except (KeyError, FileNotFoundError) as exc:
        return fail(str(exc), 2)
    if cell.dry:
        print("portbench: DRY RUN on the host through the port's plain "
              "versions at tiny sizes: no measurement, no device metric",
              file=sys.stderr, flush=True)
    else:
        missing = cards_missing(cell.chips)
        if missing:
            return fail(missing, 2)
    driver = harness.load_module("drivers", cell.traffic["driver"])
    found = common.forbidden_loaded()
    if found:
        return fail(f"loaded at set-up: {', '.join(found)}", 3)
    import torch

    torch.set_num_threads(min(4, torch.get_num_threads()))
    outcome = driver.run_cell(cell)[0]
    found = common.forbidden_loaded()
    if found:
        return fail(f"loaded once the window had closed: {', '.join(found)}",
                    3)
    if cell.dry:
        outcome.metrics = {}
    line = harness.result_line(outcome)
    for text in harness.compared_lines(outcome.compared):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
