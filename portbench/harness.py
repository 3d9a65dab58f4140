"""The parts of a run that every cell shares: the cell as ``BENCHMARK.json``
and its files describe it, the measured window, the readers of metrics and
the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that ``BENCHMARK.json`` gives:

- ``portbench/configs/<config>.json`` (the entry's ``file``): the sizes
  and taps as they are run;
- ``portbench/traffic/<traffic>.json``: the traffic mix's parameters, with
  the ``driver`` that runs it and the ``check`` that judges it;
- ``portbench/drivers/<driver>.py``: makes the inputs from the seed, sets
  up and warms up the program, runs the window, hands the evidence to the
  check (``run_cell(cell) -> list[Outcome]``);
- ``portbench/checks/<check>.py``: compares the evidence with
  ``portbench/reference.py`` (``check(evidence) -> (compared, failed)``);
- ``portbench/endtoend/<metric>.py`` and ``portbench/metrics/<metric>.py``:
  one reader a metric, ``read(run) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import statistics
import sys
import time
from pathlib import Path
from typing import Callable

from portbench.common import BENCH_DIR, ROOT, load_json
from portbench.trace import Trace, Tracer


@dataclasses.dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` and how this run drives it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    seeds: list[int]
    seconds: float
    trace: bool
    dry: bool = False
    control: bool = False
    #: The wall-clock time (``time.time()``) the process started.
    started: float = 0.0
    #: The module a sharded cell's ranks run (tests put a faulty one here).
    rank_module: str = "portbench.drivers.sharded_rank"

    def sizes(self, *keys: str) -> tuple:
        """The traffic's sizes, or the dry run's where it gives them."""
        dry = self.traffic.get("dry", {}) if self.dry else {}
        return tuple(dry.get(k, self.traffic.get(k, self.config.get(k)))
                     for k in keys)


def load_cell(name: str, *, seeds: list[int], seconds: float, trace: bool,
              dry: bool = False, control: bool = False,
              started: float = 0.0,
              bench_path: Path | None = None) -> Cell:
    """The cell ``name`` from ``BENCHMARK.json`` with its configuration and
    traffic files.  Raises ``KeyError`` for a name it does not hold."""
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in reported]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                seeds=list(seeds), seconds=seconds, trace=trace, dry=dry,
                control=control, started=started)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, loaded by its path: a metric's name
    may hold dots (``dispatch_ms.serve``), which an import by module name
    would read as packages."""
    key = f"portbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Window:
    """What the measured window saw, on this process's host clock."""

    calls: int
    seconds: float
    #: Seconds of each call, from its start until its result was
    #: synchronised; ``traced`` flags the calls inside the traced stretch.
    latencies: list[float]
    traced: list[bool]
    setup_s: float

    def untraced_latencies(self) -> list[float]:
        return [t for t, tr in zip(self.latencies, self.traced) if not tr]


@dataclasses.dataclass
class Run:
    """What a reader gets: the cell, the window, the trace of its stretch
    (``--trace 1``) and the work of one call (``samples_per_call``, and
    ``blocks_per_call`` or a rank's ``channels`` and ``local_time``)."""

    cell: Cell
    window: Window
    trace: Trace | None
    work: dict


def closed_loop(call: Callable[[int], object], seconds: float,
                tracer: Tracer, started: float, *,
                barrier: Callable[[], None] = lambda: None,
                agree: Callable[[bool], bool] = bool,
                every: int = 1) -> Window:
    """One closed-loop caller: the next call starts when the previous one
    has returned, until ``seconds`` have passed (and, in a traced run, the
    traced stretch has its calls).  ``call(i)`` ends with its result
    synchronised.

    The ranks of a world must all make the same calls (each call exchanges
    halos): there the window lies between two ``barrier()`` calls, and
    every ``every`` calls ``agree(done)`` gives every rank rank 0's
    ``done``."""
    latencies, traced = [], []
    barrier()
    t_start = time.perf_counter()
    setup_s = time.time() - started
    i = 0
    while True:
        tracer.before_call(time.perf_counter() - t_start)
        active = tracer.active
        t0 = time.perf_counter()
        call(i)
        t1 = time.perf_counter()
        tracer.after_call()
        latencies.append(t1 - t0)
        traced.append(active)
        i += 1
        if i % every == 0 and agree(t1 - t_start >= seconds
                                    and not tracer.active):
            break
    barrier()
    elapsed = time.perf_counter() - t_start
    tracer.stop()
    return Window(calls=i, seconds=elapsed, latencies=latencies,
                  traced=traced, setup_s=setup_s)


def p95(values: list[float]) -> float | None:
    """The 95th percentile (``statistics.quantiles``, 20 parts), or None
    under 20 values."""
    if len(values) < 20:
        return None
    return statistics.quantiles(values, n=20)[18]


def read_metrics(run: Run) -> dict:
    """The cell's end-to-end metrics (``--trace 0``) or per-layer metrics
    (``--trace 1``), each from its reader; a reader that finds nothing to
    read leaves its metric out."""
    cell = run.cell
    entries, kind = ((cell.per_layer, "metrics") if cell.trace
                     else (cell.end_to_end, "endtoend"))
    out = {}
    for entry in entries:
        value = load_module(kind, entry["name"]).read(run)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


@dataclasses.dataclass
class Outcome:
    """A run's verdict and what it measured, for one seed."""

    seed: int
    correct: bool
    attempted: int
    failed: int
    compared: dict
    metrics: dict
    device: dict
    breakdown: dict | None = None


def verdict(compared: dict) -> bool:
    """True when every number compared is within its limit."""
    return all(c["value"] <= c["limit"] for c in compared.values())


def compared_lines(compared: dict) -> list[str]:
    """Each number compared beside its limit, one a line."""
    return [f"compared {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in compared.items()]


def result_line(outcome: Outcome) -> dict:
    """The result's JSON object, the numbers compared last."""
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": outcome.metrics,
            "device": outcome.device}
    if outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["compared"] = {name: {"value": c["value"], "limit": c["limit"]}
                        for name, c in outcome.compared.items()}
    return line
