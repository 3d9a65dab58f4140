"""What every cell of the benchmark shares: where the checkout is, the card,
the worlds of rank processes, and the check for modules that must not load.

``card``, ``free_port`` and ``spawn_world`` are copies of
``warmup_fir_filter_tpu_torch/benches/_common.py``'s, so that a change to the
port's benches does not move the yardstick.  Nothing here imports the port.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
from contextlib import ExitStack
from pathlib import Path

#: The checkout's root: ``BENCHMARK.json`` and the port's package live here.
ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent
#: A rank process's line that carries its result.
RESULT_PREFIX = "RESULT "
#: Top-level module names that no process of the benchmark may hold: JAX
#: and the JAX package.  Compared whole, so the port
#: (``warmup_fir_filter_tpu_torch``) is not one of them.
FORBIDDEN = ("jax", "jaxlib", "flax", "warmup_fir_filter_tpu")


def loaded_top_level(modules=None) -> set[str]:
    """The top-level names of the loaded modules (the part before the first
    dot, whole)."""
    return {name.split(".", 1)[0] for name in (modules or sys.modules)}


def forbidden_loaded(modules=None, forbidden=FORBIDDEN) -> list[str]:
    """The names of ``forbidden`` that are loaded, compared whole."""
    return sorted(loaded_top_level(modules) & set(forbidden))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def card(index: int) -> dict:
    """The card's name from torch and its name and power limit from
    ``nvidia-smi`` (``benches/_common.py::card``)."""
    import torch

    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = proc.stdout.strip().splitlines()
    return {"kind": torch.cuda.get_device_name(index),
            "card": lines[index] if index < len(lines) else lines[0]}


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_world(module: str, world: int, argv: list[str],
                timeout_s: float) -> list[list[dict]]:
    """Run ``python -m module *argv`` as the ``world`` ranks of one process
    group (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/
    ``LOCAL_RANK`` on a free localhost port; ``OMP_NUM_THREADS`` the host's
    cores over the ranks), wait for all of them and return each rank's
    results, the JSON of its ``RESULT`` lines in order.  Raises if a rank
    fails or outlasts ``timeout_s``; every rank has ended before this
    returns.  A copy of ``benches/_common.py::spawn_world`` that keeps every
    result line and passes each rank's standard error on."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // world)),
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT), os.environ.get("PYTHONPATH"))
                   if p))
    with ExitStack() as files:
        logs = [(files.enter_context(tempfile.TemporaryFile("w+")),
                 files.enter_context(tempfile.TemporaryFile("w+")))
                for _ in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", module, *argv],
            env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)},
            cwd=ROOT, stdout=out, stderr=err, text=True)
            for rank, (out, err) in enumerate(logs)]
        try:
            for proc in procs:
                proc.wait(timeout=timeout_s)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        results = []
        for rank, (proc, (out, err)) in enumerate(zip(procs, logs)):
            out.seek(0)
            err.seek(0)
            lines = [line for line in out.read().splitlines()
                     if line.startswith(RESULT_PREFIX)]
            errors = err.read()
            if rank == 0 and errors:
                sys.stderr.write(errors[-4000:])
            if proc.returncode != 0 or not lines:
                raise RuntimeError(
                    f"rank {rank} of {world} ({module} {' '.join(argv)}) "
                    f"exited {proc.returncode}: {errors[-2000:]}")
            results.append([json.loads(line[len(RESULT_PREFIX):])
                            for line in lines])
    return results


def report_rank_result(result: dict) -> None:
    """A rank process's result, for :func:`spawn_world`."""
    print(RESULT_PREFIX + json.dumps(result), flush=True)
