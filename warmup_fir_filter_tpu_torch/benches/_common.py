"""What the port's benches share: the card line, the one JSON line, the
speed of light, the timing and the worlds of rank processes.

Each bench is a ``main(argv=None) -> int`` that prints one JSON line on
stdout through :func:`run`: its payload, or ``{"metric", "value": 0.0,
"unit", "error"}`` when anything raised, and exits non-zero on an error or
a failed gate.  Nothing falls back: a missing card, a failed build, a
failed launch or an output that disagrees with the golden ends the run.

``--device cpu`` runs the kernels' plain versions on the host, for the
tests: its times are the host's and never a device metric, and the timing
chains are cut to a few applications (:data:`CPU_CHAINS`).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import traceback
from contextlib import ExitStack, contextmanager
from pathlib import Path
from typing import Callable, Iterator

import torch
import torch.distributed as dist

from warmup_fir_filter_tpu_torch.parallel.distributed import (
    initialize_multihost,
)
from warmup_fir_filter_tpu_torch.utils.benchmarking import chained_throughput

#: Device memory bandwidth of one H100 SXM (NVIDIA's data sheet, at the
#: 700 W limit): the benches' speed of light.
PEAK_BYTES_PER_S = 3.35e12
#: The fixed FIR moves one byte in and one byte out a sample.
BYTES_PER_SAMPLE = 2.0
#: Msamples/s of a 2-bytes-a-sample pass at the data sheet's bandwidth.
SOL_MSPS = PEAK_BYTES_PER_S / BYTES_PER_SAMPLE / 1e6
#: The reference's scalar golden model (``fir_1d_fixed_ref.py:95-128``),
#: Msamples/s measured on a host CPU: the ``vs_baseline`` denominator
#: where it is not timed live.
REFERENCE_MSPS = 0.57
#: ``chained_throughput``'s chains for a CPU run: a check of the control
#: flow and the gates, not a measurement.
CPU_CHAINS = {"chain_short": 1, "chain_long": 3, "repeats": 1}
#: The checkout's root: the rank processes of a world run from it.
REPO_ROOT = Path(__file__).resolve().parents[2]
#: A rank process's line that carries its result.
RESULT_PREFIX = "RESULT "


def card(device: torch.device) -> dict:
    """The device keys of a JSON line: the card's name from torch and its
    name and power limit from ``nvidia-smi``, or the host for a CPU run."""
    if device.type != "cuda":
        return {"device": "cpu (plain versions on the host; no device "
                          "metric)", "card": None}
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    lines = proc.stdout.strip().splitlines()
    return {"device": torch.cuda.get_device_name(index),
            "card": lines[index] if index < len(lines) else lines[0]}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def emit(payload: dict) -> None:
    """The bench's one JSON line on stdout, flushed."""
    print(json.dumps(payload), flush=True)


def extras(payload: dict) -> None:
    """Comparison legs on stderr, as the JAX benches print them."""
    print(f"# extras: {json.dumps(payload)}", file=sys.stderr, flush=True)


def run(metric: str, unit: str, body: Callable[[], dict]) -> int:
    """Run ``body``, print its payload, return the exit code.

    A payload holding ``"error"`` (a failed gate) exits 1.  Any exception
    prints its traceback on stderr and the error line on stdout, and exits
    1: the bench is the boundary that reports every failure.
    """
    try:
        payload = body()
    except Exception as exc:  # noqa: BLE001 — the boundary: report, exit 1
        traceback.print_exc(file=sys.stderr)
        emit({"metric": metric, "value": 0.0, "unit": unit,
              "error": f"{type(exc).__name__}: {exc}"})
        return 1
    emit(payload)
    return 1 if "error" in payload else 0


def throughput(step: Callable, x: torch.Tensor, **kwargs) -> dict:
    """``chained_throughput`` of ``step`` on ``x``; on the CPU over
    :data:`CPU_CHAINS`, whatever the caller asked."""
    if x.device.type != "cuda":
        kwargs.update(CPU_CHAINS)
        kwargs["best_of"] = min(kwargs.get("best_of", 1), 2)
    return chained_throughput(step, x, **kwargs)


def msps(samples: int, seconds: float, device: torch.device) -> float:
    """Msamples/s of ``samples`` in ``seconds``.  A slope that is not
    positive raises on the card (the chains were too short to time) and
    reads 0 on the CPU, whose times are no measurement."""
    if seconds > 0:
        return samples / seconds / 1e6
    if device.type == "cuda":
        raise RuntimeError(f"non-positive time {seconds} s: the timed "
                           "chains are below the clock's resolution")
    return 0.0


def slope_seconds(seconds: float, device: torch.device,
                  floor: float) -> float:
    """A per-call time taken as a slope between two chain lengths.  Not
    positive, it raises on the card as :func:`msps` does, and reads
    ``floor`` on the CPU, whose times are no measurement."""
    if seconds > 0:
        return seconds
    if device.type == "cuda":
        raise RuntimeError(f"non-positive time {seconds} s: the timed "
                           "chains are below the clock's resolution")
    return floor


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextmanager
def world_of_one(device: torch.device) -> Iterator[int]:
    """The process group this process is in, or a world of one (NCCL on
    the card, gloo on the host) for the duration; yields its size."""
    if dist.is_initialized():
        yield dist.get_world_size()
        return
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                         device=device.type)
    try:
        yield 1
    finally:
        dist.destroy_process_group()


def spawn_world(module: str, world: int, argv: list[str],
                timeout_s: float) -> list[dict]:
    """Run ``python -m module *argv`` as the ``world`` ranks of one process
    group (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/
    ``LOCAL_RANK`` set for :func:`initialize_multihost`, a free localhost
    port; ``OMP_NUM_THREADS`` the host's cores over the ranks), wait for
    all of them and return each rank's result, the JSON of
    its last ``RESULT`` line.  Raises if a rank fails or outlasts
    ``timeout_s``; every rank is ended before this returns."""
    # The ranks share the host's cores: each takes its share of threads.
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // world)),
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(REPO_ROOT), os.environ.get("PYTHONPATH"))
                   if p))
    with ExitStack() as files:
        logs = [(files.enter_context(tempfile.TemporaryFile("w+")),
                 files.enter_context(tempfile.TemporaryFile("w+")))
                for _ in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", module, *argv],
            env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)},
            cwd=REPO_ROOT, stdout=out, stderr=err, text=True)
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
            if proc.returncode != 0 or not lines:
                raise RuntimeError(
                    f"rank {rank} of {world} ({module} {' '.join(argv)}) "
                    f"exited {proc.returncode}: {err.read()[-2000:]}")
            results.append(json.loads(lines[-1][len(RESULT_PREFIX):]))
    return results


def report_rank_result(result: dict) -> None:
    """A rank process's result, for :func:`spawn_world`."""
    print(RESULT_PREFIX + json.dumps(result), flush=True)
