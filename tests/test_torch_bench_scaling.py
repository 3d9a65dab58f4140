"""The port's scaling bench (``benches/bench_scaling.py``) over gloo worlds.

Each mode's ``main`` runs with ``--backend gloo`` over two ranks at a tiny
size: a world of one in the test process and a world of two as rank
processes of the module.  Every run exits 0 and its JSON line carries the
JAX bench's metric and keys (``platform`` renamed ``backend``); the
pipelines' outputs are checked inside the bench.  A rank that fails makes
the launcher raise, and the bench print an error line and exit 1.

Tolerance: exact (the pipelines' outputs are integers in f32).
"""

import ast
import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu_torch.benches import _common, bench_scaling

REPO_ROOT = Path(__file__).resolve().parent.parent
TINY = ["--backend", "gloo", "--devices", "2", "--time", "1024",
        "--repeats", "2"]
#: Each mode's metric and the keys of the JAX bench's line
#: (bench_scaling.py:100-109, :199-213, :233-245, :260-270).
JAX_LINES = {
    "overhead": ("halo_sharding_efficiency",
                 ("metric", "value", "unit", "vs_baseline", "platform",
                  "time_sharded_s", "channel_sharded_s", "workload")),
    "weak": ("scaling_efficiency_weak",
             ("metric", "value", "unit", "vs_baseline", "platform",
              "msps_per_n", "workload")),
    "pp": ("pipeline_parallel_overlap",
           ("metric", "value", "unit", "vs_baseline", "platform",
            "sequential_s", "pipelined_s", "stage_delay_s", "spmd_pipeline",
            "speedup", "theoretical", "fraction_of_theoretical", "stages",
            "microbatches")),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs, as a rank of a shared
    host has: the benches run thousands of small ops, which a pool of
    threads spinning for cores that other test workers hold slows many
    times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_main(argv) -> tuple[int, dict]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_scaling.main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def all_keys(value) -> set:
    if isinstance(value, dict):
        return set(value) | {k for v in value.values() for k in all_keys(v)}
    return set()


@pytest.mark.parametrize("mode", sorted(JAX_LINES))
def test_mode_runs_and_carries_the_jax_keys(mode):
    metric, keys = JAX_LINES[mode]
    constants = {node.value for node in ast.walk(ast.parse(
        (REPO_ROOT / "bench_scaling.py").read_text()))
        if isinstance(node, ast.Constant) and isinstance(node.value, str)}
    assert set(keys) <= constants, "the list drifted from the JAX bench"
    rc, line = run_main(["--mode", mode, *TINY])
    assert rc == 0 and "error" not in line, line
    assert line["metric"] == metric and line["backend"] == "gloo"
    present = all_keys(line)
    for key in keys:
        assert bench_scaling.RENAMED.get(key, key) in present, key
    assert "platform" not in present
    if mode in ("overhead", "weak"):
        assert line["bit_exact_vs_unsharded"] is True
    if mode == "weak":
        assert set(line["msps_per_n"]) == {"1", "2"}
        assert "2-device" not in line["workload"]
    if mode == "overhead":
        assert line["workload"].endswith("2-device mesh")
    if mode == "pp":
        assert line["spmd_pipeline"]["stages"] == 2
        assert line["devices"] == ["cpu", "cpu"]


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_weak_worlds_replay_the_jax_draws(m):
    """The world of m gets the input the JAX bench draws for m from its
    one generator (bench_scaling.py:248-257)."""
    rng = np.random.default_rng(7)
    size = 1
    while size <= m:
        want = rng.integers(0, 256, size=(8, 64 * size), dtype=np.uint8)
        size *= 2
    np.testing.assert_array_equal(bench_scaling.weak_input(8, 64, m), want)


def test_a_wrong_sharded_output_is_refused():
    """``check_unsharded`` holds a gathered output to the unsharded FIR:
    the output of another input fails it."""
    h = np.asarray(bench_scaling.FILTER_BANK_5TAP["sharpen"])
    x = np.random.default_rng(3).integers(0, 256, size=(4, 256),
                                          dtype=np.uint8)
    with _common.world_of_one(torch.device("cpu")):
        mesh = bench_scaling.make_mesh({"data": 1, "time": 1},
                                       device_type="cpu")
        bench_scaling.check_unsharded(
            bench_scaling.fir1d_fixed_sharded(x, h, mesh=mesh), x, h, "ok")
        with pytest.raises(AssertionError, match="not equal"):
            bench_scaling.check_unsharded(
                bench_scaling.fir1d_fixed_sharded(x ^ 1, h, mesh=mesh), x, h,
                "flipped")


def test_a_failed_rank_fails_the_launcher():
    """Both ranks join the group, then raise on a negative width."""
    with pytest.raises(RuntimeError, match="(?s)rank 0 of 2.*ValueError"):
        _common.spawn_world(bench_scaling.MODULE, 2,
                            ["--rank-task", "weak", "--backend", "gloo",
                             "--time", "-1"], timeout_s=120)


def test_a_failed_world_is_an_error_line(monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("rank 1 of 2 exited 1")

    monkeypatch.setattr(_common, "spawn_world", boom)
    rc, line = run_main(["--mode", "overhead", *TINY])
    assert rc == 1 and "rank 1 of 2" in line["error"]
    assert line["metric"] == "halo_sharding_efficiency"
