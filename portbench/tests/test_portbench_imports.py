"""Running a cell loads neither JAX nor the JAX package, compared by whole
top-level names; the reference loads nothing of the port."""

import json
import subprocess
import sys

import pytest

from portbench.common import ROOT, forbidden_loaded, loaded_top_level


def test_names_are_compared_whole():
    mods = ["warmup_fir_filter_tpu_torch.ops", "jaxtyping", "numpy"]
    assert forbidden_loaded(mods) == []
    assert forbidden_loaded(mods + ["warmup_fir_filter_tpu.ops"]) == [
        "warmup_fir_filter_tpu"]
    assert forbidden_loaded(["jax._src.core"]) == ["jax"]
    assert loaded_top_level(["a.b.c", "a", "d"]) == {"a", "d"}


def modules_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name", ["sharpen5.rows", "lowpass63.rows",
                                  "sharpen5.stream"])
def test_a_dry_run_loads_no_jax(name):
    code = ("from portbench import run\n"
            f"assert run.main(['--workload', '{name}', '--seed', '3', "
            "'--seconds', '0.2', '--trace', '0', '--dry-cpu']) == 0")
    loaded = modules_after(code)
    assert "warmup_fir_filter_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "warmup_fir_filter_tpu"}


def test_the_sharded_modules_load_no_jax():
    code = ("import portbench.drivers.sharded, portbench.drivers.sharded_rank\n"
            "import warmup_fir_filter_tpu_torch.parallel.fft_sharded\n"
            "import warmup_fir_filter_tpu_torch.parallel.distributed")
    loaded = modules_after(code)
    assert not loaded & {"jax", "jaxlib", "flax", "warmup_fir_filter_tpu"}


def test_reference_and_checks_load_nothing_of_the_port():
    code = ("import portbench.reference, portbench.roofline\n"
            "from portbench import harness\n"
            "for c in ('rows_exact', 'stream_exact', 'f32_rel'):\n"
            "    harness.load_module('checks', c)")
    loaded = modules_after(code)
    assert not loaded & {"warmup_fir_filter_tpu_torch", "jax",
                         "warmup_fir_filter_tpu"}


def test_a_run_refuses_a_loaded_jax_package(monkeypatch, capsys):
    from portbench import run

    monkeypatch.setitem(sys.modules, "warmup_fir_filter_tpu",
                        type(sys)("warmup_fir_filter_tpu"))
    assert run.main(["--workload", "sharpen5.rows", "--seed", "1",
                     "--seconds", "0.1", "--trace", "0", "--dry-cpu"]) == 3
    out, err = capsys.readouterr()
    assert out == ""
    assert "warmup_fir_filter_tpu" in err


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "sharpen5.rows",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "is_available" in proc.stderr


def test_a_checkout_without_the_port_fails_and_prints_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "sharpen5.rows",
         "--seed", "1", "--seconds", "1", "--trace", "0", "--dry-cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "warmup_fir_filter_tpu_torch" in proc.stderr
