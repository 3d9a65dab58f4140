"""The slice as a whole: the port's 5-stage pipeline against the JAX CLI's.

On a three-image synthetic corpus, ``warmup_fir_filter_tpu.cli.run_pipeline
(backend="mxu")`` (the band kernels K1/K2, interpret mode on the CPU) and
the port's ``run_pipeline(backend="auto", device="cpu")`` must write
byte-identical ideal and fixed artifacts and equal compare metrics.  A
subprocess with jax blocked runs the port's CLI, as on a machine without
JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from warmup_fir_filter_tpu.cli import run_pipeline as jax_run_pipeline
from warmup_fir_filter_tpu.pipeline.artifacts import ArtifactStore
from warmup_fir_filter_tpu.pipeline.synthetic import synthesize_corpus
from warmup_fir_filter_tpu.utils.imageio import save_gray_png
from warmup_fir_filter_tpu_torch.cli import main as port_main
from warmup_fir_filter_tpu_torch.cli import run_pipeline as port_run_pipeline

from test_torch_dispatch import BLOCK_JAX, REPO_ROOT

SPECS = (
    ("img_a_tiny", "gradient", (64, 64)),
    ("img_b_steps", "steps", (300, 400)),
    ("img_c_checker", "checker", (256, 256)),
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX run and one port run over the same corpus."""
    base = tmp_path_factory.mktemp("pipeline")
    image_dir = base / "img"
    synthesize_corpus(image_dir, specs=SPECS)
    jax_root, port_root = base / "jax", base / "port"
    jax_result = jax_run_pipeline(image_dir=image_dir, artifact_root=jax_root,
                                  backend="mxu")
    port_result = port_run_pipeline(image_dir=image_dir,
                                    artifact_root=port_root,
                                    backend="auto", device="cpu")
    return image_dir, jax_root, port_root, jax_result, port_result


def _npy_files(root: Path, kind: str) -> dict[str, bytes]:
    store = ArtifactStore(root)
    files = {}
    for tap in (3, 5):
        for path in sorted(store.vector_dir(kind, tap).glob("*.npy")):
            files[f"{tap}/{path.name}"] = path.read_bytes()
    return files


@pytest.mark.parametrize("kind", ["fixed", "ideal"])
def test_artifacts_byte_identical(runs, kind):
    _, jax_root, port_root, _, _ = runs
    jax_files, port_files = _npy_files(jax_root, kind), _npy_files(port_root, kind)
    assert len(port_files) == len(SPECS) * 4 * 2
    assert port_files.keys() == jax_files.keys()
    for name in jax_files:
        assert port_files[name] == jax_files[name], name


@pytest.mark.parametrize("tap", [3, 5])
def test_compare_summaries_equal(runs, tap):
    _, jax_root, port_root, _, _ = runs
    summaries = [
        json.loads((ArtifactStore(root).report_dir(tap)
                    / f"compare_{tap}tap_summary.json").read_text())
        for root in (jax_root, port_root)
    ]
    for field in ("overall", "by_coeff", "weighted"):
        assert summaries[0][field] == summaries[1][field]


def test_stage_counts_match(runs):
    *_, jax_result, port_result = runs
    assert port_result["stages"].keys() == jax_result["stages"].keys()
    for stage, counts in jax_result["stages"].items():
        if stage.startswith("report"):
            for key in ("num_cases", "num_samples_total", "overall"):
                assert port_result["stages"][stage][key] == counts[key]
        else:
            assert port_result["stages"][stage] == counts


def test_port_main_resume_regenerates_nothing(runs, capsys):
    image_dir, _, port_root, _, _ = runs
    fixed = ArtifactStore(port_root).vector_dir("fixed", 3)
    stamps = {p.name: p.stat().st_mtime_ns for p in fixed.glob("*.npy")}
    rc = port_main(["--image-dir", str(image_dir), "--artifact-root",
                    str(port_root), "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[OK] pipeline generated=0 " in out
    assert "gen_fixed_outputs_3tap generated=0 skipped=12" in out
    assert "sol_fraction" not in out
    assert {p.name: p.stat().st_mtime_ns for p in fixed.glob("*.npy")} == stamps


def test_port_main_profile_writes_the_same_bytes_and_a_trace(runs, tmp_path):
    """``--profile DIR`` wraps the pipeline in ``trace``: the same fixed
    bytes as the untraced run, and a TensorBoard trace in DIR."""
    image_dir, _, port_root, _, _ = runs
    rc = port_main(["--image-dir", str(image_dir), "--artifact-root",
                    str(tmp_path / "out"), "--device", "cpu", "--skip-ideal",
                    "--skip-report", "--skip-restore", "--profile",
                    str(tmp_path / "prof")])
    assert rc == 0
    traced = _npy_files(tmp_path / "out", "fixed")
    assert len(traced) == len(SPECS) * 4 * 2
    assert traced == _npy_files(port_root, "fixed")
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"] if e.get("ph") == "X"}
    assert any(name.startswith("aten::") for name in names)


def test_port_main_needs_image_dir(tmp_path):
    with pytest.raises(ValueError, match="image directory"):
        port_main(["--artifact-root", str(tmp_path), "--device", "cpu"])


def test_port_cli_runs_with_jax_blocked(tmp_path):
    """The port's CLI end to end in a process where ``import jax`` fails."""
    rng = np.random.default_rng(7)
    save_gray_png(tmp_path / "img" / "img_x.png",
                  rng.integers(0, 256, size=(16, 150), dtype=np.uint8))
    code = BLOCK_JAX + (
        "import runpy\n"
        "sys.argv = ['warmup_fir_filter_tpu_torch', "
        f"'--image-dir', {str(tmp_path / 'img')!r}, "
        f"'--artifact-root', {str(tmp_path / 'out')!r}, "
        "'--device', 'cpu', '--tap', '5']\n"
        "runpy.run_module('warmup_fir_filter_tpu_torch', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[OK] pipeline" in proc.stdout
    assert "jax" not in proc.stderr.lower()
    fixed = list(ArtifactStore(tmp_path / "out").vector_dir("fixed", 5)
                 .glob("*.npy"))
    assert len(fixed) == 4
    assert all(np.load(p).dtype == np.uint8 for p in fixed)
