"""The fixed stage and the CLI under the JAX package's backend names.

For each name of the JAX package's ``FIXED_BACKENDS`` and each tap group,
the JAX stage (``warmup_fir_filter_tpu.pipeline.stages.
generate_fixed_outputs``, its Pallas kernels in interpret mode on the CPU,
as its own tests run them) and the port's, on the three-image corpus of
``tests/test_torch_pipeline.py``, write byte-identical ``.npy`` files; so
does the port's CLI with ``--backend <name> --device cpu``.  The port's
default stays ``"auto"``, and a name the JAX package does not have raises
with the JAX message.
"""

import inspect
import shutil
from pathlib import Path

import numpy as np
import pytest

from warmup_fir_filter_tpu.pipeline import stages as jax_stages
from warmup_fir_filter_tpu.pipeline.artifacts import ArtifactStore
from warmup_fir_filter_tpu.pipeline.synthetic import synthesize_corpus
from warmup_fir_filter_tpu_torch import cli
from warmup_fir_filter_tpu_torch.pipeline import stages
from warmup_fir_filter_tpu_torch.pipeline.artifacts import (
    ArtifactStore as PortArtifactStore,
)

from test_torch_pipeline import SPECS

TAPS = (3, 5)
#: The port's own names before it took the JAX ones.
OLD_NAMES = ("band", "direct", "torch")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus, its input vectors, and the JAX stage's fixed outputs
    for each backend name, computed once."""
    base = tmp_path_factory.mktemp("backend_names")
    image_dir = base / "img"
    synthesize_corpus(image_dir, specs=SPECS)
    inputs = base / "inputs"
    jax_stages.generate_input_vectors(image_dir, ArtifactStore(inputs))
    jax_runs: dict[str, Path] = {}

    def jax_root(name: str) -> Path:
        if name not in jax_runs:
            root = base / f"jax_{name}"
            store = ArtifactStore(root)
            _copy_inputs(inputs, root)
            for tap in TAPS:
                jax_stages.generate_fixed_outputs(store, tap=tap,
                                                  backend=name)
            jax_runs[name] = root
        return jax_runs[name]

    return image_dir, inputs, jax_root


def _copy_inputs(src: Path, dst: Path) -> None:
    shutil.copytree(ArtifactStore(src).input_dir, ArtifactStore(dst).input_dir)


def _fixed_files(root: Path, tap: int) -> dict[str, bytes]:
    return {path.name: path.read_bytes() for path in sorted(
        ArtifactStore(root).vector_dir("fixed", tap).glob("*.npy"))}


def test_the_names_are_the_jax_packages():
    assert stages.FIXED_BACKENDS == jax_stages.FIXED_BACKENDS


@pytest.mark.parametrize("tap", TAPS)
@pytest.mark.parametrize("name", jax_stages.FIXED_BACKENDS)
def test_stage_writes_the_jax_stages_bytes(corpus, tmp_path, name, tap):
    _, inputs, jax_root = corpus
    _copy_inputs(inputs, tmp_path)
    generated = stages.generate_fixed_outputs(
        PortArtifactStore(tmp_path), tap=tap, backend=name, device="cpu")
    want = _fixed_files(jax_root(name), tap)
    assert generated == len(want) == len(SPECS) * 4
    assert _fixed_files(tmp_path, tap) == want


@pytest.mark.parametrize("name", jax_stages.FIXED_BACKENDS)
def test_cli_writes_the_jax_stages_bytes(corpus, tmp_path, name):
    image_dir, _, jax_root = corpus
    rc = cli.main(["--image-dir", str(image_dir), "--artifact-root",
                   str(tmp_path), "--backend", name, "--device", "cpu",
                   "--skip-ideal", "--skip-report", "--skip-restore"])
    assert rc == 0
    for tap in TAPS:
        want = _fixed_files(jax_root(name), tap)
        assert len(want) == len(SPECS) * 4
        assert _fixed_files(tmp_path, tap) == want


def test_the_default_backend_is_auto(corpus, tmp_path, monkeypatch):
    """``run_pipeline`` with no backend sends every fixed output through
    ``fir1d_fixed_rows_auto``; the stage and the CLI default to it too."""
    _, inputs, _ = corpus
    _copy_inputs(inputs, tmp_path)
    calls = []
    auto = stages.fir1d_fixed_rows_auto

    def spy(*args):
        calls.append(args[0].shape)
        return auto(*args)

    monkeypatch.setattr(stages, "fir1d_fixed_rows_auto", spy)
    result = cli.run_pipeline(image_dir=None, artifact_root=tmp_path,
                              device="cpu", skip_input=True, skip_ideal=True,
                              skip_report=True, skip_restore=True)
    assert len(calls) == len(SPECS) * 4 * len(TAPS)
    assert result["stages"]["fixed_3tap"]["generated"] == len(SPECS) * 4
    params = inspect.signature(stages.generate_fixed_outputs).parameters
    assert params["backend"].default == "auto"
    assert cli.build_argparser().parse_args([]).backend == "auto"


@pytest.mark.parametrize("name", OLD_NAMES + ("cuda",))
def test_unknown_name_raises_the_jax_message(corpus, tmp_path, name):
    _, inputs, _ = corpus
    with pytest.raises(ValueError) as jax_error:
        jax_stages.generate_fixed_outputs(ArtifactStore(inputs), tap=3,
                                          backend=name)
    with pytest.raises(ValueError) as port_error:
        stages.generate_fixed_outputs(PortArtifactStore(tmp_path), tap=3,
                                      backend=name, device="cpu")
    assert str(port_error.value) == str(jax_error.value)
    assert str(port_error.value).startswith(
        f"Unknown fixed backend={name!r}; expected (")
    with pytest.raises(ValueError, match="Unknown fixed backend"):
        stages._fixed_compute(name, np.zeros((1, 8), np.uint8),
                              np.array([1.0]), stages.QFormat(),
                              stages.resolve_device("cpu"))


@pytest.mark.parametrize("name", OLD_NAMES)
def test_argparse_rejects_the_old_names(name, capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli.build_argparser().parse_args(["--backend", name])
    assert exit_info.value.code == 2
    assert "invalid choice" in capsys.readouterr().err
