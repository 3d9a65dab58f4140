"""The port's kernel choice, its refusal to hide a missing device, the
build's refusal to run without nvcc, and its JAX-free imports.

Fixed-point comparisons are ``np.array_equal`` (tolerance 0).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from warmup_fir_filter_tpu.kernels.dispatch import (
    fir1d_fixed_rows_auto as jax_auto,
)
from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels import dispatch, fir_band, fir_direct
from warmup_fir_filter_tpu_torch.pipeline import stages

REPO_ROOT = Path(__file__).resolve().parent.parent

#: Modules of the JAX package that import jax; the port must import none.
JAX_MODULES = ("jax", "jaxlib", "warmup_fir_filter_tpu.kernels",
               "warmup_fir_filter_tpu.ops.fir1d",
               "warmup_fir_filter_tpu.ops.streaming",
               "warmup_fir_filter_tpu.parallel",
               "warmup_fir_filter_tpu.utils.benchmarking")

#: A ``sys.meta_path`` finder refusing JAX_MODULES, for subprocesses.
BLOCK_JAX = f"""
import sys
BLOCKED = {JAX_MODULES!r}
class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if any(name == m or name.startswith(m + ".") for m in BLOCKED):
            raise ImportError("blocked import of " + name)
        return None
sys.meta_path.insert(0, BlockJax())
"""


def _rows(rng, width=77):
    return rng.integers(0, 256, size=(3, width), dtype=np.uint8)


@pytest.mark.parametrize("num_taps,kernel", [(1, "band"), (5, "band"),
                                             (257, "band"), (258, "direct"),
                                             (300, "direct")])
def test_auto_picks_kernel_by_taps(monkeypatch, rng, num_taps, kernel):
    calls = []
    plain_band, plain_direct = fir_band.fir_band_plain, fir_direct.fir1d_fixed_rows_torch

    def band_spy(x, fir):
        calls.append("band")
        return plain_band(x, fir)

    def direct_spy(x, h, qf):
        calls.append("direct")
        return plain_direct(x, h, qf)

    monkeypatch.setattr(fir_band, "fir_band_plain", band_spy)
    monkeypatch.setattr(fir_direct, "fir1d_fixed_rows_torch", direct_spy)
    qf = QFormat(16, 12, 24)
    h = rng.uniform(-0.05, 0.05, size=num_taps)
    x = _rows(rng)
    got = dispatch.fir1d_fixed_rows_auto(torch.from_numpy(x), h, qf)
    assert calls == [kernel]
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), fir1d_fixed_golden_rows(x, h, qf))


@pytest.mark.parametrize("num_taps", [3, 5, 63])
def test_auto_matches_jax_auto(rng, num_taps):
    qf = QFormat(16, 12, 20)
    h = rng.uniform(-1.0, 1.0, size=num_taps)
    x = _rows(rng, 200)
    np.testing.assert_array_equal(
        dispatch.fir1d_fixed_rows_auto(torch.from_numpy(x), h, qf).numpy(),
        np.asarray(jax_auto(x, h, qf)))


def test_auto_wide_accumulator_goes_to_golden(rng):
    """acc_bits > 32: the golden on a CPU tensor, a refusal on any other."""
    qf = QFormat(32, 12, 48)
    h = np.array([7.5, -8.0, 7.9])
    x = _rows(rng)
    got = dispatch.fir1d_fixed_rows_auto(torch.from_numpy(x), h, qf)
    np.testing.assert_array_equal(got.numpy(), fir1d_fixed_golden_rows(x, h, qf))
    with pytest.raises(ValueError, match="acc_bits=48"):
        dispatch.fir1d_fixed_rows_auto(torch.from_numpy(x).to("meta"), h, qf)
    np.testing.assert_array_equal(
        stages._fixed_compute("auto", x, h, qf, torch.device("cpu")),
        fir1d_fixed_golden_rows(x, h, qf))


def test_cpu_tensors_launch_no_kernel(rng):
    before = (fir_band.fir_band.launches, fir_direct.fir_direct.launches)
    x = torch.from_numpy(_rows(rng))
    dispatch.fir1d_fixed_rows_auto(x, [0.25, 0.5, 0.25])
    fir_direct.fir_direct(x, [0.25, 0.5, 0.25])
    assert (fir_band.fir_band.launches, fir_direct.fir_direct.launches) == before


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        stages.resolve_device("cuda")
    assert stages.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="device"):
        stages.resolve_device("meta")


def test_fixed_stage_with_cuda_device_raises_without_cuda(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        stages._fixed_compute("auto", _rows(rng), np.array([0.5, 0.5]),
                              QFormat(), stages.resolve_device("cuda"))


@pytest.mark.parametrize("backend", stages.FIXED_BACKENDS)
def test_every_backend_on_cpu_matches_golden(rng, backend):
    h = np.array([-0.125, 1.25, -0.125])
    x = _rows(rng, 300)
    got = stages._fixed_compute(backend, x, h, QFormat(), torch.device("cpu"))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, fir1d_fixed_golden_rows(x, h))


def test_band_backend_refuses_long_filters(rng):
    with pytest.raises(ValueError, match="257"):
        stages._fixed_compute("band", _rows(rng), np.ones(300) / 300,
                              QFormat(), torch.device("cpu"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.find_nvcc()
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.build(tmp_path / "build")
    with pytest.raises(_build.BuildError, match="nvcc"):
        _build.load_library(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_build_raises_when_nvcc_fails(monkeypatch, tmp_path):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.BuildError, match="refused"):
        _build.build(tmp_path / "build")
    assert not (tmp_path / "build" / _build.LIBRARY_NAME).exists()


def test_source_digest_follows_sources(monkeypatch, tmp_path):
    for src in _build.CSRC_DIR.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.source_digest()
    (tmp_path / "fir_band.cu").write_text("// changed\n")
    assert _build.source_digest() != first
    assert [p.name for p in _build.kernel_sources()] == [
        "fir_band.cu", "fir_direct.cu"]


def test_port_imports_no_jax_module():
    """Every module of the port imports with JAX_MODULES blocked."""
    modules = sorted(
        "warmup_fir_filter_tpu_torch." + ".".join(
            p.relative_to(REPO_ROOT / "warmup_fir_filter_tpu_torch")
            .with_suffix("").parts)
        for p in (REPO_ROOT / "warmup_fir_filter_tpu_torch").rglob("*.py")
        if p.name not in ("__init__.py", "__main__.py"))
    code = BLOCK_JAX + (
        "import importlib\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m in sys.modules)\n"
        "print('imported', len(" + repr(modules) + "))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(modules)}" in proc.stdout
