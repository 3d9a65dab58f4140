"""The port's kernel choice, its refusal to hide a missing device, the
build's refusal to run without nvcc, and its independence from JAX and
from the JAX package.

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
    fir2d_fixed_auto as jax_auto_2d,
)
from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu.ops.fir2d import fir2d_fixed_golden
from warmup_fir_filter_tpu_torch import _build
from warmup_fir_filter_tpu_torch.kernels import (
    dispatch,
    fir2d,
    fir_band,
    fir_direct,
    fir_window,
)
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.pipeline import stages

REPO_ROOT = Path(__file__).resolve().parent.parent

#: JAX and the whole JAX package: the port imports none of them, not even
#: the package's numpy modules (it keeps its own copies).
JAX_MODULES = ("jax", "jaxlib", "warmup_fir_filter_tpu")

#: A ``sys.meta_path`` finder refusing JAX_MODULES and their submodules
#: (``warmup_fir_filter_tpu_torch`` is not one), for subprocesses.
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
                                             (257, "band"), (258, "window"),
                                             (300, "window"),
                                             (4096, "window"),
                                             (4097, "direct")])
def test_auto_picks_kernel_by_taps(monkeypatch, rng, num_taps, kernel):
    """The JAX package's choice (``dispatch.py:59-64``), by tap count."""
    calls = []
    plain_band, plain_direct = fir_band.fir_band_plain, fir_direct.fir_direct_plain
    plain_window = fir_window.fir_window_plain

    def band_spy(x, fir):
        calls.append("band")
        return plain_band(x, fir)

    def window_spy(x, fir):
        calls.append("window")
        return plain_window(x, fir)

    def direct_spy(x, fir):
        calls.append("direct")
        return plain_direct(x, fir)

    monkeypatch.setattr(fir_band, "fir_band_plain", band_spy)
    monkeypatch.setattr(fir_window, "fir_window_plain", window_spy)
    monkeypatch.setattr(fir_direct, "fir_direct_plain", direct_spy)
    qf = QFormat(16, 12, 24)
    h = rng.uniform(-0.05, 0.05, size=num_taps)
    x = _rows(rng)
    got = dispatch.fir1d_fixed_rows_auto(torch.from_numpy(x), h, qf)
    assert calls == [kernel]
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), fir1d_fixed_golden_rows(x, h, qf))


@pytest.mark.parametrize("num_taps", [3, 5, 63, 300])
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


@pytest.mark.parametrize("shape,path", [((5, 5), "oframe"),
                                        ((3, 129), "frame"),
                                        ((3, 258), "torch"),
                                        ((2, 1), "frame")])
def test_auto_2d_matches_jax_auto(monkeypatch, rng, shape, path):
    """The JAX package's 2-D choice (``dispatch.py:67-85``): the overlapped
    frame for 0 < Lc - 1 <= 96, the plain frame up to Lc = 257, the int32
    path beyond."""
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(fir2d, "fir2d_frame_plain",
                        spy("frame", fir2d.fir2d_frame_plain))
    monkeypatch.setattr(fir2d, "fir2d_oframe_plain",
                        spy("oframe", fir2d.fir2d_oframe_plain))
    monkeypatch.setattr(dispatch, "fir2d_fixed_torch",
                        spy("torch", dispatch.fir2d_fixed_torch))
    qf = QFormat(16, 12, 24)
    h = rng.uniform(-0.05, 0.05, size=shape)
    x = rng.integers(0, 256, size=(24, 300), dtype=np.uint8)
    got = dispatch.fir2d_fixed_auto(torch.from_numpy(x), h, qf)
    assert calls == [path]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_auto_2d(x, h, qf)))
    np.testing.assert_array_equal(got.numpy(), fir2d_fixed_golden(x, h, qf))


def test_auto_2d_wide_accumulator_raises():
    x = torch.zeros((8, 8), dtype=torch.uint8)
    for h in (np.ones((3, 3)) / 9, np.ones((3, 258)) / 774):
        with pytest.raises(ValueError, match="acc_bits=48"):
            dispatch.fir2d_fixed_auto(x, h, QFormat(32, 12, 48))


def _launch_counts():
    return (fir_band.fir_band.launches, fir_direct.fir_direct.launches,
            fir_window.fir_window.launches, fir2d.fir2d_frame.launches,
            fir2d.fir2d_oframe.launches, fir2d.fir2d_bf16.launches)


def test_cpu_tensors_launch_no_kernel(rng):
    before = _launch_counts()
    x = torch.from_numpy(_rows(rng))
    dispatch.fir1d_fixed_rows_auto(x, [0.25, 0.5, 0.25])
    dispatch.fir1d_fixed_rows_auto(x, np.ones(300) / 300)
    fir_direct.fir_direct(x, [0.25, 0.5, 0.25])
    dispatch.fir2d_fixed_auto(x, np.ones((3, 3)) / 9)
    dispatch.fir2d_fixed_auto(x, np.ones((3, 129)) / 387)
    assert _launch_counts() == before


@pytest.mark.parametrize("num_taps,module", [
    (5, "FixedFir1d"), (257, "FixedFir1d"), (258, "FixedFirWindow"),
    (4096, "FixedFirWindow"), (4097, "FixedFirDirect")])
def test_prepare_fixed_fir_by_taps(rng, num_taps, module):
    """One prepared module per filter, reused across blocks, equal to the
    golden on each."""
    qf = QFormat(16, 12, 24)
    h = rng.uniform(-0.05, 0.05, size=num_taps)
    fir = dispatch.prepare_fixed_fir(h, qf, "cpu")
    assert type(fir).__name__ == module
    for width in (77, 130):
        x = _rows(rng, width)
        np.testing.assert_array_equal(fir(torch.from_numpy(x)).numpy(),
                                      fir1d_fixed_golden_rows(x, h, qf))
    with pytest.raises(ValueError, match="acc_bits"):
        dispatch.prepare_fixed_fir(h, QFormat(32, 12, 48))


@pytest.mark.parametrize("entry,module,shape", [
    ("prepare_fixed_fir", "FixedFir1d", (5,)),
    ("prepare_fixed_fir", "FixedFirWindow", (300,)),
    ("prepare_fixed_fir", "FixedFirDirect", (4097,)),
    ("prepare_fixed_fir2d", "FixedFir2d", (3, 5))])
def test_prepare_entries_default_to_the_card(monkeypatch, entry, module,
                                             shape):
    """A filter prepared without a device is prepared on the card, as
    ``Fir1DStream``'s is."""
    seen = []

    class Record:
        def __init__(self, h, qformat, device):
            seen.append(str(device))

        @classmethod
        def from_numpy(cls, h, qformat, device):
            return cls(h, qformat, device)

    monkeypatch.setattr(dispatch, module, Record)
    getattr(dispatch, entry)(np.full(shape, 0.01), QFormat())
    assert seen == ["cuda"]


def test_prepared_direct_uploads_taps_once(rng):
    qf = QFormat()
    h = rng.uniform(-0.01, 0.01, size=4097)
    fir = dispatch.prepare_fixed_fir(h, qf, "cpu")
    assert fir.h_fixed.dtype == torch.int32
    np.testing.assert_array_equal(fir.h_fixed.numpy(),
                                  qf.quantize_coeffs(h).astype(np.int32))
    assert set(fir.state_dict()) == {"h_fixed", "bias", "needs_wrap",
                                     "digits", "copies", "chunk_table"}
    assert fir.to("meta").h_fixed.device.type == "meta"
    assert fir.to("meta").copies.device.type == "meta"


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
        stages._fixed_compute("mxu", _rows(rng), np.ones(300) / 300,
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


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One nvcc per source (all started before any is waited for), one
    link; the temporary objects are gone and the stamp written."""
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text(
        "#!/bin/sh\n"
        'echo "$@" >> "$(dirname "$0")/calls.log"\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        'echo built > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    library = _build.build(tmp_path / "build")
    calls = (tmp_path / "bin" / "calls.log").read_text().splitlines()
    sources = _build.kernel_sources()
    compiles = [c for c in calls if " -c " in c]
    assert len(compiles) == len(sources) == 13
    assert all(str(src) in " ".join(compiles) for src in sources)
    assert len(calls) == len(sources) + 1 and "-shared" in calls[-1]
    assert sorted(p.name for p in library.parent.iterdir()) == [
        _build.LIBRARY_NAME, f"{_build.LIBRARY_NAME}.sha256"]
    assert _build.build(tmp_path / "build") == library  # up to date
    assert len((tmp_path / "bin" / "calls.log").read_text().splitlines()) == 14


def test_source_digest_follows_sources(monkeypatch, tmp_path):
    for src in _build.CSRC_DIR.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.source_digest()
    (tmp_path / "fir_band.cu").write_text("// changed\n")
    assert _build.source_digest() != first
    assert [p.name for p in _build.kernel_sources()] == [
        "chain_fused.cu", "copy_rows.cu", "fft_rows.cu", "fir2d_bf16.cu", "fir2d_frame.cu",
        "fir_band.cu", "fir_direct.cu", "fir_float.cu", "fir_window.cu",
        "osfilt.cu", "osfilt_stream.cu", "resample.cu", "window_copy.cu"]
    for header in ("wft_window.cuh", "wft_fir2d.cuh", "wft_chain.cuh",
                   "wft_band.cuh", "wft_fft_rows.cuh", "wft_band_mma.cuh",
                   "wft_copy.cuh"):
        first = _build.source_digest()
        (tmp_path / header).write_text("// changed\n")
        assert _build.source_digest() != first


def test_port_imports_no_jax_module():
    """Every module of the port, and chip_smoke.py with all its imports,
    imports with JAX and the whole JAX package blocked."""
    modules = sorted(
        "warmup_fir_filter_tpu_torch." + ".".join(
            p.relative_to(REPO_ROOT / "warmup_fir_filter_tpu_torch")
            .with_suffix("").parts)
        for p in (REPO_ROOT / "warmup_fir_filter_tpu_torch").rglob("*.py")
        if p.name not in ("__init__.py", "__main__.py"))
    assert {"warmup_fir_filter_tpu_torch.kernels.chain_fused",
            "warmup_fir_filter_tpu_torch.kernels.fft",
            "warmup_fir_filter_tpu_torch.kernels.fir2d",
            "warmup_fir_filter_tpu_torch.kernels.fir_float",
            "warmup_fir_filter_tpu_torch.kernels.fir_window",
            "warmup_fir_filter_tpu_torch.kernels.resample",
            "warmup_fir_filter_tpu_torch.kernels.window_copy",
            "warmup_fir_filter_tpu_torch.models.chain",
            "warmup_fir_filter_tpu_torch.models.golden",
            "warmup_fir_filter_tpu_torch.ops.demod",
            "warmup_fir_filter_tpu_torch.ops.fftfilt",
            "warmup_fir_filter_tpu_torch.ops.fir2d",
            "warmup_fir_filter_tpu_torch.ops.qformat",
            "warmup_fir_filter_tpu_torch.ops.resample",
            "warmup_fir_filter_tpu_torch.ops.streaming",
            "warmup_fir_filter_tpu_torch.pipeline.report",
            "warmup_fir_filter_tpu_torch.utils.profiling"} <= set(modules)
    assert not (REPO_ROOT / "warmup_fir_filter_tpu_torch"
                / "reference.py").exists()
    modules.append("chip_smoke")
    code = BLOCK_JAX + (
        "import importlib\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib', "
        "'warmup_fir_filter_tpu') for m in sys.modules)\n"
        "print('imported', len(" + repr(modules) + "))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(modules)}" in proc.stdout
