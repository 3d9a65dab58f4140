"""The port's copies of the JAX package's numpy modules against the originals.

The port imports nothing of ``warmup_fir_filter_tpu``; it keeps copies of
the numpy modules it shares with it under the same names and paths.  Each
copy must stay the original with only its imports repointed, and must
give the same output on seeded inputs: arithmetic and golden rows
``np.array_equal``, files byte for byte (timestamps and artifact roots
masked in the reports).
"""

import re
from pathlib import Path

import numpy as np
import pytest

import warmup_fir_filter_tpu.models.filters as jax_filters
import warmup_fir_filter_tpu.models.golden as jax_golden
import warmup_fir_filter_tpu.models.reference_api as jax_reference_api
import warmup_fir_filter_tpu.ops.qformat as jax_qformat
import warmup_fir_filter_tpu.ops.validation as jax_validation
import warmup_fir_filter_tpu.pipeline.analysis as jax_analysis
import warmup_fir_filter_tpu.pipeline.report as jax_report
import warmup_fir_filter_tpu.pipeline.restore as jax_restore
import warmup_fir_filter_tpu.pipeline.stages as jax_stages
import warmup_fir_filter_tpu.pipeline.synthetic as jax_synthetic
import warmup_fir_filter_tpu.utils.profiling as jax_profiling
import warmup_fir_filter_tpu_torch.models.filters as port_filters
import warmup_fir_filter_tpu_torch.models.golden as port_golden
import warmup_fir_filter_tpu_torch.models.reference_api as port_reference_api
import warmup_fir_filter_tpu_torch.ops.qformat as port_qformat
import warmup_fir_filter_tpu_torch.ops.validation as port_validation
import warmup_fir_filter_tpu_torch.pipeline.analysis as port_analysis
import warmup_fir_filter_tpu_torch.pipeline.report as port_report
import warmup_fir_filter_tpu_torch.pipeline.restore as port_restore
import warmup_fir_filter_tpu_torch.pipeline.stages as port_stages
import warmup_fir_filter_tpu_torch.pipeline.synthetic as port_synthetic
import warmup_fir_filter_tpu_torch.utils.profiling as port_profiling
from warmup_fir_filter_tpu.pipeline.artifacts import ArtifactStore as JaxStore
from warmup_fir_filter_tpu_torch.pipeline.artifacts import ArtifactStore

REPO_ROOT = Path(__file__).resolve().parent.parent
#: Modules copied verbatim apart from their imports.
VERBATIM = ("ops/qformat.py", "ops/validation.py", "models/filters.py",
            "models/golden.py", "models/reference_api.py",
            "pipeline/artifacts.py", "pipeline/report.py",
            "pipeline/analysis.py", "pipeline/restore.py",
            "pipeline/synthetic.py", "utils/imageio.py", "utils/logging.py")
FORMATS = [(16, 12, 32), (8, 4, 32), (16, 12, 20), (32, 24, 32), (16, 1, 8),
           (16, 12, 48)]
TIMESTAMP = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?\+00:00")


@pytest.mark.parametrize("path", VERBATIM)
def test_copy_is_the_original_with_its_imports_repointed(path):
    original = (REPO_ROOT / "warmup_fir_filter_tpu" / path).read_text()
    copy = (REPO_ROOT / "warmup_fir_filter_tpu_torch" / path).read_text()
    assert copy == re.sub(r"(?m)^(\s*)from warmup_fir_filter_tpu\.",
                          r"\1from warmup_fir_filter_tpu_torch.", original)
    assert "import jax" not in copy


@pytest.mark.parametrize("fmt", FORMATS, ids=str)
def test_qformat_arithmetic(rng, fmt):
    jax_qf, port_qf = jax_qformat.QFormat(*fmt), port_qformat.QFormat(*fmt)
    for prop in ("scale", "min_coeff", "max_coeff", "min_coeff_real",
                 "max_coeff_real", "coeff_dtype", "tpu_native"):
        assert getattr(port_qf, prop) == getattr(jax_qf, prop), prop
    h = rng.uniform(-9.0, 9.0, size=257)
    np.testing.assert_array_equal(port_qf.quantize_coeffs(h),
                                  jax_qf.quantize_coeffs(h))
    assert port_qf.quantize_coeffs(h).dtype == jax_qf.quantize_coeffs(h).dtype
    acc = rng.integers(-(1 << 40), 1 << 40, size=4096)
    for name, args in (("wrap_to_acc_bits_np", (acc, fmt[2])),
                       ("bias_round_shift_np", (acc, fmt[1])),
                       ("saturate_pixel_np", (acc,)),
                       ("clamp_pixel_np", (acc,)),
                       ("round_half_up_np", (acc / 7.0,))):
        np.testing.assert_array_equal(getattr(port_qformat, name)(*args),
                                      getattr(jax_qformat, name)(*args))
    for qf in (jax_qf, port_qf):
        with pytest.raises(ValueError, match=r"Invalid h\[0\]"):
            qf.validate_h_range([1e9])


def test_qformat_validation_messages():
    for args in ((16, 0, 32), (16, 12, 0), (12, 12, 32)):
        with pytest.raises(ValueError) as jax_err:
            jax_qformat.QFormat(*args)
        with pytest.raises(ValueError) as port_err:
            port_qformat.QFormat(*args)
        assert str(port_err.value) == str(jax_err.value)


def test_validation_contracts(rng):
    x = rng.uniform(-20, 300, size=(3, 50))
    np.testing.assert_array_equal(port_validation.preprocess_x(x),
                                  jax_validation.preprocess_x(x))
    for bad_h in ([], [np.nan, 1.0], [0.5, 9.0]):
        with pytest.raises(ValueError) as jax_err:
            jax_validation.validate_h_coefficients(bad_h)
        with pytest.raises(ValueError) as port_err:
            port_validation.validate_h_coefficients(bad_h)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match=r"x\[2\]"):
        port_validation.validate_x([1.0, 2.0, np.inf])


def test_filter_banks():
    assert port_filters.FILTER_BANKS == jax_filters.FILTER_BANKS
    for taps in (3, 5):
        assert port_filters.filter_bank(taps) == jax_filters.filter_bank(taps)
    with pytest.raises(ValueError, match="num_taps=7"):
        port_filters.filter_bank(7)


@pytest.mark.parametrize("fmt", FORMATS, ids=str)
def test_golden_rows(rng, fmt):
    x = rng.integers(0, 256, size=(4, 300), dtype=np.uint8)
    for num_taps in (1, 3, 5, 64, 257):
        h = rng.uniform(-1.0, 1.0, size=num_taps)
        np.testing.assert_array_equal(
            port_golden.fir1d_fixed_golden_rows(x, h, port_qformat.QFormat(*fmt)),
            jax_golden.fir1d_fixed_golden_rows(x, h, jax_qformat.QFormat(*fmt)))
        np.testing.assert_array_equal(
            port_golden.fir1d_ideal_golden_rows(x, h),
            jax_golden.fir1d_ideal_golden_rows(x, h))
    row = rng.uniform(-10, 270, size=77)
    h = [0.25, 0.5, 0.25]
    np.testing.assert_array_equal(port_golden.fir1d_fixed_golden(row, h),
                                  jax_golden.fir1d_fixed_golden(row, h))
    np.testing.assert_array_equal(port_golden.fir1d_ideal_golden(row, h),
                                  jax_golden.fir1d_ideal_golden(row, h))


def test_reference_api(rng):
    """The reference-parity API: the same outputs and the same validation
    errors."""
    x = rng.integers(0, 256, size=150).tolist()
    for h in ([0.25, 0.5, 0.25], rng.uniform(-0.4, 0.4, size=9).tolist()):
        assert port_reference_api.fir_1d_ideal(x, h) == \
            jax_reference_api.fir_1d_ideal(x, h)
        for fmt in ({}, {"frac_bits": 6, "acc_bits": 20, "coeff_bits": 8}):
            np.testing.assert_array_equal(
                port_reference_api.fir_1d_fixed_golden(x, h, **fmt),
                jax_reference_api.fir_1d_fixed_golden(x, h, **fmt))
    for args in (([1, 2], [9.0]), ([1, 2], []), ([1, np.nan], [0.5]),
                 ([1, 2], [0.5], 0)):
        with pytest.raises(ValueError) as port_err:
            port_reference_api.fir_1d_fixed_golden(*args)
        with pytest.raises(ValueError) as jax_err:
            jax_reference_api.fir_1d_fixed_golden(*args)
        assert str(port_err.value) == str(jax_err.value)


def test_synthetic_corpus_bytes(tmp_path):
    """The whole corpus, PNG for PNG, including the "stripes" quirk: it
    renders a single row whatever the shape asked for."""
    jax_paths = jax_synthetic.synthesize_corpus(tmp_path / "jax")
    port_paths = port_synthetic.synthesize_corpus(tmp_path / "port")
    assert [p.name for p in port_paths] == [p.name for p in jax_paths]
    for a, b in zip(jax_paths, port_paths):
        assert b.read_bytes() == a.read_bytes(), b.name
    for kind in ("gradient", "checker", "stripes", "noise", "steps", "mix"):
        got = port_synthetic._render(kind, (48, 40), np.random.default_rng(3))
        want = jax_synthetic._render(kind, (48, 40), np.random.default_rng(3))
        np.testing.assert_array_equal(got, want)
    assert port_synthetic._render("stripes", (48, 40),
                                  np.random.default_rng(3)).shape == (1, 40)


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _masked(data: bytes, root: Path) -> str:
    text = data.decode()
    text = text.replace(str(root.resolve()), "<root>").replace(str(root),
                                                               "<root>")
    return TIMESTAMP.sub("<timestamp>", text)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """One store through stages 1-3 of each package (same corpus, golden
    fixed backend), then each package's reports, docs and restore."""
    base = tmp_path_factory.mktemp("copies")
    specs = (("img_a", "gradient", (40, 70)), ("img_b", "noise", (33, 41)),
             ("img_c", "steps", (24, 96)))
    jax_synthetic.synthesize_corpus(base / "img", specs=specs)
    roots = {"jax": base / "jax", "port": base / "port"}
    for name, stages, store_cls, device in (
            ("jax", jax_stages, JaxStore, {}),
            ("port", port_stages, ArtifactStore, {"device": "cpu"})):
        store = store_cls(roots[name])
        stages.generate_input_vectors(base / "img", store)
        for tap in (3, 5):
            stages.generate_ideal_outputs(store, tap=tap)
            stages.generate_fixed_outputs(store, tap=tap, backend="golden",
                                          **device)
    for name, report, analysis, restore, store_cls in (
            ("jax", jax_report, jax_analysis, jax_restore, JaxStore),
            ("port", port_report, port_analysis, port_restore,
             ArtifactStore)):
        store = store_cls(roots[name])
        for tap in (3, 5):
            report.generate_compare_report(store, tap=tap)
            analysis.generate_analysis_doc(store, tap=tap)
        analysis.generate_comparison_doc(store, taps=(3, 5))
        restore.restore_images(store, taps=(3, 5))
    return roots


def test_stage_artifacts_equal(stores):
    """Input vectors, previews, manifest, ideal and fixed outputs."""
    jax_files, port_files = _tree(stores["jax"]), _tree(stores["port"])
    assert sorted(port_files) == sorted(jax_files)
    vectors = [k for k in jax_files if k.endswith(".npy")]
    # inputs, then cases × filters × taps × (ideal, fixed)
    assert len(vectors) == 3 + 3 * 4 * 2 * 2
    for key in vectors:
        assert port_files[key] == jax_files[key], key
    for key in jax_files:
        if key.endswith(".json") and "report" not in key:
            assert (_masked(port_files[key], stores["port"])
                    == _masked(jax_files[key], stores["jax"])), key


@pytest.mark.parametrize("suffix", [".json", ".csv", ".md"])
def test_reports_and_docs_equal(stores, suffix):
    """The compare-report JSON and CSV and the analysis docs, with
    timestamps and the artifact roots masked."""
    jax_files, port_files = _tree(stores["jax"]), _tree(stores["port"])
    keys = [k for k in jax_files if k.endswith(suffix)]
    assert keys
    for key in keys:
        assert (_masked(port_files[key], stores["port"])
                == _masked(jax_files[key], stores["jax"])), key


def test_restored_pngs_equal(stores):
    jax_files, port_files = _tree(stores["jax"]), _tree(stores["port"])
    pngs = [k for k in jax_files if k.endswith(".png")]
    assert len(pngs) == 3 * 4 * 2 * 2  # cases × filters × taps × kinds
    for key in pngs:
        assert port_files[key] == jax_files[key], key


def test_stage_timer_line():
    """The copy's line equals the original's with no speed of light: the
    JAX package's default is a TPU figure, so the port's default is None."""
    lines = []
    for module, kwargs in ((jax_profiling, {"sol_msps": None}),
                           (port_profiling, {})):
        timer = module.StageTimer("stage", generated=2, **kwargs)
        timer.add_samples(10)
        lines.append(timer.status_line())
    assert lines[0] == lines[1]
    assert "sol_fraction" not in lines[1]
    assert not hasattr(port_profiling, "DEFAULT_SOL_MSPS")
    # The port's trace is its own, on torch.profiler: no jax import.
    assert "import jax" not in Path(port_profiling.__file__).read_text()


def test_stage_timer_fail_line(capsys):
    with pytest.raises(RuntimeError):
        with port_profiling.StageTimer("stage", generated=0):
            raise RuntimeError("boom")
    assert capsys.readouterr().out.startswith("[FAIL] stage generated=0")


def test_loaded_input_matches(stores):
    store = ArtifactStore(stores["port"])
    for path in store.iter_input_vectors():
        np.testing.assert_array_equal(port_stages._load_input_u8(path),
                                      jax_stages._load_input_u8(path))


def test_stores_read_each_others_artifacts(stores):
    """Either package's store lists and names the other's artifacts."""
    for root in stores.values():
        port, jax = ArtifactStore(root), JaxStore(root)
        assert port.iter_input_vectors() == jax.iter_input_vectors()
        for tap in (3, 5):
            assert (sorted(port.vector_dir("fixed", tap).glob("*.npy"))
                    == sorted(jax.vector_dir("fixed", tap).glob("*.npy")))
