"""The port's benches (``warmup_fir_filter_tpu_torch/benches/``) on the CPU.

Each bench's ``main`` runs with ``--device cpu`` (the kernels' plain
versions) at a tiny size, its module's size constants patched: every gate
true and exit 0; its JSON line
carries the JAX bench's metric name, unit and keys, except those each port
module lists in ``RENAMED`` (present under the new name) and ``DROPPED``
(TPU-only, absent); a wrapper patched to flip one output byte makes the
gated benches exit non-zero with an ``"error"``; configs 1-3 give the JAX
bench's own results at the same seeds; the stream source equals
``bench_streaming.py:77-84``'s blocks; the roofline sizes its probes as
the JAX harness does.  The scaling bench's worlds are in
``tests/test_torch_bench_scaling.py``.

Tolerance: exact.  Configs 1-3 compare the printed values (SNR to 0.01 dB,
RMSE to 1e-4, both rounded as both benches round them) with equality, since
the fixed outputs are bit-exact and both sides share the numpy goldens.
"""

import ast
import contextlib
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_configs as jax_bench_configs
from warmup_fir_filter_tpu_torch.benches import (
    bench,
    bench_2d,
    bench_configs,
    bench_roofline,
    bench_streaming,
    bench_taps,
)
from warmup_fir_filter_tpu_torch.kernels import fir2d, fir_band

REPO_ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")

#: Each bench's tiny CPU run: its module, its arguments and the module
#: constants patched for the run.
RUNS = {
    "bench_roofline": (bench_roofline, ["--sizes-mb", "1"], {}),
    "bench": (bench, [], {"BATCH": 64, "WIDTH": 1024, "BATCH_LARGE": 96}),
    "bench_taps": (bench_taps, [], {"BATCH": 16, "WIDTH": 512,
                                    "TAP_SWEEP": (5, 63, 300)}),
    "bench_streaming": (bench_streaming, [], {"CHANNELS": 3, "BLOCK": 1024,
                                              "NUM_BLOCKS": 6}),
    "bench_2d": (bench_2d, [], {"SIZE": 128}),
    "bench_configs": (bench_configs, ["--quick"], {}),
}

#: The keys of each JAX bench's JSON line on a CPU run (file:lines), its
#: metric and its unit (None where the unit is formatted at run time).
JAX_LINES = {
    "bench_roofline": (
        None, None,
        ("device", "datasheet_gbps", "datasheet_gsps_2B", "probes", "shape",
         "mb", "pallas_copy_br256", "xla_xor", "widen_narrow", "fir_mxu_br256",
         "fir_mxu_auto", "f32_scale", "gsps", "gbps", "elapsed_s",
         "hlo_fullsize_copies_in_loop")),  # bench_roofline.py:91-164
    "bench": (
        "fixed5_fir_msps_per_chip", "Msamples/s/chip",
        ("metric", "value", "unit", "vs_baseline", "backend", "workload",
         "device", "reference_msps", "sol_msps", "sol_fraction", "wall_msps",
         "wall_fraction", "runs_msps", "bit_exact_vs_golden",
         "large_workload", "large_msps", "large_sol_fraction",
         "large_wall_fraction", "large_runs_msps")),  # bench.py:127-267
    "bench_taps": (
        "fixed_fir_tap_sweep",
        "Msamples/s/chip at 63 taps (bit-exact gated)",
        ("metric", "value", "unit", "vs_baseline", "per_taps_msps",
         "details", "bit_exact", "msps", "workload", "backend",
         "elapsed_s")),  # bench_taps.py:60-90
    "bench_streaming": (
        "streaming_checkpoint_sustained",
        "Msamples/s sustained (on-device scan)",
        ("metric", "value", "unit", "vs_baseline", "total_samples", "blocks",
         "block_shape", "scan_mode", "resume_checksums_match",
         "resume_state_match", "stitch_bit_exact",
         "scan_vs_blockwise_checksums_match", "backend",
         "elapsed_s")),  # bench_streaming.py:152-172
    "bench_2d": (
        "fixed2d_5x5_msps_per_chip", "Msamples/s/chip",
        ("metric", "value", "unit", "vs_baseline", "backend", "workload",
         "device", "sol_mem_msps", "sol_mxu_band_msps", "sol_fraction",
         "bit_exact_vs_golden", "runs_msps")),  # bench_2d.py:150-166
    "bench_configs": (
        "baseline_configs_pass", "of 5 configs",
        ("metric", "value", "unit", "vs_baseline", "elapsed_s", "configs",
         "config1_3tap_1k_bitexact", "pass", "config2_5tap_1M_snr", "snr_db",
         "samples", "config3_fir2d_512", "bit_exact_vs_golden",
         "rmse_vs_model", "config4_fft63_sharded", "devices", "shape",
         "sharded_dryrun_snr_db", "config5_full_chain", "message_corr",
         "out_shape", "chain_msps", "chain_backend", "chain_kernel",
         "chain_shape", "stages_msps", "stages_seconds", "bottleneck_stage",
         "chain_sol_fraction", "staged_over_fused_bytes",
         "stage_sum_seconds", "chain_seconds")),  # bench_configs.py:36-455
}
#: Keys the JAX benches print only on their accelerator at full size; the
#: port prints them only on the card, so its module must name them.
CARD_ONLY = {"bench_configs": ("msps", "chain_f32_wall_fraction",
                               "chain_bf16_mode", "snr_vs_f32_chain_db")}


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


def run_main(module, argv, sizes=None) -> tuple[int, dict]:
    """``module.main(argv + --device cpu)`` with the module constants of
    ``sizes`` patched for the run: its exit code and the last line of its
    stdout, parsed."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (sizes or {}).items():
            assert hasattr(module, name), name
            mp.setattr(module, name, value)
        with contextlib.redirect_stdout(out):
            rc = module.main([*argv, "--device", "cpu"])
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def lines():
    """Every bench's tiny CPU run, once."""
    return {name: run_main(*run) for name, run in RUNS.items()}


def all_keys(value) -> set:
    """Every key of a JSON value's dicts, at any depth."""
    if isinstance(value, dict):
        return set(value) | {k for v in value.values() for k in all_keys(v)}
    if isinstance(value, list):
        return {k for v in value for k in all_keys(v)}
    return set()


def string_constants(path: Path) -> set:
    return {node.value for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Constant) and isinstance(node.value, str)}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_bench_runs_with_every_gate_true(lines, name):
    rc, line = lines[name]
    assert rc == 0, line
    assert "error" not in line
    assert line["device"].startswith("cpu") and line["card"] is None
    if name in ("bench", "bench_2d"):
        assert line["bit_exact_vs_golden"] is True
    if name == "bench":
        assert line["large_bit_exact_vs_golden"] is True
        assert line["reference_msps"] == 0.57
        assert "host CPU" in line["reference_source"]
    if name == "bench_taps":
        assert set(line["per_taps_msps"]) == {"5", "63", "300"}
        assert all(d["bit_exact"] for d in line["details"].values())
        assert line["details"]["300"]["kernel"].startswith("fir_window")
    if name == "bench_streaming":
        assert all(line[gate] is True for gate in bench_streaming.GATES)
    if name == "bench_configs":
        assert line["value"] == 5 and line["vs_baseline"] == 1.0
        assert all(e["pass"] for e in line["configs"].values())
        config4 = line["configs"]["config4_fft63_sharded"]
        assert config4["sharded_dryrun_ranks"] == 8
        assert config4["sharded_dryrun_snr_db"] > 70
    if name == "bench_roofline":
        probes = line["probes"]["1MB"]
        assert {"copy_rows", "torch_copy", "xor", "widen_narrow", "fir_band",
                "f32_scale"} <= set(probes)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_line_carries_the_jax_keys(lines, name):
    metric, unit, keys = JAX_LINES[name]
    jax_file = REPO_ROOT / f"{name}.py"
    module = RUNS[name][0]
    _, line = lines[name]
    constants = string_constants(jax_file)
    # A key formatted at run time (pallas_copy_br{br}) by its prefix.
    assert all(key in constants or key.rstrip("0123456789") in constants
               for key in keys), "the list drifted from the JAX bench"
    if metric is not None:
        assert line["metric"] == metric and line["unit"] == unit
    present = all_keys(line)
    for key in keys:
        if key in module.DROPPED:
            assert key not in present and len(module.DROPPED[key]) > 10
        elif key in module.RENAMED:
            assert module.RENAMED[key] in present, key
        else:
            assert key in present, key
    own = string_constants(Path(module.__file__))
    assert set(CARD_ONLY.get(name, ())) <= own


def test_roofline_sizes_match_the_jax_harness():
    assert [bench_roofline.batch_rows(mb) for mb in (40, 160, 640)] == [
        5120, 20480, 81920]
    assert bench_roofline.batch_rows(1) == 128


@pytest.mark.parametrize("block", [0, 1, 2, 125, 126, 251, 10_000])
def test_stream_source_matches_bench_streaming(block):
    """``bench_streaming.py:77-84``'s blocks, computed with jnp as there."""
    channels, width = 4, 300
    noise = jnp.asarray(np.random.default_rng(0x5EED).integers(
        0, 256, size=(channels, width), dtype=np.uint8))
    b = jnp.int32(block)
    s = b.astype(jnp.uint32) * jnp.uint32(2654435761)
    s = (s ^ (s >> 13)) * jnp.uint32(1274126177)
    tweak = ((s >> 8) & jnp.uint32(255)).astype(jnp.uint8)
    want = np.asarray(noise ^ tweak)
    got = bench_streaming.stream_source(channels, width, CPU)(block)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quick_stream_block_takes_the_windows():
    """``--quick``'s block is lane-aligned, so that the scan takes kernel
    D's windows at 16 channels as the full block does."""
    for block in (bench_streaming.QUICK_BLOCK, bench_streaming.BLOCK):
        assert block % 128 == 0
        assert bench_streaming.pick_window_split(
            bench_streaming.CHANNELS, block, 5) is not None


def test_stitch_needs_two_blocks_before_the_resume_point():
    h = np.asarray(bench_streaming.FILTER_BANK_5TAP["sharpen"])
    block_fn = bench_streaming.stream_source(2, 256, CPU)
    with pytest.raises(ValueError, match="half >= 2"):
        bench_streaming.stitch(h, bench_streaming.QFormat(), 2, 256, 1,
                               block_fn, CPU)


@pytest.mark.parametrize("device, want", [("cpu", 1e-6), ("cuda", None)])
def test_a_non_positive_slope_raises_on_the_card(device, want):
    """A slope of 0 reads the floor on the CPU and raises on the card."""
    from warmup_fir_filter_tpu_torch.benches import _common

    assert _common.slope_seconds(2e-3, torch.device(device), 1e-6) == 2e-3
    if want is None:
        with pytest.raises(RuntimeError, match="non-positive time"):
            _common.slope_seconds(0.0, torch.device(device), 1e-6)
    else:
        assert _common.slope_seconds(0.0, torch.device(device), 1e-6) == want


def _flip_one_byte(plain):
    def flipped(*args, **kwargs):
        out = plain(*args, **kwargs).clone()
        out.view(-1)[0] ^= 1
        return out

    return flipped


@pytest.mark.parametrize("name", ["bench", "bench_taps", "bench_configs"])
def test_a_flipped_band_byte_fails_the_bench(monkeypatch, name):
    """Kernel A's plain version off by one byte: no fallback, exit 1."""
    monkeypatch.setattr(fir_band, "fir_band_plain",
                        _flip_one_byte(fir_band.fir_band_plain))
    # The dry run's ranks are processes of their own, untouched by the
    # patch; its SNR is not what this test is about.
    monkeypatch.setattr(bench_configs, "config4_dryrun_snr", lambda: 140.0)
    rc, line = run_main(*RUNS[name])
    assert rc == 1 and "error" in line
    if name == "bench_configs":
        assert "config1_3tap_1k_bitexact" in line["error"]
        assert line["configs"]["config1_3tap_1k_bitexact"]["pass"] is False
    else:
        assert "not bit-exact" in line["error"] and line["value"] == 0.0


def test_a_flipped_frame_byte_fails_bench_2d(monkeypatch):
    """Kernel F's plain version off by one byte of the image (its first
    sample, lane ``left`` of the frame's second tile): exit 1."""
    plain = fir2d.fir2d_oframe_plain

    def flipped(x_ext, fir, core):
        out = plain(x_ext, fir, core).clone()
        out[core[0], 128 + fir.taps[1] - 1 - fir.taps[1] // 2] ^= 1
        return out

    monkeypatch.setattr(fir2d, "fir2d_oframe_plain", flipped)
    rc, line = run_main(*RUNS["bench_2d"])
    assert rc == 1 and "fir2d_oframe is not bit-exact" in line["error"]


def test_missing_card_is_an_error_line():
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(bench, "BATCH", 8)
        mp.setattr(bench, "WIDTH", 64)
        rc = bench.main([])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    assert rc == 1 and "torch.cuda.is_available() is False" in line["error"]
    assert line["metric"] == "fixed5_fir_msps_per_chip"


def test_configs_1_to_3_match_the_jax_bench():
    """The JAX bench's own functions (Pallas in interpret mode) and the
    port's at the same seeds; config 2 at a 64th of its stream."""
    jax_results, port_results = {}, {}
    jax_bench_configs.config1_bit_compare(jax_results)
    jax_bench_configs.config2_stream_snr(jax_results, 64)
    jax_bench_configs.config3_fir2d(jax_results)
    bench_configs.config1_bit_compare(port_results, CPU)
    bench_configs.config2_stream_snr(port_results, 64, CPU)
    bench_configs.config3_fir2d(port_results, CPU)
    assert port_results == jax_results
    assert all(e["pass"] for e in port_results.values())
