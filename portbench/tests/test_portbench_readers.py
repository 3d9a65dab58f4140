"""Every reader on a small canned trace, against numbers worked out by
hand, and the Chrome-trace parsing they rest on."""

import pytest

from portbench import harness, trace
from portbench.common import BENCH_DIR, load_json

HOST = {"pid": 1, "tid": 1}


def span(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, **HOST}


def launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 3, "args": {"correlation": corr}, **HOST}


def op(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


CANNED = {"traceEvents": [
    span(trace.STRETCH, 0, 1000),
    span(trace.CALL, 10, 390),
    span(trace.CALL, 500, 400),
    span(trace.SOURCE, 520, 20),
    span("aten::copy_", 400, 90, cat="cpu_op"),
    launch(20, 1), launch(30, 2), launch(525, 3), launch(600, 4),
    launch(610, 5), launch(620, 6), launch(630, 7), launch(640, 8),
    op("void (anonymous namespace)::fir_band_short_kernel<5>(x)", 100, 200, 1),
    op("elementwise_kernel<add>", 300, 50, 2),
    op("BitwiseXorFunctor", 560, 10, 3),
    op("fir_band_planes_kernel<3>", 650, 100, 4),
    op("(anonymous namespace)::window_rows_kernel(a)", 760, 20, 5),
    op("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)", 790, 40, 6),
    op("Memcpy DtoH (Device -> Pageable)", 850, 10, 7, cat="gpu_memcpy"),
    op("osfilt_stream_kernel<9>", 870, 100, 8),
    op("outside the stretch", 1200, 50, 9),
    {"ph": "i", "cat": "kernel", "name": "an instant", "ts": 5},
]}
# Device time in the stretch: [100, 350] 250, 10, 100, 20, 40, 10, 100.
BUSY_US = 530


def run_of(cell_name="sharpen5.rows", work=None):
    cell = harness.load_cell(cell_name, seeds=[1], seconds=1.0, trace=True)
    window = harness.Window(calls=2, seconds=1.0, latencies=[0.1] * 25,
                            traced=[False] * 25, setup_s=3.0)
    return harness.Run(cell, window, trace.parse_chrome_trace(CANNED),
                       work or {"samples_per_call": 10**9,
                                "blocks_per_call": 4, "channels": 16,
                                "local_time": 2_500_000})


def read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_parse_sorts_events_by_kind():
    parsed = trace.parse_chrome_trace(CANNED)
    assert len(parsed.device) == 9
    assert len(parsed.launches) == 8
    assert parsed.calls() == 2
    assert parsed.stretch().dur == 1000


def test_dispatch_host_ms():
    assert read("dispatch_host_ms", run_of()) == pytest.approx(0.395)


def test_fir_band_roofline():
    run = run_of()
    config = load_json(BENCH_DIR / "configs" / "fir1d_q412_sharpen5.json")
    least = 2.0 * 10**9 / 3.35e12  # the bytes bound of a call
    assert harness.load_module("metrics", "fir_band_roofline") \
        .least_seconds_per_call(config, 10**9) == pytest.approx(least)
    # Two calls' least time over A's 300 us.
    assert read("fir_band_roofline", run) == pytest.approx(
        100 * least * 2 / 300e-6)


def test_stream_glue_ms():
    # Inside the calls, not A, D or the source: the add (50), NCCL (40),
    # the copy (10) and kernel M (100): 200 us over 2 calls of 4 blocks.
    assert read("stream_glue_ms", run_of("sharpen5.stream")) == \
        pytest.approx(0.2 / 8)


def test_halo_nccl_ms():
    assert read("halo_nccl_ms", run_of("os63.sharded4")) == \
        pytest.approx(0.02)


def test_halo_nccl_ms_leaves_out_what_the_calls_did_not_launch():
    # A broadcast launched between the calls (at 950) is no halo exchange.
    data = {"traceEvents": CANNED["traceEvents"] + [
        launch(950, 10), op("ncclDevKernel_Broadcast_RING_LL(x)", 960, 30, 10)]}
    run = run_of("os63.sharded4")
    run.trace = trace.parse_chrome_trace(data)
    assert read("halo_nccl_ms", run) == pytest.approx(0.02)


def test_osfilt_stream_roofline():
    run = run_of("os63.sharded4")
    least = 8.0 * 16 * 2_500_000 / 3.35e12
    assert read("osfilt_stream_roofline", run) == pytest.approx(
        100 * least * 2 / 100e-6)


def test_device_idle_and_busy():
    run = run_of()
    assert read("device_idle", run) == pytest.approx(100 * (1 - BUSY_US / 1000))
    busy, window = trace.busy_and_window_s(run.trace)
    assert busy == pytest.approx(BUSY_US * 1e-6)
    assert window == pytest.approx(1e-3)


def test_sharded_cell_reads_its_metrics():
    run = run_of("os63.sharded4")
    assert set(harness.read_metrics(run)) == {
        "halo_nccl_ms", "osfilt_stream_roofline", "device_idle",
        "call_ms_p95"}


def test_call_ms_p95_and_end_to_end():
    run = run_of()
    run.window.latencies[-1] = 0.5
    run.window.traced[0] = True
    run.window.latencies[0] = 9.0  # traced: left out
    assert read("call_ms_p95", run) == pytest.approx(
        harness.p95([0.1] * 23 + [0.5]) * 1e3)
    e2e = harness.load_module("endtoend", "msps").read(run)
    assert e2e == pytest.approx(2 * 10**9 / 1.0 / 1e6)
    assert harness.load_module("endtoend", "setup_s").read(run) == 3.0


def test_readers_find_nothing_without_a_trace():
    run = run_of()
    run.trace = None
    for name in ("dispatch_host_ms", "fir_band_roofline", "stream_glue_ms",
                 "halo_nccl_ms", "osfilt_stream_roofline", "device_idle"):
        assert read(name, run) is None


def test_roofline_readers_find_nothing_without_their_kernel():
    run = run_of()
    run.trace.device = [e for e in run.trace.device
                        if "fir_band" not in e.name
                        and "osfilt" not in e.name and "nccl" not in e.name]
    for name in ("fir_band_roofline", "osfilt_stream_roofline",
                 "halo_nccl_ms"):
        assert read(name, run) is None


def test_breakdown_names_ops_and_gaps():
    out = trace.breakdown(trace.parse_chrome_trace(CANNED))
    names = [n for n, _ in out["device_ops"]]
    assert names[0].startswith("void (anonymous namespace)::fir_band_short")
    assert "outside the stretch" not in names
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10
    gaps = dict(out["idle_gaps"])
    # [350, 560) is the longest gap: its middle, 455, lies in the copy.
    assert gaps["host: aten::copy_"] == pytest.approx(210e-6)
    assert max(gaps.values()) == gaps["host: aten::copy_"]


def test_read_metrics_reports_the_cells_entries():
    run = run_of()
    got = harness.read_metrics(run)
    assert set(got) == {"dispatch_host_ms", "fir_band_roofline",
                        "device_idle", "call_ms_p95"}
    assert got["fir_band_roofline"]["unit"] == "%"
    run.cell.trace = False
    assert set(harness.read_metrics(run)) == {"msps", "setup_s"}
