"""The six readers of the port's own spans (``portbench/spans.py``) on small
hand-made traces, against numbers worked out by hand; their dry runs on the
host; and, on a card, the shared clock they rest on."""

import subprocess
import sys
import time

import pytest

from portbench import harness, spans, trace
from portbench.common import ROOT
from portbench.tests.test_portbench_card import need_cards

HOST = {"pid": 1, "tid": 1}
OTHER_THREAD = {"pid": 1, "tid": 2}
NEW = ("prepare_host_ms", "prepare_idle", "stream_block_host_ms",
       "stream_checksum_ms", "halo_post_host_ms", "halo_attach_ms")


def span(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, **HOST}


def launch(ts, corr, thread=HOST):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 3, "args": {"correlation": corr}, **thread}


def op(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def stretch_and_calls():
    return [span(trace.STRETCH, 0, 1000), span(trace.CALL, 10, 390),
            span(trace.CALL, 500, 400)]


ROWS = stretch_and_calls() + [
    # One preparation a call, the first with an upload inside it; one
    # outside the stretch, which no reader counts.
    span(spans.PREPARE, 20, 100), span(spans.PREPARE, 510, 50),
    span(spans.PREPARE, 1100, 100),
    launch(40, 3), launch(125, 1), launch(565, 2),
    op("Memcpy HtoD (Pageable -> Device)", 50, 20, 3, cat="gpu_memcpy"),
    op("fir_band_short_kernel<5>", 130, 220, 1),
    op("fir_band_short_kernel<5>", 600, 100, 2),
]
# Busy [50, 70), [130, 350) and [600, 700); the first preparation lies idle
# for 30 + 50 us of its 100 (the upload's 20 us are not idle), the second
# wholly: 50 us.


def shifted(events, us):
    """``events`` with the device's timestamps ``us`` earlier, as the card's
    clock reads early in some stretches."""
    return [dict(e, ts=e["ts"] - us) if e["cat"] in trace.DEVICE_CATS else e
            for e in events]

STREAM = stretch_and_calls() + [
    span(spans.BLOCK, 20, 100), span(spans.BLOCK, 150, 100),
    span(spans.BLOCK, 520, 80), span(spans.BLOCK, 620, 80),
    span(spans.CHECKSUM, 80, 35), span(spans.CHECKSUM, 200, 45),
    span(spans.CHECKSUM, 560, 35), span(spans.CHECKSUM, 660, 35),
    launch(30, 21), launch(90, 11), launch(210, 12), launch(570, 13),
    launch(670, 14),
    # A launch inside a checksum's time on another thread is not its own.
    launch(95, 15, thread=OTHER_THREAD),
    op("fir_band_short_kernel<5>", 130, 50, 21),
    op("reduce_kernel<short>", 200, 30, 11),
    op("reduce_kernel<long>", 300, 30, 12),
    op("elementwise_kernel<and>", 580, 20, 13),
    op("elementwise_kernel<mul>", 700, 20, 14),
    op("elementwise_kernel<other thread>", 750, 40, 15),
]

SHARDED = stretch_and_calls() + [
    span(spans.HALO_POST, 20, 50), span(spans.HALO_POST, 520, 20),
    span(spans.HALO_ATTACH, 300, 20), span(spans.HALO_ATTACH, 800, 30),
    launch(30, 41), launch(305, 31), launch(805, 32),
    op("ncclDevKernel_SendRecv(x)", 100, 150, 41),
    op("CatArrayBatchedCopy_aligned16", 320, 120, 31),
    op("CatArrayBatchedCopy_aligned16", 840, 124, 32),
]


def run_of(cell_name, events, blocks_per_call=2):
    cell = harness.load_cell(cell_name, seeds=[1], seconds=1.0, trace=True)
    window = harness.Window(calls=2, seconds=1.0, latencies=[0.1] * 25,
                            traced=[False] * 25, setup_s=3.0)
    return harness.Run(cell, window,
                       trace.parse_chrome_trace({"traceEvents": events}),
                       {"samples_per_call": 10**9,
                        "blocks_per_call": blocks_per_call, "channels": 16,
                        "local_time": 2_500_000})


def read(name, run):
    return harness.load_module("metrics", name).read(run)


@pytest.mark.parametrize("name, cell, events, want", [
    # (100 + 50) us of preparation over 2 calls.
    ("prepare_host_ms", "sharpen5.rows", ROWS, 0.075),
    # (80 + 50) us idle inside a preparation, of the stretch's 1000.
    ("prepare_idle", "lowpass63.rows", ROWS, 13.0),
    # The same when the card's timestamps run 200 us behind: each operation
    # starts at its launch at the earliest (the upload [40, 60), kernel A
    # [125, 345) and [565, 665)): 20 + 60 + 50 us.
    ("prepare_idle", "sharpen5.rows", shifted(ROWS, 200), 13.0),
    # 360 us of blocks over 2 calls of 2 blocks.
    ("stream_block_host_ms", "sharpen5.stream", STREAM, 0.09),
    # 30 + 30 + 20 + 20 us launched inside the checksums, over 4 blocks.
    ("stream_checksum_ms", "sharpen5.stream", STREAM, 0.025),
    # 70 us of posting over 2 calls.
    ("halo_post_host_ms", "os63.sharded4", SHARDED, 0.035),
    # The two copies' 244 us over 2 calls.
    ("halo_attach_ms", "os63.sharded4", SHARDED, 0.122),
])
def test_reader_on_a_hand_made_trace(name, cell, events, want):
    assert read(name, run_of(cell, events)) == pytest.approx(want)


def test_checksum_time_is_part_of_the_glue():
    run = run_of("sharpen5.stream", STREAM)
    assert read("stream_checksum_ms", run) <= read("stream_glue_ms", run)


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("case", ["no trace", "no span", "no call"])
def test_reader_reports_nothing_without_its_spans(name, case):
    """None without a trace, for a program that opens no such span (the
    parent's), and for a stretch without calls."""
    events = {"no trace": ROWS, "no span": stretch_and_calls(),
              "no call": [span(trace.STRETCH, 0, 1000)] + [
                  e for e in ROWS + STREAM + SHARDED
                  if e["name"] not in (trace.STRETCH, trace.CALL)]}[case]
    run = run_of("sharpen5.rows", events)
    if case == "no trace":
        run.trace = None
    assert read(name, run) is None


@pytest.mark.parametrize("name, events", [
    # Checksum spans that launched nothing.
    ("stream_checksum_ms", stretch_and_calls() + [
        span(spans.CHECKSUM, 80, 35)]),
    ("halo_attach_ms", stretch_and_calls() + [
        span(spans.HALO_ATTACH, 80, 35)]),
    # A preparation wholly inside the device's busy time.
    ("prepare_idle", stretch_and_calls() + [
        span(spans.PREPARE, 150, 100), launch(20, 1),
        op("fir_band_short_kernel<5>", 100, 250, 1)]),
])
def test_reader_reads_zero(name, events):
    assert read(name, run_of("sharpen5.stream", events)) == 0.0


def test_spans_are_cut_at_the_stretch():
    parsed = trace.parse_chrome_trace({"traceEvents": stretch_and_calls() + [
        span(spans.PREPARE, -50, 100), span(spans.PREPARE, 950, 100)]})
    assert [(e.ts, e.dur) for e in spans.in_stretch(parsed, spans.PREPARE)] \
        == [(950, 50)]


def test_overlap_of_interval_lists():
    assert spans.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap_us([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap_us([], [(0, 1)]) == 0


def test_cells_report_the_new_metrics_and_the_gap_is_named():
    rows = run_of("sharpen5.rows", ROWS)
    assert {"prepare_host_ms", "prepare_idle"} <= set(
        harness.read_metrics(rows))
    # The gap [70, 130) is the host inside its preparation, not the call.
    gaps = dict(trace.breakdown(rows.trace)["idle_gaps"])
    assert gaps[f"host: {spans.PREPARE}"] == pytest.approx(60e-6)
    stream = harness.read_metrics(run_of("sharpen5.stream", STREAM))
    assert {"stream_block_host_ms", "stream_checksum_ms"} <= set(stream)
    sharded = harness.read_metrics(run_of("os63.sharded4", SHARDED))
    assert {"halo_post_host_ms", "halo_attach_ms"} <= set(sharded)


@pytest.mark.parametrize("name, metric", [("sharpen5.rows", "prepare_host_ms"),
                                          ("sharpen5.stream",
                                           "stream_block_host_ms")])
def test_dry_traced_run_reads_the_ports_spans(name, metric):
    """A traced dry run reads the spans of the port's plain path.
    ``portbench/run.py`` prints no metric of a dry run, so the metrics are
    read from the driver's outcome; the command itself is run too."""
    cell = harness.load_cell(name, seeds=[2**33 + 9], seconds=0.3,
                             trace=True, dry=True, started=time.time())
    driver = harness.load_module("drivers", cell.traffic["driver"])
    outcome = driver.run_cell(cell)[0]
    assert outcome.correct, outcome.compared
    assert outcome.metrics[metric]["value"] > 0
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name,
         "--seed", str(2**33 + 9), "--seconds", "0.3", "--trace", "1",
         "--dry-cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert '"correct": true' in proc.stdout.strip().splitlines()[-1]


@pytest.mark.card
def test_kernel_a_starts_after_its_calls_preparation(monkeypatch):
    """The spans and the card's events share one clock: in a traced
    ``sharpen5.rows`` stretch each call's kernel A is launched after that
    call's ``fir.prepare`` span has ended (the span on the profiler's host
    clock, the launch on CUPTI's), and starts on the card after it on the
    clock the readers use.  The card's raw timestamps are not held to it:
    early in some stretches they run behind their launches by up to
    milliseconds while the profiler aligns the clocks, which is why
    ``device_after_launch`` exists."""
    need_cards(1)
    kept = {}
    read_metrics = harness.read_metrics

    def keep(run):
        kept["trace"] = run.trace
        return read_metrics(run)

    monkeypatch.setattr(harness, "read_metrics", keep)
    cell = harness.load_cell("sharpen5.rows", seeds=[2**32 + 17],
                             seconds=1.0, trace=True, started=time.time())
    harness.load_module("drivers", "rows").run_cell(cell)
    parsed = kept["trace"]
    kernels = {e.corr: e for e in spans.device_after_launch(parsed)
               if "fir_band" in e.name}
    calls = parsed.spans(trace.CALL)
    assert len(calls) >= 100
    for call in calls:
        prepares = [s for s in parsed.spans(spans.PREPARE)
                    if call.ts <= s.ts < call.end]
        launches = [e for e in parsed.launches
                    if e.tid == call.tid and call.ts <= e.ts < call.end
                    and e.corr in kernels]
        assert len(prepares) == 1 and len(launches) == 1
        assert launches[0].ts >= prepares[0].end
        assert kernels[launches[0].corr].ts >= prepares[0].end
