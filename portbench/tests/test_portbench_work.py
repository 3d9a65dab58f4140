"""The work the roofline metrics count: kernel A's bytes and operations for
both fixed configurations, and kernel M's for the sharded one."""

import math

import pytest

from portbench import roofline
from portbench.common import BENCH_DIR, load_json
from portbench.harness import load_module

ROWS_SAMPLES = 81_920 * 8_192


def config(name):
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


@pytest.mark.parametrize("name, nonzero", [("fir1d_q412_sharpen5", 5),
                                           ("fir1d_q412_lowpass63", 49)])
def test_fir_band_least_time_is_the_bytes_of_the_fir(name, nonzero):
    reader = load_module("metrics", "fir_band_roofline")
    least = reader.least_seconds_per_call(config(name), ROWS_SAMPLES)
    by_bytes = 2.0 * ROWS_SAMPLES / 3.35e12
    by_ops = 2.0 * nonzero * ROWS_SAMPLES / 1979e12
    assert by_ops < by_bytes
    assert least == pytest.approx(by_bytes)
    # 0.4006 ms: PERF.md's bound of 81,920 rows of 8,192 bytes.
    assert least * 1e3 == pytest.approx(0.40065, abs=1e-5)


def test_fir_band_operations_count_nonzero_taps():
    # A filter held by its operations, not its bytes: 4,000 taps of which
    # the zeros (every other one) cost nothing.
    taps = [0.01, 0.0] * 2000
    long = dict(config("fir1d_q412_lowpass63"), taps=taps)
    reader = load_module("metrics", "fir_band_roofline")
    least = reader.least_seconds_per_call(long, 1000)
    assert least == pytest.approx(2.0 * 2000 * 1000 / 1979e12)


def test_osfilt_stream_count_per_rank():
    reader = load_module("metrics", "osfilt_stream_roofline")
    local = 10_000_000 // 4
    hop = 512 - 63 + 1
    windows = 16 * math.ceil(local / hop)
    assert windows == 16 * 5556
    ops = windows * (5 * 512 * 9 + 3 * 512)
    nbytes = 8.0 * 16 * local
    least = reader.least_seconds_per_call(16, local, 63)
    assert least == pytest.approx(max(nbytes / 3.35e12, ops / 67e12))
    assert least * 1e3 == pytest.approx(0.095522, abs=1e-6)  # bytes bound


def test_peaks_are_the_data_sheets():
    assert roofline.PEAK_BYTES_PER_S == 3.35e12
    assert roofline.PEAK_OPS_PER_S["int8"] == 1979e12
    assert roofline.PEAK_OPS_PER_S["f32"] == 67e12
    assert roofline.fft_ops(512) == 5 * 512 * 9
