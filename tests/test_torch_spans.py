"""The port's spans (``utils/profiling.py::span``) on the CPU.

- The gate: every kind of profiler session turns a span into a
  ``record_function`` range; with none active, ``span`` returns one shared
  ``nullcontext`` (this fails if a torch upgrade stops the check from seeing
  an active profiler).
- Each path opens its spans, once each, under ``torch.profiler``: one
  ``fir.prepare`` a preparing call of the fixed entries; N ``stream.block``
  spans for N blocks of ``stream_scanned``, each holding one
  ``stream.checksum``, and one ``fir.prepare`` a stream, not a call; one
  ``halo.post`` and one ``halo.attach`` an exchange, in a two-rank gloo
  world.
- With no profiler, ``torch.profiler.record_function`` is never made (it is
  patched to raise), and the outputs equal the profiled ones bit for bit.
"""

import json
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch
import torch.profiler

import test_torch_parallel_worker as worker
from test_torch_dispatch import BLOCK_JAX
from warmup_fir_filter_tpu_torch.kernels.dispatch import fir1d_fixed_rows_auto
from warmup_fir_filter_tpu_torch.kernels.fir_band import fir1d_fixed_rows_mxu
from warmup_fir_filter_tpu_torch.kernels.fir_direct import (
    fir1d_fixed_rows_pallas,
    fir_direct,
)
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.ops.resample import design_lowpass
from warmup_fir_filter_tpu_torch.ops.streaming import (
    Fir1DStream,
    stream_scanned,
)
from warmup_fir_filter_tpu_torch.parallel.halo import PendingHalo, _attach
from warmup_fir_filter_tpu_torch.utils import profiling
from warmup_fir_filter_tpu_torch.utils.profiling import span

SHARPEN5 = np.array([-0.25, -0.5, 2.5, -0.5, -0.25])
SPAN_NAMES = ("fir.prepare", "stream.block", "stream.checksum", "halo.post",
              "halo.attach")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Refused:
    def __init__(self, *args, **kwargs):
        raise AssertionError("record_function made with no profiler active")


def profiled(fn):
    """``fn()`` under a CPU ``torch.profiler`` session: its result and the
    port's spans as ``(name, start_us, end_us)``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name in SPAN_NAMES]
    return out, spans


def unprofiled(fn, monkeypatch):
    """``fn()`` with ``record_function`` refusing to be made."""
    with monkeypatch.context() as patch:
        patch.setattr(torch.profiler, "record_function", _Refused)
        return fn()


def equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return np.array_equal(a, b)


@pytest.mark.parametrize("session", ["torch.profiler", "autograd", "trace"])
def test_span_is_a_range_under_every_profiler(session, tmp_path):
    sessions = {
        "torch.profiler": lambda: torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]),
        "autograd": lambda: torch.autograd.profiler.profile(),
        "trace": lambda: profiling.trace(str(tmp_path)),
    }
    with sessions[session]():
        inside = span("fir.prepare")
        with inside:
            torch.ones(2).add_(1)
    assert isinstance(inside, torch.profiler.record_function)
    assert span("fir.prepare") is span("halo.post") is profiling._NO_SPAN


@pytest.mark.parametrize("entry, num_taps", [
    (fir1d_fixed_rows_auto, 5), (fir1d_fixed_rows_auto, 63),
    (fir1d_fixed_rows_auto, 300), (fir1d_fixed_rows_auto, 4097),
    (fir1d_fixed_rows_mxu, 5), (fir1d_fixed_rows_mxu, 63),
    (fir_direct, 5), (fir_direct, 40), (fir1d_fixed_rows_pallas, 5),
], ids=lambda v: getattr(v, "__name__", str(v)))
def test_fixed_entries_prepare_in_one_span_a_call(entry, num_taps,
                                                  monkeypatch):
    rng = np.random.default_rng(num_taps)
    x = torch.from_numpy(rng.integers(0, 256, (3, 77), dtype=np.uint8))
    h = SHARPEN5 if num_taps == 5 else design_lowpass(num_taps, 0.25)
    calls = 3

    def run():
        return [entry(x, h, QFormat()) for _ in range(calls)]

    want = unprofiled(run, monkeypatch)
    got, spans = profiled(run)
    assert [name for name, _, _ in spans] == ["fir.prepare"] * calls
    assert all(equal(a, b) for a, b in zip(got, want))


def _emit_sum(y):
    return y.to(torch.int64).sum()


@pytest.mark.parametrize("route", ["plain", "windowed", "emit"])
def test_stream_block_spans_hold_one_checksum_each(route, monkeypatch):
    channels, width, blocks = 16, 4096, 5
    noise = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (channels, width), dtype=np.uint8))
    kwargs = {"windowed": {"rows_split": "pallas"},
              "emit": {"emit_fn": _emit_sum}}.get(route, {})

    def run():
        stream = Fir1DStream(SHARPEN5, channels, QFormat(), "cpu")
        return [(stream_scanned(stream, lambda b: noise ^ (b & 255), blocks,
                                start_block=start, **kwargs),
                 stream.state.carry.copy()) for start in (0, blocks)]

    want = unprofiled(run, monkeypatch)
    got, spans = profiled(run)
    counts = Counter(name for name, _, _ in spans)
    # The windowed step runs kernel A's plain version: the stream prepares
    # its filter once, for both calls.
    assert counts == Counter({"stream.block": 2 * blocks,
                              "stream.checksum": 2 * blocks,
                              "fir.prepare": int(route == "windowed")})
    block_spans = [(lo, hi) for name, lo, hi in spans
                   if name == "stream.block"]
    for lo, hi in block_spans:
        assert sum(1 for name, c_lo, c_hi in spans
                   if name == "stream.checksum"
                   and lo <= c_lo and c_hi <= hi) == 1
    for (sums, carry), (want_sums, want_carry) in zip(got, want):
        assert np.array_equal(sums, want_sums)
        assert np.array_equal(carry, want_carry)


def test_attach_opens_one_span(monkeypatch):
    x = torch.arange(12, dtype=torch.uint8).reshape(2, 6)
    pending = PendingHalo(torch.ones(2, 2, dtype=torch.uint8), None, [], [])

    def run():
        return _attach(pending, x, 1)

    want = unprofiled(run, monkeypatch)
    got, spans = profiled(run)
    assert [name for name, _, _ in spans] == ["halo.attach"]
    assert torch.equal(got, want) and got.shape == (2, 8)


#: One rank of a two-rank gloo world: the exchange with ``record_function``
#: refusing to be made, then under the profiler; prints its counts.
RANK = """
import json, sys
from collections import Counter
import torch, torch.profiler
from warmup_fir_filter_tpu_torch.parallel import initialize_multihost, make_mesh
from warmup_fir_filter_tpu_torch.parallel.halo import exchange_halo_1d
rank, port = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
initialize_multihost(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=rank, device="cpu")
mesh = make_mesh(MESH, device_type="cpu")
x = (torch.arange(3 * 16, dtype=torch.int64).reshape(3, 16) * 7
     + 100 * rank).to(torch.uint8)
def run():
    return exchange_halo_1d(x, mesh=mesh, axis_name="time", left_width=4,
                            right_width=2)
class Refused:
    def __init__(self, *a, **k):
        raise AssertionError("record_function made with no profiler active")
made = torch.profiler.record_function
torch.profiler.record_function = Refused
want = run()
torch.profiler.record_function = made
with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    got = run()
counts = Counter(e.name for e in prof.events())
print("RESULT " + json.dumps({"post": counts["halo.post"],
                              "attach": counts["halo.attach"],
                              "equal": torch.equal(got, want),
                              "shape": list(got.shape)}), flush=True)
torch.distributed.destroy_process_group()
"""


def test_halo_exchange_opens_one_post_and_one_attach():
    port = worker.free_port()
    code = BLOCK_JAX + f"MESH = {worker.MESHES['time2']!r}\n" + RANK
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(rank), str(port)],
        cwd=worker.REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        logs = [proc.communicate(timeout=120)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log
        line = [ln for ln in log.splitlines() if ln.startswith("RESULT ")]
        assert json.loads(line[-1][len("RESULT "):]) == {
            "post": 1, "attach": 1, "equal": True, "shape": [3, 22]}
