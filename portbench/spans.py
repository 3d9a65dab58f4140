"""What the port's own spans hold, for the per-layer readers that read them.

The port opens named ``record_function`` ranges only while a profiler runs
(``warmup_fir_filter_tpu_torch/utils/profiling.py::span``), so a ``--trace
1`` stretch holds them beside the harness's ``portbench.*`` spans:

- ``fir.prepare``: a 1-D fixed filter's preparation (quantize, digit and
  band planes, uploads);
- ``stream.block``: one block of ``stream_scanned`` once the block is in
  hand (the step and the checksums), and ``stream.checksum`` inside it;
- ``halo.post``: posting the halo exchange; ``halo.attach``: the
  halo-extended copy.

A program without a span (an older commit) leaves its readers nothing to
read: each helper here returns None, and the result line leaves the metric
out.  Everything is read through :class:`portbench.trace.Trace`.  Host
spans and launches share the host's clock; where a reader sets host spans
against device time (``prepare_idle``), it takes each device operation to
start no earlier than its launch (:func:`device_after_launch`).
"""

from __future__ import annotations

import dataclasses

from portbench.trace import Event, Trace, busy_intervals

PREPARE = "fir.prepare"
BLOCK = "stream.block"
CHECKSUM = "stream.checksum"
HALO_POST = "halo.post"
HALO_ATTACH = "halo.attach"


def in_stretch(trace: Trace, name: str) -> list[Event]:
    """The spans ``name`` that start inside the stretch, cut at its end."""
    s = trace.stretch()
    if s is None:
        return []
    return [dataclasses.replace(e, dur=min(e.end, s.end) - e.ts)
            for e in trace.spans(name) if s.ts <= e.ts < s.end]


def host_ms(run, name: str, per_call: int = 1) -> float | None:
    """The summed length of the stretch's spans ``name``, in milliseconds,
    over the traced calls times ``per_call``; None without a trace, a
    call or such a span."""
    trace = run.trace
    if trace is None or trace.calls() == 0:
        return None
    spans = in_stretch(trace, name)
    if not spans:
        return None
    return sum(e.dur for e in spans) * 1e-3 / (trace.calls() * per_call)


def device_ms(run, name: str, per_call: int = 1) -> float | None:
    """The device time in the stretch of the operations launched inside
    spans ``name`` (by correlation id), in milliseconds, over the traced
    calls times ``per_call``; None without a trace, a call or such a
    span."""
    trace = run.trace
    if trace is None or trace.calls() == 0 or not in_stretch(trace, name):
        return None
    inside = trace.launched_inside(name)
    us = sum(e.dur for e in trace.device_in_stretch() if e.corr in inside)
    return us * 1e-3 / (trace.calls() * per_call)


def overlap_us(a: list[tuple[float, float]],
               b: list[tuple[float, float]]) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_after_launch(trace: Trace) -> list[Event]:
    """The device operations in the stretch, clipped to it, each first
    moved, where its timestamp says otherwise, to start no earlier than the
    host call that launched it (by correlation id).  Early in a stretch the
    card's timestamps can run behind the host's by up to milliseconds while
    the profiler's alignment of the two clocks settles; where the clocks
    agree, nothing moves."""
    s = trace.stretch()
    if s is None:
        return []
    launched = {e.corr: e.ts for e in trace.launches if e.corr is not None}
    out = []
    for e in trace.device:
        start = max(e.ts, launched.get(e.corr, e.ts))
        lo, hi = max(start, s.ts), min(start + e.dur, s.end)
        if hi > lo:
            out.append(dataclasses.replace(e, ts=lo, dur=hi - lo))
    return out


def idle_intervals(trace: Trace) -> list[tuple[float, float]]:
    """The stretch's intervals in which the device ran nothing, on the
    host's clock (:func:`device_after_launch`)."""
    s = trace.stretch()
    if s is None:
        return []
    gaps, edge = [], s.ts
    busy = busy_intervals(device_after_launch(trace))
    for lo, hi in busy + [(s.end, s.end)]:
        if lo > edge:
            gaps.append((edge, lo))
        edge = max(edge, hi)
    return gaps


def idle_share_inside(run, name: str) -> float | None:
    """The share of the stretch, in %, in which the device ran nothing and
    the host was inside a span ``name``; None without a trace, a call or
    such a span."""
    trace = run.trace
    if trace is None or trace.calls() == 0:
        return None
    s = trace.stretch()
    spans = in_stretch(trace, name)
    if s is None or s.dur <= 0 or not spans:
        return None
    inside = busy_intervals(spans)
    return 100.0 * overlap_us(idle_intervals(trace), inside) / s.dur
