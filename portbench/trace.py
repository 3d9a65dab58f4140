"""The traced stretch of a window, read from ``torch.profiler``'s trace.

In a ``--trace 1`` run the window switches the profiler (CPU and CUDA
activities) on for a steady stretch of calls and off again; the stretch is
one ``portbench.stretch`` span, each call a ``portbench.call`` span, and
the harness's own work inside a call (the stream's block source) a
``portbench.source`` span.  The profiler's Chrome trace is read back into a
:class:`Trace`: the device operations (kernels, copies, sets) with their
correlation ids, the host launches with theirs, and the host spans.  The
per-layer readers take their numbers from it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from contextlib import nullcontext
from pathlib import Path

STRETCH = "portbench.stretch"
CALL = "portbench.call"
SOURCE = "portbench.source"
#: Chrome-trace categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Categories of the host's calls into the CUDA runtime and driver.
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: Categories of host spans: ``record_function`` ranges and torch ops.
HOST_CATS = ("user_annotation", "cpu_op")


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    cat: str
    ts: float  # microseconds
    dur: float
    tid: object = None
    corr: int | None = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class Trace:
    """What a stretch's trace holds, in microseconds of one clock."""

    device: list[Event]
    launches: list[Event]
    host: list[Event]

    def spans(self, name: str) -> list[Event]:
        return [e for e in self.host if e.name == name]

    def stretch(self) -> Event | None:
        spans = self.spans(STRETCH)
        return spans[0] if spans else None

    def calls(self) -> int:
        return len(self.spans(CALL))

    def device_in_stretch(self) -> list[Event]:
        """Device operations that overlap the stretch, clipped to it."""
        s = self.stretch()
        if s is None:
            return []
        out = []
        for e in self.device:
            lo, hi = max(e.ts, s.ts), min(e.end, s.end)
            if hi > lo:
                out.append(dataclasses.replace(e, ts=lo, dur=hi - lo))
        return out

    def launched_inside(self, span_name: str) -> set[int]:
        """Correlation ids of the launches made inside any span
        ``span_name`` on the span's own thread."""
        spans = self.spans(span_name)
        ids = set()
        for launch in self.launches:
            if launch.corr is None:
                continue
            for s in spans:
                if s.tid == launch.tid and s.ts <= launch.ts < s.end:
                    ids.add(launch.corr)
                    break
        return ids


def busy_intervals(events: list[Event]) -> list[tuple[float, float]]:
    """The union of the events' intervals, sorted and merged."""
    merged: list[list[float]] = []
    for e in sorted(events, key=lambda e: e.ts):
        if merged and e.ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e.end)
        else:
            merged.append([e.ts, e.end])
    return [(lo, hi) for lo, hi in merged]


def busy_and_window_s(trace: Trace) -> tuple[float, float] | None:
    """Seconds in which the device ran an operation during the stretch, and
    the stretch's length; None without a stretch."""
    s = trace.stretch()
    if s is None:
        return None
    busy = sum(hi - lo for lo, hi in busy_intervals(trace.device_in_stretch()))
    return busy * 1e-6, s.dur * 1e-6


def _int_or_none(value) -> int | None:
    try:
        return int(value)
    except (TypeError, ValueError):
        return None


def parse_chrome_trace(data: dict) -> Trace:
    """A :class:`Trace` from the profiler's Chrome-trace JSON."""
    device, launches, host = [], [], []
    for raw in data.get("traceEvents", []):
        if raw.get("ph") != "X":
            continue
        cat = str(raw.get("cat", "")).lower()
        args = raw.get("args") or {}
        event = Event(name=str(raw.get("name", "")), cat=cat,
                      ts=float(raw.get("ts", 0.0)),
                      dur=float(raw.get("dur", 0.0)),
                      tid=(raw.get("pid"), raw.get("tid")),
                      corr=_int_or_none(args.get("correlation")))
        if cat in DEVICE_CATS:
            device.append(event)
        elif cat in LAUNCH_CATS:
            launches.append(event)
        elif cat in HOST_CATS:
            host.append(event)
    return Trace(device=device, launches=launches, host=host)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the stretch, and the
    longest idle gaps named by the innermost host span that was open at
    each gap's middle (or ``"host: none"``)."""
    device = trace.device_in_stretch()
    totals: dict[str, float] = {}
    for e in device:
        totals[e.name] = totals.get(e.name, 0.0) + e.dur * 1e-6
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    s = trace.stretch()
    gaps = []
    if s is not None:
        edge = s.ts
        for lo, hi in busy_intervals(device) + [(s.end, s.end)]:
            if lo > edge:
                gaps.append((edge, lo))
            edge = max(edge, hi)
    named: dict[str, float] = {}
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[: 4 * top]
    for lo, hi in longest:
        mid = (lo + hi) / 2
        open_spans = [e for e in trace.host if e.ts <= mid < e.end
                      and e.name != STRETCH]
        name = (f"host: {min(open_spans, key=lambda e: e.dur).name}"
                if open_spans else "host: none")
        named[name] = max(named.get(name, 0.0), (hi - lo) * 1e-6)
    gap_list = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gap_list]}


class Tracer:
    """Switches the profiler on for ``count`` calls of a window, from the
    first call after ``after_s`` seconds of it, and reads the trace back.
    Does nothing when ``enabled`` is false."""

    def __init__(self, enabled: bool, count: int, *, cuda: bool,
                 after_s: float = 0.0):
        self.enabled = enabled
        self.count = count
        self.after_s = after_s
        self.cuda = cuda
        self.profiler = None
        self.traced = 0
        self.trace: Trace | None = None
        self._stretch = None

    @property
    def active(self) -> bool:
        return self.profiler is not None

    def warm_up(self) -> None:
        """Start and stop the profiler once, at set-up, so that its one-time
        start-up cost stays out of the window."""
        if not self.enabled:
            return
        import torch

        with torch.profiler.profile(activities=self._activities()):
            torch.zeros(1).add_(1)

    def _activities(self) -> list:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return activities

    def span(self, name: str):
        """A ``record_function`` span while tracing, else nothing."""
        if self.profiler is None:
            return nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def before_call(self, elapsed_s: float) -> None:
        if self.enabled and self.trace is None and self.profiler is None \
                and elapsed_s >= self.after_s:
            import torch

            self.profiler = torch.profiler.profile(
                activities=self._activities())
            self.profiler.start()
            self._stretch = torch.profiler.record_function(STRETCH)
            self._stretch.__enter__()

    def after_call(self) -> None:
        if self.profiler is None:
            return
        self.traced += 1
        if self.traced >= self.count:
            self.stop()

    def stop(self) -> None:
        """End the stretch (at the window's end if it is still open) and
        read its trace."""
        if self.profiler is None:
            return
        self._stretch.__exit__(None, None, None)
        self.profiler.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            self.profiler.export_chrome_trace(os.fspath(path))
            with open(path) as f:
                self.trace = parse_chrome_trace(json.load(f))
        self.profiler = None
