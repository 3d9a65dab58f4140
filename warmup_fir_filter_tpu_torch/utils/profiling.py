"""Tracing and stage timing: ``trace``, ``span`` and the ``[OK] ...`` status
line.

- :func:`trace` — the counterpart of the JAX package's
  (``warmup_fir_filter_tpu/utils/profiling.py:23-44``) on
  ``torch.profiler``: host events, and the card's kernels and copies when
  CUDA is present, written for TensorBoard as ``*.pt.trace.json`` (a
  Chrome trace) into the directory; it never raises when the profiler
  cannot start, and then prints one ``[WARN]`` line;
- :func:`span` — a named ``torch.profiler.record_function`` range while a
  profiler is active (``trace``, the CLI's ``--profile``, or any
  ``torch.profiler`` session of the caller's), else one shared
  ``nullcontext``: with no profiler a span costs a flag read.  Any trace
  of the port shows these five spans:

  - ``fir.prepare``: a 1-D fixed filter quantized, its digit and band
    planes built and its buffers uploaded
    (``kernels/dispatch.py::prepare_fixed_fir``, and the preparation inside
    ``kernels/fir_band.py::fir1d_fixed_rows_mxu`` and
    ``kernels/fir_direct.py::fir_direct``);
  - ``stream.block``: one block of ``ops/streaming.py::stream_scanned``
    once the caller's ``block_fn`` has returned it: the step and the
    block's checksums or emit;
  - ``stream.checksum``: inside ``stream.block``, the block's checksums
    (column sums, weighted sums, the write into the sums) or its emit;
  - ``halo.post``: ``parallel/halo.py::post_halo``, the zeroed receive
    buffers, the contiguous sends and ``batch_isend_irecv``;
  - ``halo.attach``: ``parallel/halo.py::_attach``, the halo-extended
    ``torch.cat``;
- :class:`StageTimer` — a copy of the JAX package's
  (``warmup_fir_filter_tpu/utils/profiling.py:47-107``), except that
  ``sol_msps`` defaults to ``None``: the JAX package's default speed of
  light is a figure for its TPU, so the port reports no roofline fraction
  unless a caller passes one measured for its own card.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import torch
import torch.autograd.profiler

#: What :func:`span` returns while no profiler is active.
_NO_SPAN = nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler is active, else a shared
    ``nullcontext``.  The check reads the flag that every
    ``torch.profiler``/``torch.autograd.profiler`` session sets on start
    and clears on stop."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextmanager
def trace(log_dir: str, *, enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the enclosed region (best
    effort): CPU activity, plus CUDA's when CUDA is available; the card is
    synchronized before the profiler stops, so every launch of the region
    is in the trace.  ``enabled=False`` never starts the profiler."""
    if not enabled:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    profiler = None
    try:
        profiler = profile(activities=activities,
                           on_trace_ready=tensorboard_trace_handler(
                               str(log_dir)))
        profiler.start()
    except Exception as exc:  # profiling unavailable: run untraced
        profiler = None
        print(f"[WARN] trace not started in {log_dir}: {exc!r}")
    try:
        yield
    finally:
        if profiler is not None:
            try:
                if cuda:  # a device fault raises here, not in the profiler
                    torch.cuda.synchronize()
            finally:
                try:
                    profiler.stop()
                except Exception as exc:
                    print(f"[WARN] trace not written to {log_dir}: {exc!r}")


class StageTimer:
    """Wall-clock + throughput accounting for a processing stage.

    Used as the status-line emitter of pipeline stages 2/3 (``stages.py``):
    carries arbitrary ``counts`` (generated/skipped/...), accumulates
    processed sample counts, and prints the reference-shaped structured
    line extended with achieved Msamples/s and (when ``sol_msps`` is set)
    the roofline fraction.  On exception a ``[FAIL]`` line is printed and
    the exception propagates (the reference's fail-fast contract,
    ``pipeline_fir_1d.py:232-241``).
    """

    def __init__(self, name: str, *, sol_msps: float | None = None,
                 **counts: int):
        self.name = name
        self.sol_msps = sol_msps
        self.samples = 0
        self.counts: dict = dict(counts)
        self._elapsed = 0.0
        self._start: float | None = None

    def __enter__(self) -> "StageTimer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        assert self._start is not None
        self._elapsed += time.perf_counter() - self._start
        self._start = None
        if exc_type is None:
            print(self.status_line())
        else:
            print(self.status_line(ok=False, error=str(exc)))

    def __getitem__(self, key: str) -> int:
        return self.counts[key]

    def __setitem__(self, key: str, value: int) -> None:
        self.counts[key] = value

    def add_samples(self, count: int) -> None:
        self.samples += int(count)

    @property
    def elapsed(self) -> float:
        return self._elapsed

    @property
    def msps(self) -> float:
        return self.samples / self._elapsed / 1e6 if self._elapsed else 0.0

    def status_line(self, *, ok: bool = True, error: str | None = None) -> str:
        parts = ["[OK]" if ok else "[FAIL]", self.name]
        parts += [f"{key}={value}" for key, value in self.counts.items()]
        parts += [f"samples={self.samples}", f"elapsed={self._elapsed:.3f}s",
                  f"msps={self.msps:.1f}"]
        if self.sol_msps:
            parts.append(f"sol_fraction={self.msps / self.sol_msps:.3f}")
        if error is not None:
            parts.append(f'error="{error}"')
        return " ".join(parts)
