"""``stream_glue_ms``: device time a stream block spends in everything of
the stream loop but its filter (``ops/streaming.py``'s checksums, carry,
casts and copies): every device operation launched inside the traced calls
except kernel A, kernel D and what the harness's block source launched
(``portbench.source`` spans), over the traced calls' blocks.
Milliseconds."""

from portbench.trace import CALL, SOURCE

#: Kernel A (``csrc/fir_band.cu``) and kernel D (``csrc/window_copy.cu``).
KERNELS = ("fir_band_short_kernel", "fir_band_planes_kernel",
           "window_rows_kernel")


def read(run):
    trace = run.trace
    if trace is None:
        return None
    calls = trace.calls()
    in_calls = trace.launched_inside(CALL)
    source = trace.launched_inside(SOURCE)
    if calls == 0 or not in_calls:
        return None
    glue_us = sum(e.dur for e in trace.device_in_stretch()
                  if e.corr in in_calls and e.corr not in source
                  and not any(k in e.name for k in KERNELS))
    return glue_us * 1e-3 / (calls * run.work["blocks_per_call"])
