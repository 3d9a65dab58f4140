"""``osfilt_stream_roofline``: kernel M's share of its roofline on rank 0,
in %: the least time of rank 0's part of the traced calls over kernel M's
device time in them.

The least time of a rank's block of ``C × T`` outputs is the larger of
float32 in and out (8 bytes an output sample) at the memory rate and the
transforms at the float32 peak: a 512-point real window every
``512 - L + 1`` outputs of a channel, each ``5 n log2 n + 3 n``
operations (``chip_smoke.py``'s corrected count)."""

from portbench.roofline import least_seconds, real_filter_ops
#: Kernel M (``csrc/osfilt_stream.cu``).
KERNELS = ("osfilt_stream_kernel",)
#: Kernel M's window.
NFFT = 512


def least_seconds_per_call(channels: int, local_time: int,
                           num_taps: int) -> float:
    hop = NFFT - num_taps + 1
    windows = channels * -(-local_time // hop)
    return least_seconds(8.0 * channels * local_time,
                         windows * real_filter_ops(NFFT), "f32")


def read(run):
    trace = run.trace
    if trace is None:
        return None
    kernel_us = sum(e.dur for e in trace.device_in_stretch()
                    if any(k in e.name for k in KERNELS))
    calls = trace.calls()
    if kernel_us <= 0 or calls == 0:
        return None
    least = least_seconds_per_call(run.work["channels"],
                                   run.work["local_time"],
                                   len(run.cell.config["taps"]))
    return 100.0 * least * calls / (kernel_us * 1e-6)
