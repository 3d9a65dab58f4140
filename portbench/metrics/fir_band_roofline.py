"""``fir_band_roofline``: kernel A's share of its roofline, in %: the least
time of the traced calls' FIR over kernel A's summed device time in them.

The least time counts the FIR the call asks for, whatever kernel does it:
one byte in and one byte out an output sample at the memory rate, or two
operations a nonzero quantized tap an output sample at the int8 peak,
whichever is larger."""

import numpy as np

from portbench.reference import quantize_taps
from portbench.roofline import least_seconds
#: Kernel A's kernels (``csrc/fir_band.cu``): the short-tap route and the
#: digit planes.
KERNELS = ("fir_band_short_kernel", "fir_band_planes_kernel")


def least_seconds_per_call(config: dict, samples: int) -> float:
    taps = quantize_taps(config["taps"], config["coeff_bits"],
                         config["frac_bits"])
    nonzero = int(np.count_nonzero(taps))
    return least_seconds(2.0 * samples, 2.0 * nonzero * samples, "int8")


def read(run):
    if run.trace is None:
        return None
    kernel_us = sum(e.dur for e in run.trace.device_in_stretch()
                    if any(k in e.name for k in KERNELS))
    calls = run.trace.calls()
    if kernel_us <= 0 or calls == 0:
        return None
    least = least_seconds_per_call(run.cell.config,
                                   run.work["samples_per_call"])
    return 100.0 * least * calls / (kernel_us * 1e-6)
