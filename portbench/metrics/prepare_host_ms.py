"""``prepare_host_ms``: host time a call spends preparing the filter, read
from inside the port: the summed length of the stretch's ``fir.prepare``
spans (``kernels/dispatch.py::prepare_fixed_fir``: quantize, digit and band
planes, the buffers' uploads) over the traced calls.  Milliseconds; not
reported where the program opens no such span."""

from portbench.spans import PREPARE, host_ms


def read(run):
    return host_ms(run, PREPARE)
