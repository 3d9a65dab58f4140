"""``halo_attach_ms``: rank 0's device time a call in the halo-extended
copy: the operations launched inside ``parallel/halo.py::_attach``'s
``halo.attach`` spans (by correlation id), over the traced calls.
Milliseconds a call; not reported where the program opens no such span."""

from portbench.spans import HALO_ATTACH, device_ms


def read(run):
    return device_ms(run, HALO_ATTACH)
