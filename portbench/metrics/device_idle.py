"""``device_idle``: the share of the traced stretch, in %, in which the card
(rank 0's in a sharded cell) ran no kernel, copy or set."""

from portbench.trace import busy_and_window_s


def read(run):
    if run.trace is None:
        return None
    busy_window = busy_and_window_s(run.trace)
    if busy_window is None or busy_window[1] <= 0:
        return None
    busy, window = busy_window
    return 100.0 * (1.0 - busy / window)
