"""``msps``: every output sample of every call completed in the window,
over the window's wall time on the host clock (the window ends in a
synchronize).  In a sharded cell, the samples of the whole array a call
filters over rank 0's window, every rank making the same calls between two
barriers."""


def read(run):
    window = run.window
    if window.calls == 0 or window.seconds <= 0:
        return None
    return window.calls * run.work["samples_per_call"] / window.seconds / 1e6
