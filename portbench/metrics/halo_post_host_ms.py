"""``halo_post_host_ms``: rank 0's host time a call spends posting the halo
exchange (``parallel/halo.py::post_halo``'s ``halo.post`` spans: the zeroed
receive buffers, the contiguous sends, ``batch_isend_irecv``), summed over
the stretch and divided by the traced calls.  Milliseconds a call; not
reported where the program opens no such span."""

from portbench.spans import HALO_POST, host_ms


def read(run):
    return host_ms(run, HALO_POST)
