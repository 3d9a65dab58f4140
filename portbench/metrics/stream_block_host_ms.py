"""``stream_block_host_ms``: host time the stream loop spends on a block
once the block is in hand (``ops/streaming.py::stream_scanned``'s
``stream.block`` spans: enqueuing the step and the checksums), summed over
the stretch and divided by the traced calls' blocks.  Milliseconds a block;
not reported where the program opens no such span."""

from portbench.spans import BLOCK, host_ms


def read(run):
    return host_ms(run, BLOCK, run.work["blocks_per_call"])
