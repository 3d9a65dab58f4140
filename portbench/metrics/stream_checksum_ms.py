"""``stream_checksum_ms``: device time of the stream's checksums: the
operations launched inside ``stream.checksum`` spans (by correlation id;
``ops/streaming.py``'s column sums, weighted sums and the write into the
sums), over the traced calls' blocks.  Milliseconds a block; part of
``stream_glue_ms``; not reported where the program opens no such span."""

from portbench.spans import CHECKSUM, device_ms


def read(run):
    return device_ms(run, CHECKSUM, run.work["blocks_per_call"])
