"""``call_ms_p95``: the 95th percentile of the calls' times on the host
clock, each from its start until its result was synchronised, over the
window's calls outside the traced stretch (rank 0's in a sharded cell).
Milliseconds."""

from portbench.harness import p95


def read(run):
    value = p95(run.window.untraced_latencies())
    return None if value is None else value * 1e3
