"""``halo_nccl_ms``: rank 0's device time a call in the NCCL kernels that
the calls launched (the halo exchange of ``parallel/halo.py``; a kernel
that waits for its peer counts its wait).  Milliseconds."""

from portbench.trace import CALL

#: A substring of every NCCL kernel's name, compared without case.
KERNELS = ("nccl",)


def read(run):
    trace = run.trace
    if trace is None:
        return None
    calls = trace.calls()
    if calls == 0:
        return None
    in_calls = trace.launched_inside(CALL)
    nccl_us = sum(e.dur for e in trace.device_in_stretch()
                  if e.cat == "kernel" and e.corr in in_calls
                  and any(k in e.name.lower() for k in KERNELS))
    if nccl_us <= 0:
        return None
    return nccl_us * 1e-3 / calls
