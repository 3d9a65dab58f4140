"""``dispatch_host_ms``: host time a call spends in the entry, from entering
it until it returns, before the synchronize: the filter's preparation, its
uploads and the launches.  The mean of the ``portbench.call`` spans that
the harness puts around each call of the traced stretch.  Milliseconds."""

from portbench.trace import CALL


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.spans(CALL)
    if not spans:
        return None
    return sum(s.dur for s in spans) / len(spans) * 1e-3
