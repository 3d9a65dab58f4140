"""``prepare_idle``: the share of the traced stretch, in %, in which the
card runs nothing while the host is inside a ``fir.prepare`` span: the
stretch's idle intervals intersected with the union of those spans, over
the stretch's length.  The idle intervals are taken on the host's clock:
no device operation starts before its launch
(``portbench/spans.py::device_after_launch``).  Not reported where the
program opens no such span."""

from portbench.spans import PREPARE, idle_share_inside


def read(run):
    return idle_share_inside(run, PREPARE)
