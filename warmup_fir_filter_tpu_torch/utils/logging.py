"""Structured one-line status logging.

Every pipeline entry point emits a uniform status line, preserving the
reference's observability contract (SURVEY.md §5.5):

    [OK] <name> generated=G skipped=S failed=F elapsed=T out=<dir>
    [FAIL] <name> ... error="..."

plus ``[pipeline] <stage>`` progress lines.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


def stage_line(stage: str) -> None:
    print(f"[pipeline] {stage}")


def status_line(
    name: str,
    *,
    ok: bool = True,
    elapsed: float | None = None,
    error: str | None = None,
    **counts,
) -> str:
    parts = ["[OK]" if ok else "[FAIL]", name]
    for key, value in counts.items():
        parts.append(f"{key}={value}")
    if elapsed is not None:
        parts.append(f"elapsed={elapsed:.3f}s")
    if error is not None:
        parts.append(f'error="{error}"')
    line = " ".join(str(p) for p in parts)
    print(line)
    return line


@contextmanager
def timed_entry_point(name: str, **counts_out):
    """Context manager printing [OK]/[FAIL] with elapsed time.

    Usage::

        with timed_entry_point("gen_fixed_outputs") as counts:
            ...
            counts["generated"] = 12

    On exception, prints a [FAIL] line and re-raises (the reference's
    fail-fast contract, ``pipeline_fir_1d.py:232-241``).
    """
    counts: dict = dict(counts_out)
    start = time.perf_counter()
    try:
        yield counts
    except Exception as exc:
        status_line(
            name,
            ok=False,
            elapsed=time.perf_counter() - start,
            error=str(exc),
            **counts,
        )
        raise
    status_line(name, ok=True, elapsed=time.perf_counter() - start, **counts)
