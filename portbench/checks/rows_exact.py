"""The rows cells' check: the output rows of sampled calls against the
reference, sample for sample.

Every call of the window filters the same rows, so the reference filters
them once, a block of rows at a time, and each kept output is compared with
it.  ``wrong_samples`` counts the output samples that differ over all kept
outputs; the limit is 0, since the configuration states a bit-exact
result.  A call whose output differs anywhere counts as failed."""

from portbench.reference import fir_fixed_rows, quantize_taps

#: Rows the reference holds at once.
ROW_BLOCK = 8192


def check(evidence: dict) -> tuple[dict, int]:
    """``({"wrong_samples": {...}}, failed calls)``."""
    config = evidence["config"]
    taps = quantize_taps(config["taps"], config["coeff_bits"],
                         config["frac_bits"])
    x = evidence["x"]
    outputs = evidence["outputs"]
    wrong = {i: 0 for i in outputs}
    for r in range(0, x.shape[0], ROW_BLOCK):
        rows = slice(r, r + ROW_BLOCK)
        want = fir_fixed_rows(x, taps, config["frac_bits"],
                              config["acc_bits"], rows)
        for i, y in outputs.items():
            wrong[i] += int((y[rows] != want).sum())
    total = sum(wrong.values())
    return ({"wrong_samples": {"value": total, "limit": 0}},
            sum(1 for w in wrong.values() if w))
