"""Stage 4: fixed-vs-ideal compare reports (the verification oracle).

Tap-generic re-design of the reference's cloned 3tap/5tap report scripts
(``gen_{3,5}tap_compare_report.py`` — SURVEY.md P7/P8): pairs output
vectors by filename key, computes nine per-case error/saturation metrics,
rolls up overall / per-coefficient / worst-k summaries, records data-
integrity findings (invalid names, duplicates, missing pairs, shape
mismatches), optionally escalating them in strict mode, and writes
CSV + JSON + console summaries with the same schema as the reference
(``gen_5tap_compare_report.py:178-195,374-390``).

Adds what the reference lacks: PSNR per case and an aggregate
sample-weighted summary (the analysis docs computed these by hand —
``fir_1d_3tap_compare_analysis_v1.md:62-67``).
"""

from __future__ import annotations

import csv
from datetime import datetime, timezone
from pathlib import Path
from typing import Any

import numpy as np

from warmup_fir_filter_tpu_torch.pipeline.artifacts import ArtifactStore, write_json
from warmup_fir_filter_tpu_torch.utils.logging import timed_entry_point

CSV_FIELDS = [
    "key",
    "case_stem",
    "coeff_name",
    "height",
    "width",
    "num_samples",
    "max_abs_err",
    "mae",
    "rmse",
    "mean_err",
    "sat_low_ratio",
    "sat_high_ratio",
    "sat_ratio",
    "clip_needed_ratio",
    "ideal_file",
    "fixed_file",
]

_SUMMARY_AVG_MAX_COLS = (
    "max_abs_err",
    "mae",
    "rmse",
    "mean_err",
    "sat_low_ratio",
    "sat_high_ratio",
    "sat_ratio",
    "clip_needed_ratio",
)


def compute_case_metrics(y_ideal: np.ndarray, y_fixed: np.ndarray) -> dict:
    """Nine per-case metrics (``gen_5tap_compare_report.py:67-112``) + PSNR.

    ``diff = fixed(uint8, clipped) - ideal(float64, raw)``; saturation is
    measured on the fixed output hitting 0/255; ``clip_needed_ratio`` is
    the fraction of ideal samples outside [0, 255].
    """
    if y_ideal.shape != y_fixed.shape:
        raise ValueError(
            f"Shape mismatch: ideal={y_ideal.shape}, fixed={y_fixed.shape}"
        )
    ideal = y_ideal.astype(np.float64, copy=False)
    fixed = y_fixed.astype(np.float64, copy=False)
    diff = fixed - ideal
    abs_diff = np.abs(diff)
    size = diff.size

    mse = float(np.mean(np.square(diff))) if size else 0.0
    rmse = float(np.sqrt(mse))
    flat_fixed = np.asarray(y_fixed).reshape(-1)
    sat_low = float(np.mean(flat_fixed == 0)) if size else 0.0
    sat_high = float(np.mean(flat_fixed == 255)) if size else 0.0
    clip_needed = (
        float(np.mean((ideal < 0.0) | (ideal > 255.0))) if size else 0.0
    )
    psnr_db = float(10.0 * np.log10(255.0**2 / mse)) if mse > 0 else float("inf")

    return {
        "num_samples": int(size),
        "max_abs_err": float(abs_diff.max()) if size else 0.0,
        "mae": float(abs_diff.mean()) if size else 0.0,
        "rmse": rmse,
        "mean_err": float(diff.mean()) if size else 0.0,
        "sat_low_ratio": sat_low,
        "sat_high_ratio": sat_high,
        "sat_ratio": sat_low + sat_high,
        "clip_needed_ratio": clip_needed,
        "psnr_db": psnr_db,
    }


def _empty_summary() -> dict:
    out: dict[str, Any] = {"num_cases": 0, "num_samples_total": 0}
    for col in _SUMMARY_AVG_MAX_COLS:
        out[f"avg_{col}"] = 0.0
    for col in ("max_abs_err", "mae", "rmse", "sat_ratio"):
        out[f"max_{col}"] = 0.0
    return out


def summarize_rows(rows: list[dict]) -> dict:
    """Case-mean + case-max rollup (``gen_5tap_compare_report.py:115-155``)."""
    if not rows:
        return _empty_summary()
    out: dict[str, Any] = {
        "num_cases": len(rows),
        "num_samples_total": int(sum(int(r["num_samples"]) for r in rows)),
    }
    for col in _SUMMARY_AVG_MAX_COLS:
        values = [float(r[col]) for r in rows]
        out[f"avg_{col}"] = float(np.mean(values))
    for col in ("max_abs_err", "mae", "rmse", "sat_ratio"):
        out[f"max_{col}"] = float(np.max([float(r[col]) for r in rows]))
    return out


def summarize_weighted(rows: list[dict]) -> dict:
    """Sample-weighted metrics across all cases.

    The reference computes these only in its analysis docs
    (``fir_1d_5tap_compare_analysis_v1.md:56-67``); here they are
    first-class report outputs with the *same definitions* so published
    baselines reproduce exactly: each weighted metric is
    Σ(n_i · m_i) / Σ n_i over the per-case values — including
    ``weighted_rmse`` (a weighted mean of per-case RMSEs, *not* a pooled
    RMSE) and ``weighted_psnr_db`` = 20·log10(255 / weighted_rmse).
    The statistically pooled RMSE (sqrt of weighted MSE) is reported
    additionally as ``weighted_rmse_pooled``.
    """
    if not rows:
        return {
            "num_samples_total": 0,
            "weighted_mae": 0.0,
            "weighted_rmse": 0.0,
            "weighted_rmse_pooled": 0.0,
            "weighted_mean_err": 0.0,
            "weighted_sat_ratio": 0.0,
            "weighted_clip_needed_ratio": 0.0,
            "weighted_psnr_db": float("inf"),
        }
    n = np.array([float(r["num_samples"]) for r in rows])
    total = float(n.sum())

    def _weighted(col: str) -> float:
        return float((n * np.array([float(r[col]) for r in rows])).sum() / total)

    w_rmse = _weighted("rmse")
    w_mse = float(
        (n * np.array([float(r["rmse"]) for r in rows]) ** 2).sum() / total
    )
    return {
        "num_samples_total": int(total),
        "weighted_mae": _weighted("mae"),
        "weighted_rmse": w_rmse,
        "weighted_rmse_pooled": float(np.sqrt(w_mse)),
        "weighted_mean_err": _weighted("mean_err"),
        "weighted_sat_ratio": _weighted("sat_ratio"),
        "weighted_clip_needed_ratio": _weighted("clip_needed_ratio"),
        "weighted_psnr_db": (
            float(20.0 * np.log10(255.0 / w_rmse)) if w_rmse > 0 else float("inf")
        ),
    }


def _has_validation_issue(validation: dict) -> bool:
    return any(len(v) > 0 for v in validation.values())


def generate_compare_report(
    store: ArtifactStore,
    *,
    tap: int,
    top_k: int = 5,
    strict: bool = False,
) -> dict:
    """Pair ideal/fixed vectors, compute metrics, write CSV+JSON reports."""
    ideal_dir = store.vector_dir("ideal", tap)
    fixed_dir = store.vector_dir("fixed", tap)
    if not ideal_dir.exists():
        raise FileNotFoundError(f"Ideal output directory not found: {ideal_dir}")
    if not fixed_dir.exists():
        raise FileNotFoundError(f"Fixed output directory not found: {fixed_dir}")

    with timed_entry_point(f"compare_report_{tap}tap", cases=0) as counts:
        ideal_map, invalid_ideal, dup_ideal = store.collect_output_vectors(
            "ideal", tap
        )
        fixed_map, invalid_fixed, dup_fixed = store.collect_output_vectors(
            "fixed", tap
        )

        key_sort = lambda k: (k.case_stem, k.coeff_name)  # noqa: E731
        shared = sorted(set(ideal_map) & set(fixed_map), key=key_sort)
        missing_ideal = sorted(set(fixed_map) - set(ideal_map), key=key_sort)
        missing_fixed = sorted(set(ideal_map) - set(fixed_map), key=key_sort)
        if not shared:
            raise ValueError(
                f"No matched {tap}tap ideal/fixed pairs found. "
                f"ideal_dir={ideal_dir}, fixed_dir={fixed_dir}"
            )

        rows: list[dict] = []
        shape_mismatches: list[dict] = []
        for key in shared:
            # Memory-mapped loads: the 13.5-Mpixel f64 ideal vectors are
            # ~540 MB each; metrics stream them without a full resident copy.
            y_ideal = np.load(ideal_map[key], mmap_mode="r")
            y_fixed = np.load(fixed_map[key], mmap_mode="r")
            if y_ideal.shape != y_fixed.shape:
                shape_mismatches.append(
                    {
                        "key": str(key),
                        "ideal_shape": list(y_ideal.shape),
                        "fixed_shape": list(y_fixed.shape),
                        "ideal_file": ideal_map[key].name,
                        "fixed_file": fixed_map[key].name,
                    }
                )
                continue
            metrics = compute_case_metrics(y_ideal, y_fixed)
            rows.append(
                {
                    "key": str(key),
                    "case_stem": key.case_stem,
                    "coeff_name": key.coeff_name,
                    "height": int(y_ideal.shape[0]) if y_ideal.ndim >= 2 else 1,
                    "width": (
                        int(y_ideal.shape[1])
                        if y_ideal.ndim >= 2
                        else int(y_ideal.shape[0])
                    ),
                    **metrics,
                    "ideal_file": ideal_map[key].name,
                    "fixed_file": fixed_map[key].name,
                }
            )

        rows.sort(key=lambda r: (str(r["case_stem"]), str(r["coeff_name"])))
        counts["cases"] = len(rows)

        by_coeff: dict[str, dict] = {}
        for row in rows:
            by_coeff.setdefault(str(row["coeff_name"]), []).append(row)
        by_coeff_summary = {
            name: summarize_rows(group)
            for name, group in sorted(by_coeff.items())
        }

        overall = summarize_rows(rows)
        weighted = summarize_weighted(rows)
        worst = sorted(rows, key=lambda r: (-float(r["rmse"]), str(r["key"])))
        worst = worst[: max(0, min(top_k, len(worst)))]

        validation = {
            "invalid_ideal_filenames": sorted(invalid_ideal),
            "invalid_fixed_filenames": sorted(invalid_fixed),
            "duplicate_ideal_keys": dup_ideal,
            "duplicate_fixed_keys": dup_fixed,
            "missing_ideal_keys": [str(k) for k in missing_ideal],
            "missing_fixed_keys": [str(k) for k in missing_fixed],
            "shape_mismatch_cases": shape_mismatches,
        }
        if strict and _has_validation_issue(validation):
            raise ValueError(
                "Validation failed in strict mode: "
                + ", ".join(
                    f"{name}={len(items)}" for name, items in validation.items()
                )
            )

        report_dir = store.report_dir(tap)
        csv_path = report_dir / f"compare_{tap}tap_cases.csv"
        json_path = report_dir / f"compare_{tap}tap_summary.json"

        report_dir.mkdir(parents=True, exist_ok=True)
        with csv_path.open("w", encoding="utf-8", newline="") as fp:
            writer = csv.DictWriter(fp, fieldnames=CSV_FIELDS,
                                    extrasaction="ignore")
            writer.writeheader()
            writer.writerows(rows)

        payload = {
            "generated_at_utc": datetime.now(timezone.utc).isoformat(),
            "config": {
                "ideal_dir": str(ideal_dir),
                "fixed_dir": str(fixed_dir),
                "report_dir": str(report_dir),
                "tap": tap,
                "top_k": int(top_k),
                "strict": bool(strict),
                "comparison_note": (
                    "Metrics are computed on fixed(uint8 clipped) - "
                    "ideal(float64 raw)."
                ),
            },
            "validation": validation,
            "overall": overall,
            "weighted": weighted,
            "by_coeff": by_coeff_summary,
            "worst_cases_by_rmse": worst,
            "cases": rows,
        }
        write_json(json_path, payload)
        _print_summary(tap, overall, weighted, worst, validation,
                       csv_path, json_path)

    return {
        "csv_path": str(csv_path),
        "json_path": str(json_path),
        "num_cases": overall["num_cases"],
        "num_samples_total": overall["num_samples_total"],
        "overall": overall,
        "weighted": weighted,
        "validation_has_issue": _has_validation_issue(validation),
    }


def _print_summary(tap, overall, weighted, worst, validation, csv_path,
                   json_path) -> None:
    print(f"[{tap}tap compare summary]")
    print(f"- num_cases: {overall['num_cases']}")
    print(f"- num_samples_total: {overall['num_samples_total']}")
    print(f"- avg_mae: {overall['avg_mae']:.6f}")
    print(f"- avg_rmse: {overall['avg_rmse']:.6f}")
    print(f"- weighted_mae: {weighted['weighted_mae']:.6f}")
    print(f"- weighted_rmse: {weighted['weighted_rmse']:.6f}")
    print(f"- max_max_abs_err: {overall['max_max_abs_err']:.6f}")
    print(f"- avg_sat_ratio: {overall['avg_sat_ratio']:.6f}")
    print("[validation]")
    for name, items in validation.items():
        print(f"- {name}: {len(items)}")
    if worst:
        print("[worst cases by rmse]")
        for idx, row in enumerate(worst, start=1):
            print(
                f"{idx}. key={row['key']}, rmse={row['rmse']:.6f}, "
                f"mae={row['mae']:.6f}, max_abs_err={row['max_abs_err']:.6f}"
            )
    print("[reports]")
    print(f"- csv: {csv_path}")
    print(f"- json: {json_path}")
