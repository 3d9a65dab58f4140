"""Stage 5: restore output vectors back to viewable PNG images.

Observability back to pixels (SURVEY.md §3.4).  Contract parity with the
reference (``restore_images.py:104-228``): fixed u8 vectors pass through;
ideal f64 vectors convert under a ``clip`` (rint + clip) or ``normalize``
(min-max rescale) policy; per-file skip accounting with reasons; strict
mode escalates unexpected files; JSON summary with config echo + UTC
timestamp.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any

import numpy as np

from warmup_fir_filter_tpu_torch.pipeline.artifacts import (
    ArtifactStore,
    parse_output_name,
    write_json,
)
from warmup_fir_filter_tpu_torch.utils import imageio
from warmup_fir_filter_tpu_torch.utils.logging import timed_entry_point

IDEAL_POLICIES = ("clip", "normalize")


def to_u8_clip(arr: np.ndarray) -> np.ndarray:
    """rint then clip to [0, 255] (``restore_images.py:51-54``)."""
    return np.clip(np.rint(arr), 0, 255).astype(np.uint8)


def to_u8_normalized(arr: np.ndarray) -> np.ndarray:
    """Min-max rescale to [0, 255] (``restore_images.py:57-64``)."""
    arr64 = arr.astype(np.float64, copy=False)
    lo, hi = float(arr64.min()), float(arr64.max())
    if hi <= lo:
        return np.zeros(arr64.shape, dtype=np.uint8)
    scaled = (arr64 - lo) * (255.0 / (hi - lo))
    return np.rint(np.clip(scaled, 0, 255)).astype(np.uint8)


def convert_to_image_u8(arr: np.ndarray, *, kind: str,
                        ideal_policy: str = "clip") -> np.ndarray:
    if arr.ndim != 2:
        raise ValueError(f"Expected 2D array for image restore, got {arr.shape}")
    if kind == "fixed":
        if arr.dtype == np.uint8:
            return arr
        return to_u8_clip(arr.astype(np.float64, copy=False))
    if kind == "ideal":
        if ideal_policy == "clip":
            return to_u8_clip(arr.astype(np.float64, copy=False))
        if ideal_policy == "normalize":
            return to_u8_normalized(arr)
        raise ValueError(f"Unsupported ideal_policy={ideal_policy}")
    raise ValueError(f"Unsupported kind={kind}")


def restore_images(
    store: ArtifactStore,
    *,
    kind: str = "all",
    taps: tuple[int, ...] = (3, 5),
    ideal_policy: str = "clip",
    overwrite: bool = False,
    strict: bool = False,
    write_summary: bool = True,
) -> dict:
    """Convert every matching output vector into a grayscale PNG."""
    if ideal_policy not in IDEAL_POLICIES:
        raise ValueError(
            f"Unsupported ideal_policy={ideal_policy}; expected {IDEAL_POLICIES}"
        )
    kinds = ("ideal", "fixed") if kind == "all" else (kind,)
    for k in kinds:
        if k not in ("ideal", "fixed"):
            raise ValueError(f"Unsupported kind={k}")

    skipped: list[dict[str, Any]] = []

    def _skip(name: str, reason: str) -> None:
        skipped.append({"file": name, "reason": reason})
        if strict:
            raise ValueError(f"[strict] {name}: {reason}")

    with timed_entry_point("restore_images", converted=0, skipped=0) as counts:
        for k in kinds:
            for tap in taps:
                vec_dir = store.vector_dir(k, tap)
                if not vec_dir.exists():
                    _skip(str(vec_dir), "vector directory not found")
                    continue
                img_dir = store.restored_dir(k, tap, ideal_policy=ideal_policy)
                for npy_path in sorted(vec_dir.glob("*.npy"),
                                       key=lambda p: p.name.lower()):
                    parsed = parse_output_name(npy_path.name)
                    if parsed is None:
                        _skip(npy_path.name, "unrecognized filename")
                        continue
                    if parsed["kind"] != k or int(parsed["tap"]) != tap:
                        _skip(npy_path.name, "kind/tap mismatch with directory")
                        continue
                    png_path = img_dir / f"{npy_path.stem}.png"
                    if png_path.exists() and not overwrite:
                        _skip(npy_path.name, "image exists (overwrite=False)")
                        continue
                    arr = np.load(npy_path)
                    try:
                        u8 = convert_to_image_u8(
                            arr, kind=k, ideal_policy=ideal_policy
                        )
                    except ValueError as exc:
                        _skip(npy_path.name, str(exc))
                        continue
                    imageio.save_gray_png(png_path, u8)
                    counts["converted"] += 1
        counts["skipped"] = len(skipped)

        summary = {
            "generated_at_utc": datetime.now(timezone.utc).isoformat(),
            "config": {
                "vector_output_dir": str(store.output_dir),
                "output_img_dir": str(store.root / "output_img"),
                "kind": kind,
                "taps": list(taps),
                "ideal_policy": ideal_policy,
                "overwrite": bool(overwrite),
                "strict": bool(strict),
            },
            "num_converted": counts["converted"],
            "num_skipped": len(skipped),
            "skipped": skipped,
        }
        if write_summary:
            write_json(
                store.root / "output_img" / "restore_summary.json", summary
            )
    return summary
