"""Pipeline stages 1-3: input vectors, ideal outputs, fixed outputs.

Counterpart of ``warmup_fir_filter_tpu/pipeline/stages.py``.  Stages 1 and
2 (input vectors, float64 ideal outputs on the host) are copies of the
JAX package's (``:45-155``, ``:183-233``), so both packages write the
same artifacts; stage 3 (``:158-180``, ``:236-295``) runs on the GPU or
the host.

Backends of the fixed stage, with the JAX package's names in brackets:

- ``"auto"``    ``kernels/dispatch.py::fir1d_fixed_rows_auto`` [auto],
- ``"band"``    kernel A, the digit-plane band kernel [mxu],
- ``"direct"``  kernel B, the direct-form kernel [pallas],
- ``"torch"``   the plain int32 PyTorch path [tpu],
- ``"golden"``  the numpy oracle on the host [golden].

``device`` says where the samples go: ``"cuda"`` runs the kernels and
raises when there is no CUDA device; ``"cpu"`` runs each kernel's plain
version.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from warmup_fir_filter_tpu_torch._build import resolve_device
from warmup_fir_filter_tpu_torch.kernels.dispatch import fir1d_fixed_rows_auto
from warmup_fir_filter_tpu_torch.kernels.fir_band import FixedFir1d
from warmup_fir_filter_tpu_torch.kernels.fir_direct import fir_direct
from warmup_fir_filter_tpu_torch.models.filters import filter_bank
from warmup_fir_filter_tpu_torch.models.golden import (
    fir1d_fixed_golden_rows,
    fir1d_ideal_golden_rows,
)
from warmup_fir_filter_tpu_torch.ops.fir1d import fir1d_fixed_rows_torch
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.pipeline.artifacts import (
    ArtifactStore,
    save_npy,
    write_json,
)
from warmup_fir_filter_tpu_torch.utils import imageio
from warmup_fir_filter_tpu_torch.utils.logging import timed_entry_point
from warmup_fir_filter_tpu_torch.utils.profiling import StageTimer

FIXED_BACKENDS = ("auto", "band", "direct", "torch", "golden")


def _preview_payload(gray_u8: np.ndarray, *, max_rows: int = 8,
                     max_cols: int = 16) -> dict:
    """Top-left patch preview + stats (``gen_input_vectors.py:78-93``)."""
    pr = min(gray_u8.shape[0], max_rows)
    pc = min(gray_u8.shape[1], max_cols)
    return {
        "preview_kind": "top_left_patch",
        "preview_shape": [pr, pc],
        "preview_rows_u8": gray_u8[:pr, :pc].tolist(),
        "stats": {
            "min": int(gray_u8.min()),
            "max": int(gray_u8.max()),
            "mean": float(gray_u8.mean()),
            "std": float(gray_u8.std()),
        },
    }


def generate_input_vectors(
    image_dir: Path,
    store: ArtifactStore,
    *,
    overwrite: bool = False,
) -> dict:
    """Stage 1: images → grayscale uint8 .npy + preview JSON + manifest.

    Contract parity: ``gen_input_vectors.py:96-169`` (same filenames,
    manifest fields, idempotent skip, deterministic case indexing by
    case-insensitive name sort).
    """
    image_dir = Path(image_dir).resolve()
    if not image_dir.exists():
        raise FileNotFoundError(f"Image directory not found: {image_dir}")
    image_files = imageio.iter_image_files(image_dir)
    if not image_files:
        raise FileNotFoundError(f"No image files found in: {image_dir}")

    with timed_entry_point("gen_input_vectors", generated=0, skipped=0) as counts:
        cases: list[dict] = []
        for idx, image_path in enumerate(image_files):
            case_name = ArtifactStore.case_name(idx, image_path.stem)
            data_file = store.input_vector_path(case_name)
            preview_file = store.input_preview_path(case_name)

            if (
                data_file.exists()
                and preview_file.exists()
                and not overwrite
            ):
                counts["skipped"] += 1
                gray_u8 = None
                # Manifest needs shape; read the stored vector header only.
                h, w = _npy_shape(data_file)
            else:
                gray_u8 = imageio.load_gray_u8(image_path)
                h, w = gray_u8.shape
                save_npy(data_file, gray_u8)
                write_json(
                    preview_file,
                    {
                        "case_name": case_name,
                        "image_name": image_path.name,
                        "source_path": str(image_path),
                        "width": w,
                        "height": h,
                        "dtype": "uint8",
                        "layout": "row_major_2d",
                        "data_file": data_file.name,
                        **_preview_payload(gray_u8),
                    },
                )
                counts["generated"] += 1

            cases.append(
                {
                    "case_name": case_name,
                    "image_name": image_path.name,
                    "width": w,
                    "height": h,
                    "dtype": "uint8",
                    "data_npy": data_file.name,
                    "preview_json": preview_file.name,
                }
            )

        manifest = {
            "note": "FIR input vectors: pixel data in .npy, previews in .json.",
            "source_image_dir": str(image_dir),
            "output_dir": str(store.input_dir),
            "num_images": len(cases),
            "overwrite": bool(overwrite),
            "generated_cases": counts["generated"],
            "skipped_cases": counts["skipped"],
            "cases": cases,
        }
        write_json(store.manifest_path(), manifest)
    return manifest


def _npy_shape(path: Path) -> tuple[int, int]:
    arr = np.load(path, mmap_mode="r")
    if arr.ndim != 2:
        raise ValueError(f"{path.name}: expected 2D array, got {arr.shape}")
    return int(arr.shape[0]), int(arr.shape[1])


def _load_input_u8(path: Path) -> np.ndarray:
    x = np.load(path)
    if x.ndim != 2:
        raise ValueError(f"{path.name}: expected 2D array, got shape={x.shape}")
    return x.astype(np.uint8, copy=False)


def generate_ideal_outputs(
    store: ArtifactStore,
    *,
    tap: int,
    overwrite: bool = False,
    coeff_map: dict[str, list[float]] | None = None,
) -> int:
    """Stage 2: float64 ideal outputs per (input case × coefficient).

    Contract parity: ``gen_ideal_output.py:91-118`` (filenames, skip
    semantics, same-length check); the rowwise interpreted loop becomes
    one vectorized f64 pass per case.
    """
    coeff_map = coeff_map if coeff_map is not None else filter_bank(tap)
    input_files = store.iter_input_vectors()
    if not input_files:
        raise FileNotFoundError(f"No input .npy files found in {store.input_dir}")

    # The ideal (model) stage runs the float64 numpy golden on the host;
    # the HBM roofline does not apply, so no sol_fraction is reported.
    with StageTimer(f"gen_ideal_outputs_{tap}tap", sol_msps=None,
                    generated=0, skipped=0) as counts:
        for in_path in input_files:
            case_stem = ArtifactStore.case_stem_of_input(in_path)
            pending = {
                name: h
                for name, h in coeff_map.items()
                if not ArtifactStore.should_skip(
                    store.output_vector_path("ideal", tap, case_stem, name),
                    overwrite=overwrite,
                )
            }
            counts["skipped"] += len(coeff_map) - len(pending)
            if not pending:
                continue
            x_u8 = _load_input_u8(in_path)
            for coeff_name, h in pending.items():
                y = fir1d_ideal_golden_rows(x_u8, np.asarray(h, np.float64))
                if y.shape != x_u8.shape:
                    raise ValueError(
                        f"Output shape mismatch for {case_stem}/{coeff_name}: "
                        f"{y.shape} != {x_u8.shape}"
                    )
                save_npy(
                    store.output_vector_path("ideal", tap, case_stem, coeff_name),
                    y,
                )
                counts["generated"] += 1
                counts.add_samples(y.size)
        generated = counts["generated"]
    return generated


def _fixed_compute(backend: str, x_u8: np.ndarray, h: np.ndarray,
                   qformat: QFormat, device: torch.device) -> np.ndarray:
    if backend == "golden" or not qformat.tpu_native:
        return fir1d_fixed_golden_rows(x_u8, h, qformat)
    x = torch.from_numpy(np.ascontiguousarray(x_u8)).to(device)
    if backend == "auto":
        y = fir1d_fixed_rows_auto(x, h, qformat)
    elif backend == "band":
        y = FixedFir1d.from_numpy(h, qformat, device)(x)
    elif backend == "direct":
        y = fir_direct(x, h, qformat)
    elif backend == "torch":
        y = fir1d_fixed_rows_torch(x, h, qformat)
    else:
        raise ValueError(
            f"Unknown fixed backend={backend!r}; expected {FIXED_BACKENDS}")
    return y.cpu().numpy()


def generate_fixed_outputs(
    store: ArtifactStore,
    *,
    tap: int,
    qformat: QFormat = QFormat(),
    backend: str = "auto",
    device: str | torch.device = "cuda",
    overwrite: bool = False,
    coeff_map: dict[str, list[float]] | None = None,
) -> int:
    """Stage 3: bit-accurate fixed-point outputs per (case × coefficient).

    Same artifacts, skip rules and status line as the reference's stage 3;
    the status line carries no speed-of-light fraction.
    """
    if backend not in FIXED_BACKENDS:
        raise ValueError(
            f"Unknown fixed backend={backend!r}; expected {FIXED_BACKENDS}"
        )
    device = resolve_device(device)
    coeff_map = coeff_map if coeff_map is not None else filter_bank(tap)
    for h in coeff_map.values():
        qformat.validate_h_range(h)
    input_files = store.iter_input_vectors()
    if not input_files:
        raise FileNotFoundError(f"No input .npy files found in {store.input_dir}")

    with StageTimer(f"gen_fixed_outputs_{tap}tap", sol_msps=None,
                    generated=0, skipped=0) as counts:
        for in_path in input_files:
            case_stem = ArtifactStore.case_stem_of_input(in_path)
            pending = {
                name: h
                for name, h in coeff_map.items()
                if not ArtifactStore.should_skip(
                    store.output_vector_path("fixed", tap, case_stem, name),
                    overwrite=overwrite,
                )
            }
            counts["skipped"] += len(coeff_map) - len(pending)
            if not pending:
                continue
            x_u8 = _load_input_u8(in_path)
            for coeff_name, h in pending.items():
                y = _fixed_compute(backend, x_u8, np.asarray(h, np.float64),
                                   qformat, device)
                if y.shape != x_u8.shape or y.dtype != np.uint8:
                    raise ValueError(
                        f"Output contract violation for {case_stem}/"
                        f"{coeff_name}: shape={y.shape} dtype={y.dtype}"
                    )
                save_npy(
                    store.output_vector_path("fixed", tap, case_stem, coeff_name),
                    y,
                )
                counts["generated"] += 1
                counts.add_samples(y.size)
        generated = counts["generated"]
    return generated
