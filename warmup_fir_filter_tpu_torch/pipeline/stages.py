"""Pipeline stage 3: fixed-point outputs, on the GPU or the host.

Counterpart of ``warmup_fir_filter_tpu/pipeline/stages.py`` (``:42``,
``:158-180``, ``:236-295``).  Stages 1 and 2 (input vectors, float64 ideal
outputs) are the reference's own, imported through ``reference.py``.

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

import numpy as np
import torch

from warmup_fir_filter_tpu_torch.kernels.dispatch import fir1d_fixed_rows_auto
from warmup_fir_filter_tpu_torch.kernels.fir_band import FixedFir1d
from warmup_fir_filter_tpu_torch.kernels.fir_direct import fir_direct
from warmup_fir_filter_tpu_torch.ops.fir1d import fir1d_fixed_rows_torch
from warmup_fir_filter_tpu_torch.reference import (
    ArtifactStore,
    QFormat,
    StageTimer,
    filter_bank,
    fir1d_fixed_golden_rows,
    load_input_u8,
    save_npy,
)

FIXED_BACKENDS = ("auto", "band", "direct", "torch", "golden")
DEVICES = ("cuda", "cpu")


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device`` for ``device``; raises if it is CUDA and there is none."""
    device = torch.device(device)
    if device.type not in DEVICES:
        raise ValueError(f"Unsupported device={device}; expected {DEVICES}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run the plain versions on the host."
        )
    return device


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
            x_u8 = load_input_u8(in_path)
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
