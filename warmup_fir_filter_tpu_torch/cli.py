"""End-to-end pipeline CLI of the port.

The reference's 5-stage flow (``warmup_fir_filter_tpu/cli.py``): input
vectors → ideal outputs → fixed outputs → compare reports → restored
images, with the same flags, except that

- ``--backend`` takes the JAX package's choices
  ``{auto,tpu,pallas,mxu,golden}`` with their meanings
  (``pipeline/stages.py``) and defaults to ``auto``, which runs the main
  path on the hand-written kernels, where the JAX package's ``tpu`` would
  run the int32 path of torch ops;
- ``--device {cuda,cpu}`` (default ``cuda``) says where the fixed stage
  runs; ``cuda`` without a CUDA device raises;
- ``--image-dir`` has no default: it is needed unless ``--skip-input``;
- ``--profile DIR`` traces the pipeline with ``torch.profiler``
  (``utils/profiling.py::trace``) into DIR as a TensorBoard
  ``*.pt.trace.json``: the host's torch ops and, with CUDA, the card's
  kernels (kernel A's ``fir_band_*`` launches, one a fixed output) and
  copies, the card synchronized before the trace ends.

Only the fixed stage runs on the device; the other stages are the port's
copies of the JAX package's numpy code.  Run as
``python -m warmup_fir_filter_tpu_torch``.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from pathlib import Path

from warmup_fir_filter_tpu_torch._build import DEVICES
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.pipeline.analysis import (
    generate_analysis_doc,
    generate_comparison_doc,
)
from warmup_fir_filter_tpu_torch.pipeline.artifacts import ArtifactStore
from warmup_fir_filter_tpu_torch.pipeline.report import generate_compare_report
from warmup_fir_filter_tpu_torch.pipeline.restore import restore_images
from warmup_fir_filter_tpu_torch.pipeline.stages import (
    FIXED_BACKENDS,
    generate_fixed_outputs,
    generate_ideal_outputs,
    generate_input_vectors,
)
from warmup_fir_filter_tpu_torch.pipeline.synthetic import synthesize_corpus
from warmup_fir_filter_tpu_torch.utils.logging import stage_line
from warmup_fir_filter_tpu_torch.utils.profiling import trace


def run_pipeline(
    *,
    image_dir: Path | None,
    artifact_root: Path,
    tap: str = "all",
    backend: str = "auto",
    device: str = "cuda",
    qformat: QFormat = QFormat(),
    overwrite_vectors: bool = False,
    overwrite_images: bool = False,
    skip_input: bool = False,
    skip_ideal: bool = False,
    skip_fixed: bool = False,
    skip_report: bool = False,
    skip_restore: bool = False,
    restore_kind: str = "all",
    ideal_policy: str = "clip",
    strict_report: bool = False,
    strict_restore: bool = False,
    top_k: int = 5,
) -> dict:
    """Run the 5-stage pipeline; returns a result summary dict."""
    store = ArtifactStore(artifact_root)
    taps = (3, 5) if tap == "all" else (int(tap),)
    result: dict = {"stages": {}, "artifact_root": str(store.root)}

    if not skip_input:
        if image_dir is None:
            raise ValueError("an image directory is needed unless the input "
                             "stage is skipped")
        stage_line("generate input vectors")
        manifest = generate_input_vectors(
            image_dir, store, overwrite=overwrite_vectors
        )
        result["stages"]["input"] = {
            "generated": manifest["generated_cases"],
            "skipped": manifest["skipped_cases"],
        }

    if not skip_ideal:
        for t in taps:
            stage_line(f"generate ideal outputs ({t}tap)")
            generated = generate_ideal_outputs(
                store, tap=t, overwrite=overwrite_vectors
            )
            result["stages"][f"ideal_{t}tap"] = {"generated": generated}

    if not skip_fixed:
        for t in taps:
            stage_line(f"generate fixed outputs ({t}tap, backend={backend}, "
                       f"device={device})")
            generated = generate_fixed_outputs(
                store,
                tap=t,
                qformat=qformat,
                backend=backend,
                device=device,
                overwrite=overwrite_vectors,
            )
            result["stages"][f"fixed_{t}tap"] = {"generated": generated}

    if not skip_report:
        for t in taps:
            stage_line(f"generate compare report ({t}tap)")
            report = generate_compare_report(
                store, tap=t, top_k=top_k, strict=strict_report
            )
            report["analysis_md"] = str(generate_analysis_doc(store, tap=t))
            result["stages"][f"report_{t}tap"] = report
        if len(taps) == 2:
            stage_line(f"generate {taps[0]}tap-vs-{taps[1]}tap comparison")
            result["comparison_md"] = str(
                generate_comparison_doc(store, taps=taps)
            )

    if not skip_restore:
        stage_line("restore images")
        summary = restore_images(
            store,
            kind=restore_kind,
            taps=taps,
            ideal_policy=ideal_policy,
            overwrite=overwrite_images,
            strict=strict_restore,
        )
        result["stages"]["restore"] = {
            "converted": summary["num_converted"],
            "skipped": summary["num_skipped"],
        }

    return result


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="warmup_fir_filter_tpu_torch",
        description=(
            "Run the FIR verification pipeline end-to-end with the fixed "
            "stage on a CUDA GPU: input vectors, ideal/fixed outputs, "
            "compare reports, and image restore."
        ),
    )
    parser.add_argument("--image-dir", type=Path, default=None,
                        help="Source image directory (needed unless "
                             "--skip-input).")
    parser.add_argument("--synthesize-corpus", action="store_true",
                        help="Generate a deterministic synthetic image "
                             "corpus into --image-dir before running.")
    parser.add_argument("--artifact-root", type=Path,
                        default=Path("artifacts"),
                        help="Root directory for all pipeline artifacts.")
    parser.add_argument("--tap", choices=("all", "3", "5"), default="all",
                        help="Tap group to process (default: all).")
    parser.add_argument("--backend", choices=FIXED_BACKENDS, default="auto",
                        help="Fixed-point compute backend (default: auto).")
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="Device of the fixed stage (default: cuda; "
                             "cpu runs the kernels' plain versions).")
    parser.add_argument("--frac-bits", type=int, default=12)
    parser.add_argument("--acc-bits", type=int, default=32)
    parser.add_argument("--coeff-bits", type=int, default=16)
    parser.add_argument("--overwrite-vectors", action="store_true",
                        help="Overwrite existing vectors instead of skipping.")
    parser.add_argument("--overwrite-images", action="store_true",
                        help="Overwrite existing restored images.")
    parser.add_argument("--skip-input", action="store_true")
    parser.add_argument("--skip-ideal", action="store_true")
    parser.add_argument("--skip-fixed", action="store_true")
    parser.add_argument("--skip-report", action="store_true")
    parser.add_argument("--skip-restore", action="store_true")
    parser.add_argument("--restore-kind", choices=("all", "ideal", "fixed"),
                        default="all")
    parser.add_argument("--ideal-policy", choices=("clip", "normalize"),
                        default="clip")
    parser.add_argument("--strict-report", action="store_true")
    parser.add_argument("--strict-restore", action="store_true")
    parser.add_argument("--top-k", type=int, default=5,
                        help="Top-k worst cases in compare reports.")
    parser.add_argument("--profile", type=Path, default=None, metavar="DIR",
                        help="Capture a torch.profiler trace of the whole "
                             "pipeline into DIR (viewable in TensorBoard).")
    return parser


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.synthesize_corpus:
        if args.image_dir is None:
            raise SystemExit("--synthesize-corpus needs --image-dir")
        stage_line(f"synthesize corpus -> {args.image_dir}")
        synthesize_corpus(args.image_dir)
    start = time.perf_counter()
    profile_cm = (trace(str(args.profile)) if args.profile is not None
                  else contextlib.nullcontext())
    try:
        with profile_cm:
            result = run_pipeline(
                image_dir=args.image_dir,
                artifact_root=args.artifact_root,
                tap=args.tap,
                backend=args.backend,
                device=args.device,
                qformat=QFormat(
                    coeff_bits=args.coeff_bits,
                    frac_bits=args.frac_bits,
                    acc_bits=args.acc_bits,
                ),
                overwrite_vectors=args.overwrite_vectors,
                overwrite_images=args.overwrite_images,
                skip_input=args.skip_input,
                skip_ideal=args.skip_ideal,
                skip_fixed=args.skip_fixed,
                skip_report=args.skip_report,
                skip_restore=args.skip_restore,
                restore_kind=args.restore_kind,
                ideal_policy=args.ideal_policy,
                strict_report=args.strict_report,
                strict_restore=args.strict_restore,
                top_k=args.top_k,
            )
    except Exception as exc:
        elapsed = time.perf_counter() - start
        print(f'[FAIL] pipeline elapsed={elapsed:.3f}s error="{exc}"')
        raise
    elapsed = time.perf_counter() - start
    generated = sum(
        int(stage.get("generated", stage.get("converted", 0)))
        for stage in result["stages"].values()
    )
    print(
        f"[OK] pipeline generated={generated} elapsed={elapsed:.3f}s "
        f"device={args.device} out={result['artifact_root']}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
