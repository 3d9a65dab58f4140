"""The JAX-free parts of the JAX package that the port reuses by import.

Every import of ``warmup_fir_filter_tpu`` made by the port goes through
this module, so the port keeps one contract with the reference
(``docs/architecture.md:6-20``) and this is the one place to check that
none of it pulls in ``jax``.  Only numpy modules are imported here:
Q-format arithmetic, validation, the filter banks, the bit-exact golden
oracle, the artifact store, stages 1-2, the compare report, the analysis
docs, image restore, the synthetic corpus, image IO, status logging and
the stage timer.  Nothing under ``kernels/``, ``ops/fir1d.py``,
``ops/fir2d.py``, ``ops/streaming.py``, ``parallel/`` or
``utils/benchmarking.py`` may be imported here: those import jax.
"""

from __future__ import annotations

from warmup_fir_filter_tpu.models.filters import FILTER_BANKS, filter_bank
from warmup_fir_filter_tpu.models.golden import fir1d_fixed_golden_rows
from warmup_fir_filter_tpu.ops.qformat import (
    QFormat,
    bias_round_shift_np,
    saturate_pixel_np,
    wrap_to_acc_bits_np,
)
from warmup_fir_filter_tpu.pipeline.analysis import (
    generate_analysis_doc,
    generate_comparison_doc,
)
from warmup_fir_filter_tpu.pipeline.artifacts import (
    ArtifactStore,
    save_npy,
    write_json,
)
from warmup_fir_filter_tpu.pipeline.report import generate_compare_report
from warmup_fir_filter_tpu.pipeline.restore import restore_images
from warmup_fir_filter_tpu.pipeline.stages import (
    _load_input_u8 as load_input_u8,
    generate_ideal_outputs,
    generate_input_vectors,
)
from warmup_fir_filter_tpu.pipeline.synthetic import (
    _render as render_image,
    synthesize_corpus,
)
from warmup_fir_filter_tpu.utils.imageio import save_gray_png
from warmup_fir_filter_tpu.utils.logging import stage_line
from warmup_fir_filter_tpu.utils.profiling import StageTimer

__all__ = [
    "FILTER_BANKS",
    "ArtifactStore",
    "QFormat",
    "StageTimer",
    "bias_round_shift_np",
    "filter_bank",
    "fir1d_fixed_golden_rows",
    "generate_analysis_doc",
    "generate_compare_report",
    "generate_comparison_doc",
    "generate_ideal_outputs",
    "generate_input_vectors",
    "load_input_u8",
    "render_image",
    "restore_images",
    "save_gray_png",
    "saturate_pixel_np",
    "save_npy",
    "stage_line",
    "synthesize_corpus",
    "wrap_to_acc_bits_np",
    "write_json",
]
