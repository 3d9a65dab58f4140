"""warmup_fir_filter_tpu_torch — the PyTorch/CUDA port of the FIR framework.

A second package beside ``warmup_fir_filter_tpu`` (the JAX reference,
left untouched).  It runs the reference's 5-stage verification pipeline
with the fixed-point stage on an NVIDIA Hopper GPU, the streaming and 2-D
paths, and the DSP chain (resample → channelize → FM demod), through
kernels written by hand in CUDA C++ (``csrc/``), and holds every output
against the reference.  It imports nothing of the JAX package: the numpy
modules it shares with it (Q-format arithmetic, the golden oracle, the
artifact store, reports, restore, the synthetic corpus, image IO, status
lines) are copies kept under the JAX package's names and paths.

Layout
------
- ``_build.py``     nvcc → ``libwft_kernels.so`` → ctypes, at first use
- ``ops/``          plain PyTorch paths (the kernels' plain versions), the
                    Q-format and validation copies
- ``kernels/``      the CUDA kernels' wrappers, parameters and dispatch
- ``models/``       the filter banks, the golden oracle, the DSP chain
- ``pipeline/``     the 5-stage pipeline's stages, store and reports
- ``utils/``        image IO, status lines, the stage timer
- ``cli.py``        the pipeline CLI (``python -m warmup_fir_filter_tpu_torch``)
- ``benches/``      the root benches' counterparts on the card
                    (``python -m warmup_fir_filter_tpu_torch.benches.<name>``)

Every function takes its device from its tensors or an explicit
``device`` argument: a CUDA tensor runs a kernel or raises, a CPU tensor
runs the plain PyTorch version.
"""

from warmup_fir_filter_tpu_torch.ops.qformat import QFormat

__version__ = "0.1.0"

__all__ = ["QFormat", "__version__"]
