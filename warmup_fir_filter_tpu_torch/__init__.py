"""warmup_fir_filter_tpu_torch — the PyTorch/CUDA port of the FIR framework.

A second package beside ``warmup_fir_filter_tpu`` (the JAX reference,
left untouched).  It runs the reference's 5-stage verification pipeline
with the fixed-point stage on an NVIDIA Hopper GPU, through kernels
written by hand in CUDA C++ (``csrc/``), and holds every fixed output bit
for bit against the reference.

Layout
------
- ``reference.py``  the JAX-free modules of the JAX package, reused by
                    import (the only door into that package)
- ``_build.py``     nvcc → ``libwft_kernels.so`` → ctypes, at first use
- ``ops/``          plain PyTorch FIR paths (the kernels' plain versions)
- ``kernels/``      the CUDA kernels' wrappers, parameters and dispatch
- ``pipeline/``     the fixed-output stage
- ``cli.py``        the pipeline CLI (``python -m warmup_fir_filter_tpu_torch``)

Every function takes its device from its tensors or an explicit
``device`` argument: a CUDA tensor runs a kernel or raises, a CPU tensor
runs the plain PyTorch version.
"""

from warmup_fir_filter_tpu_torch.reference import QFormat

__version__ = "0.1.0"

__all__ = ["QFormat", "__version__"]
