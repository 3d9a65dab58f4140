"""Plain PyTorch FIR paths (the kernels' plain versions), the Q-format and
validation copies."""

from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.ops import validation

__all__ = ["QFormat", "validation"]
