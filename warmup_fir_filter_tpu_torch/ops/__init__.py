"""Plain PyTorch FIR paths (the kernels' plain versions)."""
