"""PyTorch calls that compute a hand-written kernel's function, timed beside
it as its library call (``chip_smoke.py``'s ``library_ms``,
``warmup_fir_filter_tpu_torch/probe_kernels.py times``) and used nowhere in
the port.  Only torch and numpy are imported, so that the probe can time
any checkout's port against them.

- :func:`conv1d_resampler` and :func:`conv1d_resample`: kernel I's
  polyphase P/Q resampler as one ``F.conv1d`` at stride Q with P output
  channels, interleaved.
"""

import numpy as np
import torch
import torch.nn.functional as F


def conv1d_resampler(rs):
    """``F.conv1d`` weights that compute kernel I's function: output
    ``P k + o`` of a row is output channel o at position k of the row
    convolved at stride Q, with branch ``(o Q + c) mod P``'s taps placed at
    its anchor offset ``(o Q + c) // P``.  Returns ``(weight, left pad)``;
    :func:`conv1d_resample` applies them."""
    up, down, center, count = rs.up, rs.down, rs.center, rs.branch_len
    beta = [(o * down + center) // up for o in range(up)]
    pad = count - 1 - min(beta)
    taps = rs.taps.cpu().double().numpy()
    weight = np.zeros((up, 1, max(beta) + pad + 1))
    for o in range(up):
        branch = (o * down + center) % up
        for j in range(count):
            weight[o, 0, beta[o] - j + pad] = taps[branch, j]
    return torch.as_tensor(weight, dtype=torch.float32,
                           device=rs.taps.device), pad


def conv1d_resample(x, weight, pad: int, rs):
    """Kernel I's function through PyTorch: pad, ``F.conv1d`` at stride Q
    with P output channels, interleave (three calls, TF32 as the caller
    sets it)."""
    rows, n = x.shape
    out_len = rs.out_len(n)
    per = -(-out_len // rs.up)
    right = max(0, (per - 1) * rs.down + weight.shape[-1] - n - pad)
    out = F.conv1d(F.pad(x.unsqueeze(1), (pad, right)), weight,
                   stride=rs.down)[:, :, :per]
    return out.transpose(1, 2).reshape(rows, -1)[:, :out_len]
