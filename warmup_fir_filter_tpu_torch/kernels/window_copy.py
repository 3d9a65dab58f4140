"""Kernel D: overlapping sub-row windows of a stream block (ports K5).

Counterpart of ``warmup_fir_filter_tpu/kernels/window_copy.py``.  The
windowed streaming step (``ops/streaming.py``) cuts each ``(C, T)`` block
into ``R = T / sub`` windows per channel so that the band FIR runs over
``R·C`` rows instead of ``C``.  The layout is the TPU kernel's:
window-major (row ``r·C + c`` is window ``r`` of channel ``c``), each row
``sub + 256`` samples, covering columns ``[r·sub − 128, r·sub + sub + 128)``
of the virtual stream ``carry_ext ‖ x ‖ zeros``.

:func:`window_rows` launches ``csrc/window_copy.cu`` on a CUDA tensor; on
a CPU tensor it runs :func:`window_rows_plain`, torch indexing on the
padded stream.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from warmup_fir_filter_tpu_torch import _build

LANE = 128


def window_rows_supported(channels: int, total: int, sub: int,
                          num_taps: int) -> bool:
    """Geometry gate: lane-aligned sub-rows, one-tile halos cover L
    (``window_copy.py:40-44``)."""
    return (sub % LANE == 0 and sub > 0 and total % sub == 0
            and 1 <= num_taps <= LANE + 1 and channels >= 1)


def _check_geometry(x_u8: torch.Tensor, carry_ext_u8: torch.Tensor,
                    sub: int, g_windows: int) -> None:
    _build.check_rows_u8(x_u8)
    _build.check_rows_u8(carry_ext_u8)
    channels, total = x_u8.shape
    if tuple(carry_ext_u8.shape) != (channels, LANE):
        raise ValueError(f"carry_ext must be ({channels}, {LANE}), got "
                         f"{tuple(carry_ext_u8.shape)}")
    _build.check_same_device(x_u8, carry_ext_u8, "carry_ext")
    if not window_rows_supported(channels, total, sub, 1):
        raise ValueError(f"no window geometry: sub={sub} must be a positive "
                         f"multiple of {LANE} dividing T={total}")
    if g_windows < 1 or (total // sub) % g_windows:
        raise ValueError(f"g_windows={g_windows} must divide the "
                         f"{total // sub} windows")


def window_rows_plain(x_u8: torch.Tensor, carry_ext_u8: torch.Tensor,
                      sub: int, g_windows: int = 1) -> torch.Tensor:
    """Kernel D's plain version: gather the windows from the padded stream.

    Runs on the device of its inputs.
    """
    _check_geometry(x_u8, carry_ext_u8, sub, g_windows)
    channels, total = x_u8.shape
    windows = total // sub
    width = sub + 2 * LANE
    stream = F.pad(torch.cat([carry_ext_u8, x_u8], dim=1), (0, LANE))
    idx = (torch.arange(windows, device=x_u8.device)[:, None] * sub
           + torch.arange(width, device=x_u8.device)[None, :])
    return stream[:, idx].transpose(0, 1).reshape(windows * channels, width)


def window_rows(x_u8: torch.Tensor, carry_ext_u8: torch.Tensor, sub: int,
                g_windows: int) -> torch.Tensor:
    """``(C, T)`` u8 → ``(R·C, sub + 256)`` u8 windows, ``R = T / sub``.

    Kernel D on a CUDA tensor; :func:`window_rows_plain` on a CPU tensor.
    ``g_windows`` (windows per TPU program) is checked as the JAX function
    checks it and does not shape the CUDA grid.  Raises on a bad geometry,
    a non-contiguous or misaligned CUDA tensor, a failed build or a failed
    launch.  Counts its launches in ``window_rows.launches``.
    """
    _check_geometry(x_u8, carry_ext_u8, sub, g_windows)
    if x_u8.device.type == "cpu":
        return window_rows_plain(x_u8, carry_ext_u8, sub, g_windows)
    _build.check_launchable(x_u8)
    _build.check_launchable(carry_ext_u8)
    if x_u8.data_ptr() % 16 or carry_ext_u8.data_ptr() % 16:
        raise ValueError("window_rows needs 16-byte aligned x and carry_ext")
    channels, total = x_u8.shape
    out = torch.empty((total // sub * channels, sub + 2 * LANE),
                      dtype=torch.uint8, device=x_u8.device)
    lib = _build.load_library()
    with torch.cuda.device(x_u8.device):
        code = lib.wft_window_rows(
            x_u8.data_ptr(), carry_ext_u8.data_ptr(), out.data_ptr(),
            channels, total, sub, _build.stream_of(x_u8),
        )
    _build.check_launch(lib, code, "window_rows")
    window_rows.launches += 1
    return out


window_rows.launches = 0


def window_rows_pallas(x_u8: torch.Tensor, carry_ext_u8: torch.Tensor,
                       sub: int, g_windows: int) -> torch.Tensor:
    """The JAX ``window_copy.py::window_rows_pallas`` entry (without its
    ``interpret`` flag): :func:`window_rows`, kernel D, on ``x_u8.device``
    (host arrays go to the card, ``_build.as_rows``)."""
    return window_rows(_build.as_rows(x_u8), _build.as_rows(carry_ext_u8),
                       sub, g_windows)
