"""The drivers of the traffic mixes, one module each, named by a traffic
file's ``driver``; and what they share about the device."""

from __future__ import annotations

from portbench.common import card
from portbench.trace import busy_and_window_s


def device_of(cell):
    """The card (``cuda:0``, or the rank's) or, for a dry run, the host."""
    import torch

    if cell.dry:
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def sync_of(device):
    """A function that waits for the device's work (nothing on the host)."""
    import torch

    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def memory_peak(device) -> int:
    """The process's peak of allocated device memory (0 on the host)."""
    import torch

    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def device_info(device, peak: int, trace=None, count: int = 1) -> dict:
    """The result's ``device`` object: the card's name, the cards used, the
    peak on the fullest, the card's name and power limit from
    ``nvidia-smi`` (``card``), and with a trace ``busy_s`` and
    ``window_s``."""
    if device.type == "cuda":
        info = {"platform": "gpu", "count": count,
                "memory_peak_bytes": peak, **card(device.index)}
    else:
        info = {"platform": "cpu", "kind": "host (a dry run: no measurement)",
                "count": count, "memory_peak_bytes": 0}
    if trace is not None:
        busy_window = busy_and_window_s(trace)
        if busy_window is not None:
            info["busy_s"], info["window_s"] = busy_window
    return info
