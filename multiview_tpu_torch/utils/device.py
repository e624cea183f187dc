"""Device and working-dtype choice for the port.

The port computes in float32 on CUDA (the card's working type) and in
float64 on the CPU, where the parity tests hold it against the JAX package
under x64."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The first CUDA card. The port never chooses the CPU by itself: with
    no CUDA device this raises, and the caller names the CPU explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "multiview_tpu_torch runs on an NVIDIA GPU and found no CUDA device. To run "
            "on the CPU, ask for it: --device cpu on the command line, device=\"cpu\" in "
            "the Python entry points.")
    return torch.device("cuda", 0)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; ``None`` and ``"cuda"`` mean the first
    CUDA card (``default_device``), which raises when there is none."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and (device.index is None or not torch.cuda.is_available()):
        return default_device()   # cuda:0, or raises naming the remedy
    return device


def indexed_device(device) -> torch.device:
    """``device`` with its index: a bare ``"cuda"`` names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def working_dtype(device) -> torch.dtype:
    """float32 on CUDA, float64 on the CPU."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


_CPU_BUDGET_BYTES = 256 << 20


def rows_that_fit(n: int, bytes_per_row: int, device) -> int:
    """How many of ``n`` rows to process at once: all of them where a quarter
    of the device's free memory holds ``bytes_per_row`` for each, else as
    many as it holds (at least one). On the CPU the budget is 256 MiB."""
    device = torch.device(device)
    budget = (torch.cuda.mem_get_info(device)[0] // 4 if device.type == "cuda"
              else _CPU_BUDGET_BYTES)
    return int(max(1, min(n, budget // max(bytes_per_row, 1))))
