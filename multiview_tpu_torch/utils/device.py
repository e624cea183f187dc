"""Device and working-dtype choice for the port.

The port computes in float32 on CUDA (the card's working type) and in
float64 on the CPU, where the parity tests hold it against the JAX package
under x64."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The first CUDA card when one is present, otherwise the CPU."""
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def working_dtype(device) -> torch.dtype:
    """float32 on CUDA, float64 on the CPU."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
