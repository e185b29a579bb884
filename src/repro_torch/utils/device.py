"""Device resolution shared by every entry point of the port.

The port's hot path is a CUDA kernel, so an entry point runs on the card
unless its caller asks for the host: `device=None` means `"cuda"`. A host
without CUDA raises instead of carrying on quietly on the CPU — a number
taken there would say nothing about the card.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda`; `"cpu"` stays on the host; any CUDA device must be
    present. Raises RuntimeError when CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available; pass device='cpu' to run on the host")
    return dev
