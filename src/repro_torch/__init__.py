"""PyTorch/CUDA port of the matrix-profile system in `repro`.

Mirrors `repro`'s layout (`core/`, `kernels/`, ...) module for module. It
imports torch and numpy, never jax and nothing of `repro`. Entry points run
on the CUDA card unless the caller passes `device="cpu"`
(`utils.device.resolve_device`). Today it covers the exact z-normalized
self-join and AB join at k=1 through a hand-written CUDA NATSA kernel.
"""

from repro_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
