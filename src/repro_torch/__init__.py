"""PyTorch/CUDA port of the matrix-profile system in `repro`.

Mirrors `repro`'s layout (`core/`, `kernels/`, ...) module for module. It
imports torch and numpy, never jax and nothing of `repro`. Entry points run
on the CUDA card unless the caller passes `device="cpu"`
(`utils.device.resolve_device`). It covers the exact self-join and AB join
(z-normalized at k = 1 through a hand-written CUDA NATSA kernel; top-k, raw
and batched sweeps through torch tensor ops), streaming, the fleet,
checkpoints, the profile service (`serve`), and causal/full flash attention
through a hand-written CUDA kernel (`kernels.flash_attn`).
"""

from repro_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
