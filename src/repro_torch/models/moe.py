"""Dense FFN layers — the SwiGLU and GELU halves of `repro.models.moe`.

Gate/up projections are stored (d, 2, f), never fused (d, 2f), as in the
reference, so a tensor-parallel cut of f never splits across the gate/up
boundary. Mixture-of-Experts routing is ROADMAP.md §A9 (iii).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, Tree, promote


def swiglu_spec(d: int, f: int) -> Tree:
    return {
        "wi": ParamSpec((d, 2, f), ("embed", "null", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def swiglu(p: Tree, x):
    """silu(x @ wi[:, 0]) * (x @ wi[:, 1]) @ wo, as one product with the
    (d, 2, f) table viewed (d, 2f)."""
    x, wi = promote(x, p["wi"])
    d, _, f = wi.shape
    u = (x @ wi.reshape(d, 2 * f)).unflatten(-1, (2, f))
    return torch.matmul(*promote(F.silu(u[..., 0, :]) * u[..., 1, :],
                                 p["wo"]))


def gelu_mlp_spec(d: int, f: int) -> Tree:
    return {
        "wi": ParamSpec((d, f), ("embed", "mlp")),
        "bi": ParamSpec((f,), ("mlp",), init="zeros", dtype=torch.float32),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
        "bo": ParamSpec((d,), ("embed",), init="zeros", dtype=torch.float32),
    }


def gelu_mlp(p: Tree, x):
    """jax.nn.gelu's default is the tanh approximation; so is this one."""
    h = torch.matmul(*promote(x, p["wi"]))
    h = F.gelu(h + p["bi"].to(x.dtype), approximate="tanh")
    return torch.matmul(*promote(h, p["wo"])) + p["bo"].to(x.dtype)
