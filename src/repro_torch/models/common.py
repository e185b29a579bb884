"""Model substrate: parameter specs, seeded init, norms, RoPE, dense layers —
port of `repro.models.common`.

A parameter tree is a nested dict whose leaves are `ParamSpec`s (shapes,
logical axes, init rule, dtype); `init_params` draws it from a
`torch.Generator` on the generator's device, and `ParamTree` holds such a
tree as an `nn.Module` whose `nn.Parameter`s carry the tree's keys, so
`p["wq"]["w"]` reads as in the reference. The logical axes are kept for
the sharding rules, which come with a mesh (ROADMAP.md §A9 (iv)); no rule
table is ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

# ---------------------------------------------------------------------------
# param specs


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str, ...]                 # logical axis per dim
    init: str = "fan_in"                  # fan_in | zeros | ones | normal | const
    scale: float = 1.0
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


Tree = dict[str, Any]


def tree_leaves(tree, prefix: str = ""):
    """(dotted path, leaf) pairs of a nested dict, in insertion order."""
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from tree_leaves(val, path + ".")
        else:
            yield path, val


def tree_nest(flat: dict) -> Tree:
    """{'a.b': x} -> {'a': {'b': x}}: the inverse of `tree_leaves`."""
    out: dict = {}
    for path, val in flat.items():
        *head, last = path.split(".")
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[last] = val
    return out


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _init_leaf(gen: torch.Generator, s: ParamSpec) -> torch.Tensor:
    """One leaf by the reference's rules (`repro/models/common.py:127-140`):
    normal draws are f32, scaled, then cast to the leaf's dtype."""
    dev = gen.device
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=dev)
    if s.init == "const":
        return torch.full(s.shape, s.scale, dtype=s.dtype, device=dev)
    if s.init == "normal":
        std = s.scale
    elif s.init == "fan_in":
        fan = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.scale / math.sqrt(max(fan, 1))
    else:
        raise ValueError(s.init)
    x = torch.randn(s.shape, generator=gen, dtype=torch.float32, device=dev)
    return x.mul_(std).to(s.dtype)


def init_params(gen: torch.Generator, spec: Tree) -> Tree:
    """A tensor for every leaf of `spec`, drawn in order from `gen` on
    `gen.device`."""
    return tree_map(lambda s: _init_leaf(gen, s), spec)


def empty_params(spec: Tree, device) -> Tree:
    """Uninitialized tensors for every leaf (to be overwritten by a
    `load_state_dict`)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=device), spec)


def count_params(spec: Tree) -> int:
    return int(sum(math.prod(s.shape) for _, s in tree_leaves(spec)))


def stack_spec(spec: Tree, n: int) -> Tree:
    """Prepend a scanned `layers` dim to every leaf (the reference's
    scan-over-layers layout, which `models.convert` unstacks)."""
    return tree_map(lambda s: ParamSpec((n, *s.shape), ("layers", *s.axes),
                                        init=s.init, scale=s.scale,
                                        dtype=s.dtype), spec)


class ParamTree(nn.Module):
    """A parameter tree as a module: each dict node a submodule, each leaf
    an `nn.Parameter`, both under the tree's key; `p[key]` and `key in p`
    read as on the reference's dicts."""

    def __init__(self, tensors: Tree):
        super().__init__()
        for key, val in tensors.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(key, nn.Parameter(val))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules


# ---------------------------------------------------------------------------
# norms (weights kept f32; statistics f32; scale-multiplies in x's dtype)


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones", dtype=torch.float32)


def rmsnorm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w.to(x.dtype)


def layernorm_spec(d: int) -> Tree:
    return {"scale": ParamSpec((d,), ("embed",), init="ones",
                               dtype=torch.float32),
            "bias": ParamSpec((d,), ("embed",), init="zeros",
                              dtype=torch.float32)}


def layernorm(x, p, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return ((x - mu.to(x.dtype)) * inv * p["scale"].to(x.dtype)
            + p["bias"].to(x.dtype))


def make_norm(kind: str, d: int):
    if kind == "rmsnorm":
        return rmsnorm_spec(d), rmsnorm
    if kind == "layernorm":
        return layernorm_spec(d), layernorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# rotary embeddings (standard + M-RoPE)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x, ang):
    """x (..., S, H, Dh) rotated by angles (..., S, Dh/2), split-half
    convention, in f32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin,
                      xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, Dh), positions: (..., S) int. Split-half convention;
    the rotation in f32, cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)   # (half,)
    return _rotate(x, positions[..., None].float() * freqs)


def _mrope_angles(positions3, sections, head_dim: int, theta: float):
    """M-RoPE's rotation angles (..., S, half) in f32: each frequency band
    of `sections` (half-dim units) takes its angle from one of the three
    position streams (t, h, w), picked by a gather, which equals the
    reference's one-hot einsum bit for bit (x·1 + 0 + 0 = x in f32)."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"half the head dim, {half}")
    dev = positions3.device
    freqs = rope_freqs(head_dim, theta, device=dev)               # (half,)
    band = torch.cat([torch.full((n,), i, dtype=torch.long, device=dev)
                      for i, n in enumerate(sections)])
    ang_all = positions3[..., None].float() * freqs           # (3, ..., S, half)
    idx = band.expand(1, *ang_all.shape[1:])
    return ang_all.gather(0, idx)[0]


def apply_mrope(x, positions3, sections: tuple[int, ...],
                theta: float = 1e4):
    """Qwen2-VL M-RoPE. x: (..., S, H, Dh); positions3: (3, ..., S) for the
    (t, h, w) streams; the frequency bands are split across the streams by
    `sections` (half-dim units, e.g. (16, 24, 24) for head_dim 128).
    Split-half rotation in f32, cast back to x's dtype."""
    return _rotate(x, _mrope_angles(positions3, sections, x.shape[-1],
                                    theta))


# ---------------------------------------------------------------------------
# misc


def promote(x, w):
    """x and w in their common dtype, as jnp's promotion gives it (an f32
    activation against a bf16 weight computes in f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def matmul(x, w):
    """x @ w in their common dtype (jnp's promotion)."""
    return torch.matmul(*promote(x, w))


def dense_spec(d_in: int, d_out: int, axes=("embed", "mlp"), *, bias=False,
               scale=1.0) -> Tree:
    s: Tree = {"w": ParamSpec((d_in, d_out), axes, scale=scale)}
    if bias:
        s["b"] = ParamSpec((d_out,), (axes[1],), init="zeros",
                           dtype=torch.float32)
    return s


def dense(x, p):
    y = torch.matmul(*promote(x, p["w"]))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y
