"""AdamW with grad clipping, cosine schedule, optional int8 grad
compression — port of `repro.optim.adamw`.

Moments are f32; params may be bf16 (the update is computed in f32 and
cast to the parameter's dtype). `compress=True` quantizes each gradient
leaf to int8 with a per-leaf scale and keeps the residual as error
feedback, as the reference does.

The state has the reference's keys: `m` and `v` (f32 trees keyed as the
parameters), `step` (an int32 scalar tensor) and `err` (`None` unless
compressing). A parameter tree is a `transformer.Transformer` (any
`nn.Module` whose parameter names are `model_spec`'s paths) or a nested
dict of tensors; gradient and moment trees are nested dicts with the same
paths. `apply_updates` updates the parameters and the state IN PLACE
under `torch.no_grad()`, leaf by leaf, and returns them (ROADMAP.md §C
(18)): the clip factor comes from the global norm first, then each leaf
is updated with the reference's arithmetic, so the step holds no second
f32 copy of every gradient. It consumes the gradients: an f32 gradient
leaf is overwritten.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.models.common import tree_leaves, tree_nest


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    compress: bool = False


def schedule(c: AdamWConfig, step):
    """Linear warmup, then a cosine from `lr` down to `min_lr_frac * lr`:
    an f32 scalar tensor on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(c.warmup_steps, 1)
    t = (step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = c.min_lr_frac + (1 - c.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return c.lr * torch.where(step < c.warmup_steps, warm, cos)


def leaves(tree) -> dict:
    """{dotted path: tensor} of a parameter tree (a module's named
    parameters, or a nested dict's leaves)."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return dict(tree_leaves(tree))


def _zeros(params) -> dict:
    """f32 zeros of each leaf's shape (a DTensor leaf's in its placements)."""
    return tree_nest({k: torch.zeros_like(p, dtype=torch.float32,
                                          memory_format=torch.preserve_format)
                      .detach()
                      for k, p in leaves(params).items()})


def init_state(params):
    """m, v in f32 beside each leaf and the step count; over DTensor
    parameters the step is a replicated DTensor on their mesh."""
    first = next(iter(leaves(params).values()))
    step = torch.zeros((), dtype=torch.int32,
                       device=getattr(first, "to_local", lambda: first)().device)
    if hasattr(first, "device_mesh"):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = first.device_mesh
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return {"m": _zeros(params), "v": _zeros(params), "step": step,
            "err": None}


def init_state_with_error_feedback(params):
    s = init_state(params)
    s["err"] = _zeros(params)
    return s


def _quantize_int8(g):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def global_norm(tree):
    sq = sum(torch.sum(torch.square(g.float()))
             for g in leaves(tree).values())
    return torch.sqrt(sq)


def _dequantized(g, e):
    """(int8-dequantized g + e, g + e), both f32."""
    ge = g.float() + e
    q, s = _quantize_int8(ge)
    return q.float() * s, ge


@torch.no_grad()
def apply_updates(c: AdamWConfig, params, grads, state, *, decay=None):
    """One AdamW step, in place. Returns (params, state, metrics).

    Weight decay applies to the paths in `decay`; by default to the leaves
    of rank >= 2, the reference's rule on the tree it is given. A model
    whose layers the reference stacks passes the paths whose leaves have
    rank >= 2 there (`convert.decayed_paths`)."""
    ps, gs = leaves(params), leaves(grads)
    ms, vs = leaves(state["m"]), leaves(state["v"])
    es = (leaves(state["err"]) if c.compress and state["err"] is not None
          else None)

    # the global norm of the (dequantized) f32 gradients, leaf by leaf
    sq = 0
    for path in ps:
        g = (gs[path].float() if es is None
             else _dequantized(gs[path], es[path])[0])
        sq = sq + torch.sum(torch.square(g))
        del g
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    state["step"] += 1
    step = state["step"].float()
    lr = schedule(c, state["step"])
    b1c = 1 - c.beta1 ** step
    b2c = 1 - c.beta2 ** step
    for path, p in ps.items():
        if es is None:
            g = gs[path].float()
        else:   # int8 + error feedback: remember the residual
            g, ge = _dequantized(gs[path], es[path])
            torch.sub(ge, g, out=es[path])
            del ge
        g.mul_(scale)
        m, v = ms[path], vs[path]
        t = g * (1 - c.beta2)
        t.mul_(g)
        v.mul_(c.beta2).add_(t)
        g.mul_(1 - c.beta1)
        m.mul_(c.beta1).add_(g)
        torch.div(m, b1c, out=g)                      # mh
        torch.div(v, b2c, out=t)                      # vh
        g.div_(t.sqrt_().add_(c.eps))                 # delta
        p32 = p if p.dtype == torch.float32 else t.copy_(p)
        if (p.dim() >= 2) if decay is None else (path in decay):
            g.add_(p32 * c.weight_decay)
        g.mul_(lr)
        if p32 is p:
            p.sub_(g)
        else:
            p.copy_(p32.sub_(g))
        del g, t
    return params, state, {"grad_norm": gnorm, "lr": lr}
