"""Sharding glue — port of `repro.launch.sharding`: logical-axis rules per
(mesh, config, shape) and the shardings of the train / prefill / decode
steps' parameters, optimizer state, batches and caches. This is the one
place where the parallelism layout is decided; a layout is a rule-table
swap.

A sharding is a `Sharding` (the mesh, the sanitized `PartitionSpec` and
its DTensor placements), the counterpart of the reference's
`NamedSharding`. The port's model keeps one module per layer where the
reference stacks a `period` of layers (`models.convert`): its trees have
no `layers` axis (whose rule is None), so each layer's leaves get the
reference's layout. `distribute_params`, `distribute_opt_state` and
`distribute` place a model, an optimizer state and a tensor onto the
mesh by these shardings, each rank keeping only its shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import transformer
from repro_torch.models.common import (
    TP_RULES, P, mesh_shape, placements, sanitized_pspecs, tree_map,
    tree_shapes,
)
from repro_torch.models.moe import ShardCtx


def make_rules(mesh, cfg: ModelConfig, shape: ShapeSpec | None = None,
               *, layout: str = "tp") -> dict[str, Any]:
    """Logical-axis -> mesh-axis mapping.

    layout="tp"  : baseline — model axis carries heads/mlp/vocab, batch on dp.
    layout="fsdp": weights sharded on their embed dim over the model axis
                   (ZeRO-3), gathered per use.
    layout="mixer_dp": replicated mixer weights (heads), TP elsewhere.
    layout="ep"  : the expert bank over the model axis.
    layout="zero3": pure data parallelism over every axis, weights and
                   optimizer state sharded over all of them.
    Long-context decode (batch < dp size) flips to sequence parallelism:
    batch replicated, kv cache sharded on seq over "data"."""
    dp = dp_axes(mesh)
    names = _axis_names(mesh)
    rules = dict(TP_RULES)
    if layout == "fsdp":
        rules.update(embed="model", vocab="model", mlp=None, heads=None,
                     experts="model")
    elif layout == "mixer_dp":
        rules["heads"] = None
    elif layout == "ep":
        rules["experts"] = "model"
    elif layout == "zero3":
        dpall = tuple(a for a in ("pod", "data", "model") if a in names)
        rules.update(embed=dpall, vocab=dpall, mlp=None, heads=None,
                     experts=dpall)
    rules["batch"] = dp
    if layout == "zero3":
        rules["batch"] = tuple(a for a in ("pod", "data", "model")
                               if a in names)
    rules["seq"] = None
    rules["kv_seq"] = None
    if shape is not None:
        sizes = mesh_shape(mesh)
        dp_total = 1
        for a in dp:
            dp_total *= sizes[a]
        if shape.global_batch < dp_total:
            # SP: replicate batch, shard the long KV/sequence dim over "data"
            rules["batch"] = None
            rules["kv_seq"] = "data"
    return rules


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names else tuple(mesh_shape(mesh))


def make_ctx(mesh, cfg: ModelConfig, shape: ShapeSpec | None = None,
             *, layout: str = "tp") -> ShardCtx:
    base = "tp" if layout == "sp" else layout
    rules = make_rules(mesh, cfg, shape, layout=base)
    residual = None
    if layout == "zero3":
        residual = P(rules["batch"], None, None)
    return ShardCtx(mesh=mesh, dp=dp_axes(mesh), tp="model", rules=rules,
                    sp_residual=(layout == "sp"), residual_spec=residual)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh, a sanitized PartitionSpec and the spec's DTensor
    placements (the reference's `NamedSharding`)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def named(mesh, spec) -> Sharding:
    return Sharding(mesh, P(*spec))


def _sanitized_shardings(mesh, spec_tree, rules) -> Any:
    return tree_map(lambda ps: named(mesh, ps),
                    sanitized_pspecs(spec_tree, rules, mesh))


def param_shardings(mesh, cfg: ModelConfig, rules) -> Any:
    return _sanitized_shardings(mesh, transformer.model_spec(cfg), rules)


def param_structs(cfg: ModelConfig) -> Any:
    return tree_shapes(transformer.model_spec(cfg))


def opt_state_shardings(mesh, cfg: ModelConfig, rules, param_sh) -> Any:
    return {
        "m": param_sh, "v": param_sh,
        "step": named(mesh, P()),
        "err": None,
    }


def opt_state_structs(cfg: ModelConfig) -> Any:
    ps = param_structs(cfg)
    f32 = lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta")
    return {"m": tree_map(f32, ps), "v": tree_map(f32, ps),
            "step": torch.empty((), dtype=torch.int32, device="meta"),
            "err": None}


def batch_shardings(mesh, cfg: ModelConfig, shape: ShapeSpec | None, rules,
                    specs: dict) -> dict:
    """Shardings for `input_specs()` outputs (or a batch of tensors)."""
    bspec = rules["batch"]
    out = {}
    for k in specs:
        if k in ("tokens", "labels"):
            out[k] = named(mesh, P(bspec, None))
        elif k == "positions":            # (3, B, S) with M-RoPE, else (B, S)
            v = specs[k]
            nd = len(v[0]) if isinstance(v, tuple) else v.ndim
            out[k] = named(mesh, P(None, bspec, None) if nd == 3
                           else P(bspec, None))
        elif k == "frames":               # (B, S_enc, D)
            out[k] = named(mesh, P(bspec, None, None))
        elif k == "cache_len":
            out[k] = named(mesh, P())
        else:
            raise KeyError(k)
    return out


def cache_shardings(mesh, cfg: ModelConfig, b: int, s: int, rules) -> Any:
    return [_sanitized_shardings(mesh, spec, rules)
            for spec in transformer.cache_spec(cfg, b, s)]


def cache_structs(cfg: ModelConfig, b: int, s: int) -> Any:
    return [tree_shapes(spec) for spec in transformer.cache_spec(cfg, b, s)]


# ---------------------------------------------------------------------------
# placing tensors


def distribute(t: torch.Tensor, sh: Sharding):
    """A DTensor of the full tensor `t` by `sh`: every rank keeps its own
    shard, sliced locally (no collective); meta stays meta."""
    from torch.distributed.tensor import DTensor, Shard

    local = t
    mesh = sh.mesh
    for i, pl in enumerate(sh.placements):
        if isinstance(pl, Shard):
            n = local.shape[pl.dim] // mesh.size(i)
            local = local.narrow(pl.dim, mesh.get_local_rank(i) * n, n)
    if local is not t:
        local = local.contiguous()
    return DTensor.from_local(local, mesh, sh.placements, run_check=False)


def _shardings_by_path(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shardings_by_path(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def distribute_params(model, mesh, cfg: ModelConfig, rules):
    """Replace each parameter of `model` (a `transformer.Transformer`) by
    an `nn.Parameter` over its DTensor, in place, by `param_shardings`;
    returns the model."""
    by_path = _shardings_by_path(param_shardings(mesh, cfg, rules))
    for path, sh in by_path.items():
        *mods, name = path.split(".")
        mod = model
        for m in mods:
            mod = mod[int(m)] if m.isdigit() else getattr(mod, m)
        old = mod._parameters[name]
        mod._parameters[name] = torch.nn.Parameter(
            distribute(old.detach(), sh), requires_grad=old.requires_grad)
    return model


def distribute_opt_state(state, mesh, cfg: ModelConfig, rules, param_sh):
    """An AdamW state of full tensors placed by `opt_state_shardings`."""
    sh = opt_state_shardings(mesh, cfg, rules, param_sh)
    flat = _shardings_by_path(param_sh)
    out = {"err": None, "step": distribute(state["step"], sh["step"])}
    for key in ("m", "v"):
        leaves = _shardings_by_path(state[key])
        out[key] = _nest({p: distribute(t, flat[p])
                          for p, t in leaves.items()})
    return out


def distribute_cache(cache, mesh, cfg: ModelConfig, b: int, s: int, rules):
    """A cache (a list of per-layer dicts of full tensors) placed by
    `cache_shardings`."""
    shs = cache_shardings(mesh, cfg, b, s, rules)
    return [{k: distribute(t, sh[k]) for k, t in layer.items()}
            for layer, sh in zip(cache, shs)]


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, val in flat.items():
        *head, last = path.split(".")
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[last] = val
    return out

