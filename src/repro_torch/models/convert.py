"""Weights and caches between the reference's layout and the port's.

The reference keeps decoder layers stacked: parameters under
`prefix.<i>` (unscanned) and `period.<j>` (leaves with a leading
`n_periods` dim), caches the same way. The port keeps one entry per
decoder layer: parameters as `layers.<i>.<...>` in a `Transformer`'s
state dict, caches as a list of per-layer dicts. Decoder layer `i` is
prefix `i` for `i < P`, else period position `j` of period `p`, where
`i = P + p * len(period) + j`. whisper's encoder layers are stacked under
`enc.blk` in the reference and are `enc.layers.<i>` here; `enc.ln_f` and
`pos_emb` carry across as they are, and a layer's cross K/V (`ck`, `cv`)
sits in its cache beside the self K/V in both layouts.

Into the port, leaves may be numpy arrays (the reference's) or tensors
(a checkpoint's); out of it, they are host tensors. `_to_numpy` carries
such a tensor to numpy, bfloat16 bit for bit through int16 into numpy's
registered `bfloat16` dtype (ml_dtypes', which the reference's arrays
carry); it raises if no such dtype is registered.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.common import tree_leaves, tree_map, tree_nest

_TOP = ("emb", "ln_f", "pos_emb")
_STACKS = ("prefix", "period", "enc")


def _to_torch(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError as e:
            raise TypeError("a bfloat16 leaf needs numpy's bfloat16 dtype "
                            "registered (import ml_dtypes)") from e
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()


def _layer_trees(tree) -> list:
    """The reference's per-layer subtrees in decoder order."""
    prefix = tree.get("prefix", {})
    layers = [prefix[str(i)] for i in range(len(prefix))]
    period = tree.get("period", {})
    if period:
        per = [_unstack(period[str(j)]) for j in range(len(period))]
        for p in range(len(per[0])):
            layers.extend(per[j][p] for j in range(len(period)))
    return layers


def _stack_layers(layers: list, cfg) -> dict:
    """Per-layer subtrees of tensors -> the reference's prefix/period."""
    prefix, period, n = cfg.layer_groups()
    out = {}
    if prefix:
        out["prefix"] = {str(i): layers[i] for i in range(len(prefix))}
    if n:
        base, width = len(prefix), len(period)
        out["period"] = {}
        for j in range(width):
            group = [layers[base + p * width + j] for p in range(n)]
            out["period"][str(j)] = _stack(group)
    return out


def _stack(group: list) -> dict:
    return {k: _stack([g[k] for g in group]) if isinstance(v, dict)
            else torch.stack([g[k] for g in group])
            for k, v in group[0].items()}


def _nest(flat: dict, prefix: str) -> dict:
    """{'a.b': x} with keys under `prefix` -> {'a': {'b': x}}."""
    return tree_nest({k[len(prefix):]: v for k, v in flat.items()
                      if k.startswith(prefix)})


def _unstack(tree) -> list:
    """Leaves with a leading layer dim -> one subtree per layer."""
    n = next(iter(tree_leaves(tree)))[1].shape[0]
    return [tree_map(lambda a: a[i], tree) for i in range(n)]


def params_from_reference(tree) -> dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy leaves) -> a `Transformer`
    state dict."""
    extra = set(tree) - {*_TOP, *_STACKS}
    if extra:
        raise ValueError(f"parameters {sorted(extra)} have no place in the "
                         "port's model")
    out = {path: _to_torch(a) for path, a in tree_leaves(
        {k: tree[k] for k in _TOP if k in tree})}
    layers = [(f"layers.{i}.", lt) for i, lt in enumerate(_layer_trees(tree))]
    if "enc" in tree:
        layers += [(f"enc.layers.{i}.", lt)
                   for i, lt in enumerate(_unstack(tree["enc"]["blk"]))]
        layers.append(("enc.ln_f.", tree["enc"]["ln_f"]))
    for prefix, lt in layers:
        out.update((path, _to_torch(a)) for path, a in tree_leaves(lt, prefix))
    return out


def params_to_reference(state, cfg) -> dict:
    """A `Transformer` (or its state dict, or any dict keyed by its
    parameter paths) -> the reference's parameter tree of host tensors,
    stacked as `cfg.layer_groups()` says (the encoder under `enc.blk`)."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    flat = {k: v.detach().cpu() for k, v in state.items()}
    top = _nest(flat, "")
    tree = {k: top[k] for k in _TOP if k in top}
    tree.update(_stack_layers([_nest(flat, f"layers.{i}.")
                               for i in range(cfg.n_layers)], cfg))
    if cfg.is_encdec:
        tree["enc"] = {"blk": _stack([_nest(flat, f"enc.layers.{i}.")
                                      for i in range(cfg.encoder_layers)]),
                       "ln_f": top["enc"]["ln_f"]}
    return tree


def cache_from_reference(tree) -> list[dict]:
    """The reference's cache tree -> the port's per-layer list."""
    return [tree_map(_to_torch, lt) for lt in _layer_trees(tree)]


def cache_to_reference(cache: list[dict], cfg) -> dict:
    """The port's per-layer cache list -> the reference's cache tree of
    host tensors."""
    return _stack_layers([tree_map(lambda t: t.detach().cpu(), c)
                          for c in cache], cfg)


def decayed_paths(state, cfg) -> set[str]:
    """The parameter paths AdamW decays: those whose leaf has rank >= 2 in
    the reference's layout, where a decoder layer stacked under `period`
    carries the leading `n_periods` dim and one under `prefix` does not
    (`cfg.layer_groups()`), and every encoder layer (`enc.blk`) carries
    the leading `encoder_layers` dim."""
    if isinstance(state, nn.Module):
        state = dict(state.named_parameters())
    first = len(cfg.layer_groups()[0])

    def rank(path, t):
        head, _, rest = path.partition(".")
        stacked = ((head == "layers" and int(rest.split(".")[0]) >= first)
                   or (head == "enc" and rest.startswith("layers.")))
        return t.dim() + stacked
    return {k for k, t in state.items() if rank(k, t) >= 2}
