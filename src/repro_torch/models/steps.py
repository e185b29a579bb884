"""Step functions: train (microbatched), prefill, greedy decode — port of
`repro.models.steps`.

A step is a function of (params, [opt_state | cache,] batch), as in the
reference; params is a `transformer.Transformer` (or anything indexed as
its tree). The train step differentiates the loss with autograd and
updates the parameters and the optimizer state IN PLACE, returning them
(ROADMAP.md §C (18)). The serving steps run under `torch.no_grad()`. The
prefill step computes the logits of the last position only, the only ones
it returns: the reference computes all (B, S, V) logits first and slices
(ROADMAP.md §C (17)); the values are the same.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import convert, transformer
from repro_torch.models.common import tree_nest
from repro_torch.optim import adamw

AUX_WEIGHT = 0.01


def mask_padded_vocab(cfg, logits):
    """-1e30 on the padded logit columns (vocab padded to a multiple of 128)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab_size, logits,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device))


def cross_entropy(logits, labels):
    """Mean CE over tokens, f32 reductions."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = lg.gather(-1, labels[..., None].long())[..., 0]
    return (lse - ll).mean()


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        logits, aux, _ = transformer.forward(
            cfg, params, batch["tokens"], mode="train",
            positions=batch.get("positions"), frames=batch.get("frames"))
        ce = cross_entropy(mask_padded_vocab(cfg, logits), batch["labels"])
        return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}
    return loss_fn


def make_train_step(cfg: ModelConfig, opt: adamw.AdamWConfig, *,
                    microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics), with
    metrics `loss`, `ce`, `aux`, `grad_norm` and `lr` (0-dim tensors).

    `microbatches == 1` runs one backward; the gradients keep the
    parameters' dtypes (`adamw.apply_updates` casts them to f32).
    `microbatches > 1` splits the batch as the reference's `split_mb`
    ((B, ...) -> (mb, B/mb, ...)), runs one backward per microbatch and
    sums its gradients into f32 buffers, then divides by `mb`; loss and
    metrics are the microbatches' means. M-RoPE's (3, B, S) `positions`
    split on their batch axis (the reference's `steps.py:95`); whisper's
    `frames` (B, ...) as the tokens. Parameters and `opt_state` are
    updated in place and returned."""
    loss_fn = make_loss_fn(cfg)
    mb = microbatches

    def split_mb(batch):
        parts = {k: (x.reshape(3, mb, -1, *x.shape[2:]).unbind(1)
                     if k == "positions" and cfg.mrope_sections
                     else x.reshape(mb, -1, *x.shape[1:]).unbind(0))
                 for k, x in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(mb)]

    def grads_of(params, tensors, batch):
        with torch.enable_grad():
            loss, met = loss_fn(params, batch)
            # a parameter the loss does not reach gets zeros, as in jax
            grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), {k: x.detach() for k, x in met.items()}, grads

    def train_step(params, opt_state, batch):
        names, tensors = zip(*adamw.leaves(params).items())
        if mb == 1:
            loss, metrics, grads = grads_of(params, tensors, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in tensors]
            losses, mets = [], []
            for one in split_mb(batch):
                loss, met, g = grads_of(params, tensors, one)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                losses.append(loss)
                mets.append(met)
            for acc in grads:
                acc.div_(mb)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        params, opt_state, opt_metrics = adamw.apply_updates(
            opt, params, tree_nest(dict(zip(names, grads))), opt_state,
            decay=convert.decayed_paths(dict(zip(names, tensors)), cfg))
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """(params, batch{tokens (B, S)[, positions][, frames]}) ->
    (last-position logits (B, 1, V), cache: a list of per-layer caches,
    `transformer.layer_cache_spec`'s, with S slots where a leaf has a
    sequence axis; an encoder-decoder's encodes its `frames` and returns
    each layer's cross K/V)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        x, _, cache = transformer.trunk(cfg, params, batch["tokens"],
                                        mode="prefill",
                                        positions=batch.get("positions"),
                                        frames=batch.get("frames"))
        lg = transformer.head(cfg, params, x[:, -1:])
        return mask_padded_vocab(cfg, lg), cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, cache, batch{tokens (B, 1), cache_len}) -> (logits, cache);
    the cache is written in place (`attention.gqa_decode`,
    `attention.mla_decode`, `rwkv.time_mix_step`, `mamba.mamba_step`)."""

    @torch.no_grad()
    def decode_step(params, cache, batch):
        logits, _, new_cache = transformer.forward(
            cfg, params, batch["tokens"], mode="decode", cache=cache,
            cache_len=batch["cache_len"])
        return mask_padded_vocab(cfg, logits), new_cache

    return decode_step


def greedy_next(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
