"""Step functions of the serving path: prefill and greedy decode — port of
`repro.models.steps` (the loss forward included; the train step waits for
`optim/adamw.py`, ROADMAP.md §A9 (ii)).

A step is a function of (params, [cache,] batch), as in the reference;
params is a `transformer.Transformer` (or anything indexed as its tree).
The serving steps run under `torch.no_grad()`. The prefill step computes
the logits of the last position only, the only ones it returns: the
reference computes all (B, S, V) logits first and slices (ROADMAP.md §C
(17)); the values are the same.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

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
            positions=batch.get("positions"))
        ce = cross_entropy(mask_padded_vocab(cfg, logits), batch["labels"])
        return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}
    return loss_fn


def make_prefill_step(cfg: ModelConfig):
    """(params, batch{tokens (B, S)}) -> (last-position logits (B, 1, V),
    cache: a list of per-layer {k, v} of S slots)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        x, _, cache = transformer.trunk(cfg, params, batch["tokens"],
                                        mode="prefill",
                                        positions=batch.get("positions"))
        lg = transformer.head(cfg, params, x[:, -1:])
        return mask_padded_vocab(cfg, lg), cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, cache, batch{tokens (B, 1), cache_len}) -> (logits, cache);
    the cache is written in place (`attention.gqa_decode`)."""

    @torch.no_grad()
    def decode_step(params, cache, batch):
        logits, _, new_cache = transformer.forward(
            cfg, params, batch["tokens"], mode="decode", cache=cache,
            cache_len=batch["cache_len"])
        return mask_padded_vocab(cfg, logits), new_cache

    return decode_step


def greedy_next(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
