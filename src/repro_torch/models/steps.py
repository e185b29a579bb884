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

With a `ShardCtx` (`ctx` where the reference's signatures put it) the
parameters, optimizer state, batch and cache are DTensors
(`launch.sharding`); a batch of plain tensors is split by the rule
table's batch layout first. The logits stay vocab-sharded end to end:
`cross_entropy` is the vocab-parallel loss (the max, the sum of
exponentials and the label's logit each all-reduced over the model axis,
as (tokens,) vectors), averaged over the data axes; the train step sums
each gradient over the data axes into its parameter's placement (the
data-parallel all-reduce) before AdamW.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import convert, parallel, transformer
from repro_torch.models.common import P, placements, tree_nest
from repro_torch.models.moe import ShardCtx
from repro_torch.optim import adamw

AUX_WEIGHT = 0.01


def _constrain(x, ctx: ShardCtx | None, spec):
    """x redistributed to `spec`'s placements on the mesh (the reference's
    sharding constraint)."""
    if ctx is None:
        return x
    want = placements(ctx.mesh, spec)
    return x if tuple(x.placements) == want else x.redistribute(
        placements=want)


def logits_pspec(ctx: ShardCtx):
    """Sharding for (B, S, V) logits derived from the rule table (batch axes
    may consume the model axis under zero3 — vocab falls back to replicated
    rather than double-mapping an axis)."""
    rules = ctx.rules or {}
    batch = rules.get("batch", ctx.dp)
    vocab = rules.get("vocab", ctx.tp)
    bt = batch if isinstance(batch, tuple) else (batch,)
    vt = vocab if isinstance(vocab, tuple) else (vocab,)
    if any(v in bt for v in vt if v):
        vocab = None
    return P(batch, None, vocab)


def _vocab_offset(logits):
    """(this rank's first vocab column, the mesh dim that splits the vocab
    or None) of a DTensor's logits."""
    from torch.distributed.tensor import Shard

    for i, pl in enumerate(logits.placements):
        if isinstance(pl, Shard) and pl.dim == logits.ndim - 1:
            mesh = logits.device_mesh
            n = logits.shape[-1] // mesh.size(i)
            return mesh.get_local_rank(i) * n, i
    return 0, None


def mask_padded_vocab(cfg, logits):
    """-1e30 on the padded logit columns (vocab padded to a multiple of 128);
    on vocab-sharded DTensor logits, each rank its own columns."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    if hasattr(logits, "placements"):
        from torch.distributed.tensor.experimental import local_map

        lo, _ = _vocab_offset(logits)
        pl = tuple(logits.placements)
        return local_map(lambda lg: _mask_from(cfg, lg, lo),
                         out_placements=(pl,), in_placements=(pl,),
                         device_mesh=logits.device_mesh)(logits)
    return _mask_from(cfg, logits, 0)


def _mask_from(cfg, logits, lo: int):
    ids = torch.arange(lo, lo + logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab_size, logits,
                       torch.tensor(-1e30, dtype=logits.dtype,
                                    device=logits.device))


class _VocabParallelCE(torch.autograd.Function):
    """Per-token CE of vocab-sharded f32 logits (N, V / P) against global
    labels (N,): lse from the all-reduced max and sum of exponentials,
    the label's logit from the rank that holds it; the gradient
    softmax - onehot on the rank's columns."""

    @staticmethod
    def forward(ctx, lg, labels, lo, group):
        from repro_torch.models.parallel import _all_reduce

        m = _all_reduce(lg.max(dim=-1).values, group, "max")
        e = torch.exp(lg - m[:, None])
        se = _all_reduce(e.sum(dim=-1), group)
        lab = labels.long() - lo
        inside = (lab >= 0) & (lab < lg.shape[-1])
        idx = torch.clamp(lab, 0, lg.shape[-1] - 1)
        ll = lg.gather(-1, idx[:, None])[:, 0].masked_fill(~inside, 0)
        ll = _all_reduce(ll, group)
        ctx.save_for_backward(e / se[:, None], idx, inside)
        return m + torch.log(se) - ll

    @staticmethod
    def backward(ctx, g):
        sm, idx, inside = ctx.saved_tensors
        d = sm.clone()
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows, idx] -= inside.to(d.dtype)
        return d * g[:, None], None, None, None


def cross_entropy(logits, labels, ctx: ShardCtx | None = None):
    """Mean CE over tokens, f32 reductions. With a `ShardCtx`, logits are
    vocab-sharded DTensors and labels batch-sharded ones: the
    vocab-parallel loss per token, its mean over the rank's tokens, then
    over the data axes; a replicated scalar DTensor."""
    if ctx is None:
        lg = logits.float()
        lse = torch.logsumexp(lg, dim=-1)
        ll = lg.gather(-1, labels[..., None].long())[..., 0]
        return (lse - ll).mean()
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    lo, vdim = _vocab_offset(logits)
    lc = parallel.local_view(ctx)

    def body(lg, lab):
        if vdim is None:
            loss = cross_entropy(lg, lab)
        else:
            lg = lg.float()
            loss = _VocabParallelCE.apply(
                lg.reshape(-1, lg.shape[-1]), lab.reshape(-1), lo,
                (ctx.mesh, vdim)).mean()
        return lc.batch_mean(loss)

    lp, bp = tuple(logits.placements), tuple(labels.placements)
    rep = tuple(Replicate() for _ in range(ctx.mesh.ndim))
    return local_map(body, out_placements=(rep,), in_placements=(lp, bp),
                     in_grad_placements=(lp, bp),
                     device_mesh=ctx.mesh)(logits, labels)


def shard_batch(cfg, ctx: ShardCtx | None, batch: dict) -> dict:
    """A batch of plain tensors split by the rule table's batch layout
    (`launch.sharding.batch_shardings`); DTensors, and `cache_len` (the
    step reads it as a host integer), pass through."""
    if ctx is None:
        return batch
    from repro_torch.launch import sharding

    todo = {k: v for k, v in batch.items() if k != "cache_len"
            and isinstance(v, torch.Tensor) and not hasattr(v, "placements")}
    sh = sharding.batch_shardings(ctx.mesh, cfg, None, ctx.rules, todo)
    return {k: sharding.distribute(v, sh[k]) if k in todo else v
            for k, v in batch.items()}


def make_loss_fn(cfg: ModelConfig, ctx: ShardCtx | None = None):
    def loss_fn(params, batch):
        logits, aux, _ = transformer.forward(
            cfg, params, batch["tokens"], mode="train", ctx=ctx,
            positions=batch.get("positions"), frames=batch.get("frames"))
        ce = cross_entropy(mask_padded_vocab(cfg, logits), batch["labels"],
                           ctx)
        return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}
    return loss_fn


def make_train_step(cfg: ModelConfig, ctx: ShardCtx | None = None,
                    opt: adamw.AdamWConfig | None = None, *,
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
    updated in place and returned. With a `ShardCtx` each gradient is
    summed over the data axes into its parameter's placement first."""
    loss_fn = make_loss_fn(cfg, ctx)
    opt = adamw.AdamWConfig() if opt is None else opt
    mb = microbatches

    def split_mb(batch):
        if ctx is not None:
            return _split_local(batch)
        parts = {k: (x.reshape(3, mb, -1, *x.shape[2:]).unbind(1)
                     if k == "positions" and cfg.mrope_sections
                     else x.reshape(mb, -1, *x.shape[1:]).unbind(0))
                 for k, x in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(mb)]

    def _split_local(batch):
        """Each rank splits its own batch shard into `mb` microbatches
        (the reference pins the batch sharding of its split the same way:
        microbatch i is every data shard's i-th slice)."""
        from torch.distributed.tensor import DTensor

        out = [{} for _ in range(mb)]
        for k, x in batch.items():
            dim = 1 if k == "positions" and cfg.mrope_sections else 0
            loc = x.to_local()
            if loc.shape[dim] % mb:
                raise ValueError(f"a batch shard of {loc.shape[dim]} rows "
                                 f"does not split into {mb} microbatches")
            for i, part in enumerate(loc.chunk(mb, dim=dim)):
                out[i][k] = DTensor.from_local(part, x.device_mesh,
                                               x.placements, run_check=False)
        return out

    def grads_of(params, tensors, batch):
        with torch.enable_grad():
            loss, met = loss_fn(params, batch)
            # a parameter the loss does not reach gets zeros, as in jax
            grads = torch.autograd.grad(loss, tensors, allow_unused=True,
                                        materialize_grads=True)
        if ctx is not None:
            grads = [g.redistribute(placements=p.placements)
                     for g, p in zip(grads, tensors)]
        return loss.detach(), {k: x.detach() for k, x in met.items()}, grads

    def train_step(params, opt_state, batch):
        batch = shard_batch(cfg, ctx, batch)
        names, tensors = zip(*adamw.leaves(params).items())
        if mb == 1:
            loss, metrics, grads = grads_of(params, tensors, batch)
        else:
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in tensors]
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


def make_prefill_step(cfg: ModelConfig, ctx: ShardCtx | None = None):
    """(params, batch{tokens (B, S)[, positions][, frames]}) ->
    (last-position logits (B, 1, V), cache: a list of per-layer caches,
    `transformer.layer_cache_spec`'s, with S slots where a leaf has a
    sequence axis; an encoder-decoder's encodes its `frames` and returns
    each layer's cross K/V). With a `ShardCtx` the logits are in
    `logits_pspec(ctx)` and the cache in its layout."""

    @torch.no_grad()
    def prefill_step(params, batch):
        batch = shard_batch(cfg, ctx, batch)
        x, _, cache = transformer.trunk(cfg, params, batch["tokens"],
                                        mode="prefill",
                                        positions=batch.get("positions"),
                                        frames=batch.get("frames"), ctx=ctx)
        lg = transformer.head(cfg, params, x, ctx, last=True)
        lg = mask_padded_vocab(cfg, lg)
        return (_constrain(lg, ctx, logits_pspec(ctx)) if ctx else lg), cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, ctx: ShardCtx | None = None):
    """(params, cache, batch{tokens (B, 1), cache_len}) -> (logits, cache);
    the cache is written in place (`attention.gqa_decode`,
    `attention.mla_decode`, `rwkv.time_mix_step`, `mamba.mamba_step`)."""

    @torch.no_grad()
    def decode_step(params, cache, batch):
        batch = shard_batch(cfg, ctx, batch)
        logits, _, new_cache = transformer.forward(
            cfg, params, batch["tokens"], mode="decode", ctx=ctx,
            cache=cache, cache_len=batch["cache_len"])
        lg = mask_padded_vocab(cfg, logits)
        return (_constrain(lg, ctx, logits_pspec(ctx)) if ctx else lg), \
            new_cache

    return decode_step


def greedy_next(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
