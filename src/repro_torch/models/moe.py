"""FFN layers: dense SwiGLU/GELU and Mixture-of-Experts — port of
`repro.models.moe` on one device (no `ShardCtx`; the tensor- and
expert-parallel variants come with a mesh, ROADMAP.md §A9 (iv)).

Gate/up projections are stored (d, 2, f), never fused (d, 2f), as in the
reference, so a tensor-parallel cut of f never splits across the gate/up
boundary.

MoE, as the reference's `_moe_local` without a context: an f32 router,
top-k per token, a softmax over the k gates, then a capacity dispatch over
all B·S tokens of the call at once (dropless up to 1024 tokens, else
`capacity_factor · n · k / e + 1` slots an expert, entries past it
dropped in token order), the expert SwiGLUs as two batched products over
the (e, capacity, d) buckets, and a combine that gathers each kept
entry's output, weights it and sums each token's k entries. The card
gives the same bits on every run: the buckets are filled by a gather
through the kept entries' slot map, which is unique (the dropped entries
all write one spare row that is cut off), the combine is a sum over the
k axis of a token-major (n, k, d) tensor, which equals the reference's
`segment_sum` over `repeat(arange(n), k)`, and the only atomic adds are
the aux loss's counts of ones (ROADMAP.md §C (20)). Nothing reads a size
back to the host.
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


# ---------------------------------------------------------------------------
# MoE


def moe_spec(cfg) -> Tree:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s: Tree = {
        "router": ParamSpec((d, e), ("embed", "null"), dtype=torch.float32),
        "wi": ParamSpec((e, d, 2, f), ("experts", "embed", "null", "mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        s["shared"] = swiglu_spec(d, f * cfg.n_shared_experts)
    return s


def _capacity(cfg, n: int) -> int:
    """Slots per expert for a dispatch of n tokens: dropless (n) up to a
    decode-sized 1024 tokens, else the reference's capacity rule."""
    if n <= 1024:
        return n
    return int(cfg.moe_capacity_factor * n * cfg.top_k / cfg.n_experts) + 1


def _dispatch_indices(expert_ids, capacity: int):
    """expert_ids: (N,) int. Returns (slot (N,) int32, keep (N,) bool):
    slot is the entry's rank among the entries of its expert, in entry
    order (a stable sort, then each sorted entry's distance to its
    segment's start, a running max); keep is slot < capacity."""
    n = expert_ids.shape[0]
    sorted_e, order = torch.sort(expert_ids, stable=True)
    pos = torch.arange(n, device=expert_ids.device)
    is_start = torch.ones(n, dtype=torch.bool, device=expert_ids.device)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - seg_start            # a permutation: no two writes
    rank = rank.to(torch.int32)
    return rank, rank < capacity


def _route(cfg, p: Tree, xt):
    """Router of n tokens xt (n, d): (logits (n, e) f32, gate weights
    (n, k) f32, expert ids (n·k,), slot, keep, capacity), entries
    token-major."""
    logits = torch.matmul(xt.float(), p["router"].float())
    gates, eids = torch.topk(logits, cfg.top_k, dim=-1, sorted=True)
    weights = torch.softmax(gates, dim=-1)
    flat_e = eids.reshape(-1)
    capacity = _capacity(cfg, xt.shape[0])
    slot, keep = _dispatch_indices(flat_e, capacity)
    return logits, weights, flat_e, slot, keep, capacity


def _aux_loss(logits, flat_e, keep, e: int):
    """e · Σ mean(probs) · counts / Σ counts over the kept entries. The
    counts add ones and zeros, exact in f32 in any order, and need no
    host sync (`bincount` and boolean indexing read a size back)."""
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    counts = logits.new_zeros(e).index_add_(0, flat_e, keep.float())
    ce = counts / torch.clamp(counts.sum(), min=1.0)
    return e * torch.sum(me * ce)


def moe_ffn(cfg, p: Tree, x):
    """x (B, S, D) -> (out (B, S, D), aux f32 scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * s
    xt = x.reshape(n, d)
    logits, weights, flat_e, slot, keep, cap = _route(cfg, p, xt)
    flat_tok = torch.arange(n, device=x.device).repeat_interleave(k)
    target = flat_e * cap + slot                 # unique where kept

    # each kept entry's bucket row reads its token; empty rows read zeros;
    # dropped entries all write one spare row, which is cut off
    src = torch.full((e * cap + 1,), n, dtype=torch.long, device=x.device)
    src[torch.where(keep, target, e * cap)] = flat_tok
    xpad = torch.cat([xt, xt.new_zeros(1, d)])
    buckets = xpad[src[:-1]].reshape(e, cap, d)
    del src, xpad

    buckets, wi = promote(buckets, p["wi"])
    f = wi.shape[-1]
    u = torch.bmm(buckets, wi.reshape(e, d, 2 * f)).unflatten(-1, (2, f))
    del buckets
    h = F.silu(u[..., 0, :]) * u[..., 1, :]
    del u
    y = torch.bmm(*promote(h, p["wo"]))                 # (e, cap, d)
    del h

    rows = torch.clamp(target, max=e * cap - 1)
    out = y.reshape(e * cap, d)[rows]
    del y
    out.mul_(weights.reshape(-1, 1).to(out.dtype))
    out.masked_fill_(~keep[:, None], 0)
    out = out.reshape(n, k, d).sum(dim=1).to(x.dtype)

    if cfg.n_shared_experts:
        out = out + swiglu(p["shared"], xt)
    aux = _aux_loss(logits, flat_e, keep, e)
    return out.reshape(b, s, -1), aux
