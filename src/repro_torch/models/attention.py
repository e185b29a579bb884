"""Grouped-query attention (optional QKV bias) — the GQA half of
`repro.models.attention`.

Three execution modes share weights:
  * full    — training (causal), or bidirectional
  * prefill — like full causal, and also returns the KV cache
  * decode  — one new token against a cache of length S_kv

The full and prefill modes run the port's flash-attention function
(`kernels.flash_attn.flash_attention`) on every device: q as (B, H, S, D),
K/V repeated from `n_kv_heads` to `n_heads`, each contiguous. A CUDA
tensor launches the kernel; a CPU tensor runs its plain version; both are
differentiable through the same plain backward (ROADMAP.md §C (19)), and
autograd of the repeat sums dK and dV back onto the KV heads. The
function masks by index, which equals the reference's position mask where
positions rise along each row; `transformer.trunk` checks positions a
caller passes (ROADMAP.md §C (16)). The reference's `q_chunk` query chunks
only set its order of summation and have no counterpart here. Decode is
one token against the cache in the grouped einsum (`_grouped_attn`), as
the reference computes it outside any Pallas kernel. MLA and
cross-attention are ROADMAP.md §A9 (iii).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attn
from repro_torch.models.common import Tree, apply_rope, dense, dense_spec

NEG_INF = -1e30


def gqa_spec(cfg) -> Tree:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_spec(d, h * hd, ("embed", "heads"), bias=cfg.qkv_bias),
        "wk": dense_spec(d, kv * hd, ("embed", "heads"), bias=cfg.qkv_bias),
        "wv": dense_spec(d, kv * hd, ("embed", "heads"), bias=cfg.qkv_bias),
        "wo": dense_spec(h * hd, d, ("heads", "embed")),
    }


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _qkv(cfg, p: Tree, x, positions):
    """q (B,S,H,Dh), k and v (B,S,KV,Dh), with RoPE on q and k."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(dense(x, p["wq"]), h, hd)
    k = _split_heads(dense(x, p["wk"]), kv, hd)
    v = _split_heads(dense(x, p["wv"]), kv, hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _grouped_attn(q, k, v, mask):
    """q: (B,Sq,H,Dh), k/v: (B,Sk,KV,Dh), mask: (B?,Sq,Sk) bool or None."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    logits = torch.einsum("bqngd,bknd->bngqk", qg.float(), k.float())
    logits = logits / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bngqk,bknd->bqngd", p.to(v.dtype), v)
    return o.reshape(b, sq, h, hd)


def _flash(q, k, v, *, causal: bool):
    """(B,S,H,Dh) attention through the flash function over K/V repeated
    to H heads (query head n·g + i reads KV head n, as the grouped einsum):
    the kernel for a CUDA tensor, its plain version for a CPU one."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
              for x in (k, v))
    blk = math.gcd(s, 128)       # the kernel tiles its own way (§C (5))
    o = flash_attn.flash_attention(qt, kt, vt, bq=blk, bk=blk, causal=causal)
    return o.transpose(1, 2)


def gqa_full(cfg, p: Tree, x, positions, *, causal: bool):
    """Training / bidirectional attention. x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    o = _flash(q, k, v, causal=causal)
    return dense(o.reshape(b, s, -1), p["wo"])


def gqa_prefill(cfg, p: Tree, x, positions):
    """Like gqa_full(causal) but also returns the cache {k, v}: (B,S,KV,Dh)."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    o = _flash(q, k, v, causal=True)
    return dense(o.reshape(b, s, -1), p["wo"]), {"k": k, "v": v}


def gqa_decode(cfg, p: Tree, x, cache: Tree, cache_len, positions):
    """One-step decode. x: (B, 1, D); cache k/v: (B, S, KV, Dh).

    The new token's K/V is written at `cache_len % S` (ring buffer) IN
    PLACE: the cache's tensors are updated and returned, where the
    reference returns new arrays (a decode step would otherwise copy the
    whole cache). Keys past `min(cache_len + 1, S)` are masked."""
    b = x.shape[0]
    k, v = cache["k"], cache["v"]
    s = k.shape[1]
    q, knew, vnew = _qkv(cfg, p, x, positions)
    cache_len = int(cache_len)
    slot = cache_len % s
    k[:, slot] = knew[:, 0]
    v[:, slot] = vnew[:, 0]

    valid = torch.arange(s, device=k.device) < min(cache_len + 1, s)
    o = _grouped_attn(q, k, v, valid[None, None, :])
    return dense(o.reshape(b, 1, -1), p["wo"]), {"k": k, "v": v}
