"""Grouped-query attention (optional QKV bias), multi-head latent
attention (MLA) and whisper's cross attention — port of
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
the reference computes it outside any Pallas kernel.

MLA (`mla_full`, `mla_decode`) keeps the reference's absorbed path: the
cache holds the latent `ckv` (B, S, r) and the rotated key `kr` (B, S,
dr); queries move into the latent through `wuk`, the logits are
`qa·ckv + q_rope·kr` scaled by 1/sqrt(dn + dr) in f32, and P·ckv goes
back through `wuv`. It is torch ops on every device: its QK width r + dr
and V width r exceed the flash kernel's head dims (ROADMAP.md §C (5)) and
its scale is not 1/sqrt(D). Causal `mla_full` runs `cfg.q_chunk` query
rows at a time, so the live logits are (B, H, q_chunk, S), and each chunk
reads only the keys up to its last row: the keys past it are masked
(weight exactly 0) where positions rise along each row, which
`transformer.trunk` checks (ROADMAP.md §C (21)).

Cross attention (`cross_spec`, `cross_full`) keeps the reference's
uniform biases (`wq`, `wv`; no `wk` bias) and computes the grouped einsum
over the encoder's K/V in torch ops on every device, as the reference
does outside any Pallas kernel (Sq ≠ Sk, no mask), in `cfg.q_chunk` query
chunks (§C (24)). Decode reads the cross K/V from the cache and never
writes it.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attn
from repro_torch.models.common import (
    ParamSpec, Tree, apply_mrope, apply_rope, dense, dense_spec, promote,
)

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
    """q (B,S,H,Dh), k and v (B,S,KV,Dh), with RoPE on q and k (M-RoPE
    over (3, B, S) positions where the config has `mrope_sections`)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(dense(x, p["wq"]), h, hd)
    k = _split_heads(dense(x, p["wk"]), kv, hd)
    v = _split_heads(dense(x, p["wv"]), kv, hd)
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.use_rope:
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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)


def mla_spec(cfg) -> Tree:
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    s: Tree = {
        "wdkv": dense_spec(d, r, ("embed", "kv_lora")),
        "wkr": dense_spec(d, dr, ("embed", "head_dim")),
        "wuk": ParamSpec((r, h, dn), ("kv_lora", "heads", "head_dim")),
        "wuv": ParamSpec((r, h, dv), ("kv_lora", "heads", "head_dim")),
        "wo": dense_spec(h * dv, d, ("heads", "embed")),
    }
    if cfg.q_lora_rank:
        s["wdq"] = dense_spec(d, cfg.q_lora_rank, ("embed", "q_lora"))
        s["wuq"] = ParamSpec((cfg.q_lora_rank, h, dn + dr),
                             ("q_lora", "heads", "head_dim"))
    else:
        s["wq"] = ParamSpec((d, h, dn + dr), ("embed", "heads", "head_dim"))
    return s


def _heads_product(x, w):
    """x (..., a) @ w (a, H, e) -> (..., H, e), in their common dtype."""
    x, w = promote(x, w)
    a, h, e = w.shape
    return (x @ w.reshape(a, h * e)).unflatten(-1, (h, e))


def _mla_q(cfg, p, x):
    """The queries' no-RoPE and RoPE parts, (B, S, H, dn) and (B, S, H, dr)."""
    dn = cfg.qk_nope_dim
    if cfg.q_lora_rank:
        q = _heads_product(torch.matmul(*promote(x, p["wdq"]["w"])),
                           p["wuq"])
    else:
        q = _heads_product(x, p["wq"])
    return q[..., :dn], q[..., dn:]


def _mla_inputs(cfg, p, x, positions):
    """(ckv (B,S,r), kr (B,S,dr) rotated, qa (B,S,H,r), qr (B,S,H,dr)
    rotated): the latent cache entries and the absorbed queries."""
    ckv = dense(x, p["wdkv"])
    kr = apply_rope(dense(x, p["wkr"])[:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0]
    qn, qr = _mla_q(cfg, p, x)
    qr = apply_rope(qr, positions, cfg.rope_theta)
    wuk = p["wuk"]
    qn, wuk = promote(qn, wuk)
    qa = torch.einsum("bshe,rhe->bshr", qn, wuk)
    return ckv, kr, qa, qr


def _mla_attend(cfg, p, qa, qr, ckv32, kr32, ckv, mask):
    """One block of query rows against keys 0..K-1: qa (B,q,H,r), qr
    (B,q,H,dr), the keys' ckv / kr in f32 (B,K,·) and ckv in its own dtype,
    mask (B,q,K) bool or None. Returns (B, q, H, dv)."""
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    lg = torch.einsum("bqhr,bkr->bhqk", qa.float(), ckv32)
    lg += torch.einsum("bqhe,bke->bhqk", qr.float(), kr32)
    lg *= scale
    if mask is not None:
        lg.masked_fill_(~mask[:, None], NEG_INF)
    pr = torch.softmax(lg, dim=-1)
    del lg
    ol = torch.einsum("bhqk,bkr->bqhr", pr.to(ckv.dtype), ckv)
    wuv = p["wuv"]
    ol, wuv = promote(ol, wuv)
    return torch.einsum("bqhr,rhe->bqhe", ol, wuv)


def mla_full(cfg, p: Tree, x, positions, *, causal: bool = True,
             return_cache: bool = False):
    """MLA over a whole sequence. x: (B, S, D) -> (B, S, D), and with
    `return_cache` the latent cache {ckv (B,S,r), kr (B,S,dr)}. Causal
    attention masks by positions and runs `cfg.q_chunk` query rows at a
    time over the keys up to each chunk's last row (positions must rise
    along each row)."""
    b, s, _ = x.shape
    ckv, kr, qa, qr = _mla_inputs(cfg, p, x, positions)
    ckv32, kr32 = ckv.float(), kr.float()
    if not causal:
        o = _mla_attend(cfg, p, qa, qr, ckv32, kr32, ckv, None)
    else:
        qc = cfg.q_chunk
        parts = []
        for c0 in range(0, s, qc):
            c1 = min(c0 + qc, s)
            mask = (positions[:, c0:c1, None]
                    >= positions[:, None, :c1])
            parts.append(_mla_attend(cfg, p, qa[:, c0:c1], qr[:, c0:c1],
                                     ckv32[:, :c1], kr32[:, :c1],
                                     ckv[:, :c1], mask))
        o = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    out = dense(o.reshape(b, s, -1), p["wo"])
    if return_cache:
        return out, {"ckv": ckv, "kr": kr}
    return out


def mla_decode(cfg, p: Tree, x, cache: Tree, cache_len, positions):
    """Absorbed MLA decode of one token. x: (B, 1, D); cache ckv (B, S, r),
    kr (B, S, dr). The new entries are written at `cache_len % S` IN PLACE
    (as `gqa_decode`); keys past `min(cache_len + 1, S)` are masked."""
    b = x.shape[0]
    ckv, kr = cache["ckv"], cache["kr"]
    s = ckv.shape[1]
    ckv_new, kr_new, qa, qr = _mla_inputs(cfg, p, x, positions)
    cache_len = int(cache_len)
    slot = cache_len % s
    ckv[:, slot] = ckv_new[:, 0]
    kr[:, slot] = kr_new[:, 0]
    valid = torch.arange(s, device=ckv.device) < min(cache_len + 1, s)
    o = _mla_attend(cfg, p, qa, qr, ckv.float(), kr.float(), ckv,
                    valid.expand(b, 1, s))
    return dense(o.reshape(b, 1, -1), p["wo"]), {"ckv": ckv, "kr": kr}


# ---------------------------------------------------------------------------
# cross attention (whisper decoder)


def cross_spec(cfg) -> Tree:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "wq": dense_spec(d, h * hd, ("embed", "heads"), bias=True),
        "wk": dense_spec(d, h * hd, ("embed", "heads")),
        "wv": dense_spec(d, h * hd, ("embed", "heads"), bias=True),
        "wo": dense_spec(h * hd, d, ("heads", "embed")),
    }


def cross_kv(cfg, p: Tree, enc_out):
    """The encoder output's cross K and V, (B, Sk, H, Dh) each."""
    h, hd = cfg.n_heads, cfg.head_dim
    return (_split_heads(dense(enc_out, p["wk"]), h, hd),
            _split_heads(dense(enc_out, p["wv"]), h, hd))


def cross_attend(cfg, p: Tree, x, k, v):
    """x (B, Sq, D) attends over the cross K/V (B, Sk, H, Dh), no mask and
    no RoPE, in `cfg.q_chunk` query rows at a time: each row's softmax is
    its own, so the values are those of one pass, and the live f32 logits
    are (B, H, q_chunk, Sk) (ROADMAP.md §C (24))."""
    b, sq, _ = x.shape
    q = _split_heads(dense(x, p["wq"]), cfg.n_heads, cfg.head_dim)
    parts = [_grouped_attn(q[:, c0:c0 + cfg.q_chunk], k, v, None)
             for c0 in range(0, sq, cfg.q_chunk)]
    o = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return dense(o.reshape(b, sq, -1), p["wo"])


def cross_full(cfg, p: Tree, x, enc_out):
    """x: (B, Sq, D) attends over enc_out (B, Sk, D) (no mask, no rope)."""
    return cross_attend(cfg, p, x, *cross_kv(cfg, p, enc_out))
