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

Under a sharding context each function runs on one rank's shards inside
the layer's `local_map` (`transformer.apply_layer`), with the block's
`parallel.Local` as its trailing `lc`. Every projection keeps its stored
model-dim shard (`_heads`): where the heads split evenly, q, k and v are
the rank's heads; where a column shard cuts a head (28 heads of 128 on a
16-way axis: 1.75 heads a rank), its activation's columns are
all-gathered over the model dim, as the reference's compiled program
gathers them, and no weight moves. Each rank attends with the query
heads its `wo` row shard reads (`_out_heads`: its own where they split
evenly, else the two or three heads that overlap its rows) over the KV
heads they read (`_kv_for_heads`), and projects those rows: a partial
sum that leaves through the layer's all-reduce. A cache whose head dim
is split over the model dim (KV heads that do not divide it) is read in
decode by partial logits over the rank's slice of the head dim, summed
by one all-reduce; MLA's latent cache, split on r, likewise. Under the
SP decode flip (`Local.kv_dim`: the data dims split every K/V and latent
cache on its sequence, the batch replicated) a prefill computes the
whole prompt on every rank and keeps its slots (`Local.kv_take`); a
decode step writes the ring buffer's slot on the rank that holds it
(`_ring`), attends over the rank's slots, and merges the ranks' partial
softmaxes by their log-sum-exp (`parallel.softmax_merge`, then P·V
summed over the data dims); with a head-dim split too, the logits are
summed over the model dim first.

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


def _heads(t, n: int, hd: int, lc, spans=None):
    """A projection's output (B, S, w) of `n` heads as (B, S, n_t, Dh),
    and its first head. Every head where the leaf is whole; else the
    heads [a, b) = spans[rank]: the rank's own where its column shard
    holds just those, else their columns from the ranks' shards
    (`Local.exchange`: the activation moves, the weights stay in their
    shards). Without `spans`: the rank's heads where the model dim splits
    them evenly, else every head, all-gathered."""
    if lc is None or t.shape[-1] == n * hd:
        return _split_heads(t, n, hd), 0
    w = t.shape[-1]
    if spans is None:
        if n % lc.tp == 0:
            return _split_heads(t, n // lc.tp, hd), lc.rank * (n // lc.tp)
        return _split_heads(lc.gather(t, t.dim() - 1), n, hd), 0
    a, b = spans[lc.rank]
    if (b - a) * hd == w and a * hd == lc.rank * w:
        return _split_heads(t, b - a, hd), a
    src = [range(q * w, (q + 1) * w) for q in range(lc.tp)]
    dst = [range(x * hd, y * hd) for x, y in spans]
    return _split_heads(lc.exchange(t, src, dst), b - a, hd), a


def _out_heads(p: Tree, h: int, hd: int, lc, rank=None):
    """(h0, h1, off): the heads [h0, h1) (of `h`, `hd` wide) whose outputs
    the rank's (or `rank`'s) `wo` rows read, and where those rows start in
    their flattened outputs; every head where `wo` is whole."""
    rows = p["wo"]["w"].shape[0]
    if lc is None or rows == h * hd:
        return 0, h, 0
    c0 = (lc.rank if rank is None else rank) * rows
    return c0 // hd, -(-(c0 + rows) // hd), c0 % hd


def _spans(p: Tree, h: int, hd: int, g: int, lc):
    """Every rank's query heads (`_out_heads`) and the KV heads they read
    (query head j reads KV head j // g), as [a, b) pairs; None off a
    mesh."""
    if lc is None:
        return None, None
    qs = [_out_heads(p, h, hd, lc, r)[:2] for r in range(lc.tp)]
    return qs, [(a // g, (b - 1) // g + 1) for a, b in qs]


def _out(p: Tree, o, h: int, first: int, lc):
    """The output projection of o (B, S, h_o, Dh), heads (of `h`) from
    `first`: on a rank's shards, of the rows its `wo` shard holds (a
    partial sum)."""
    b, s, _, hd = o.shape
    if lc is None:
        return dense(o.reshape(b, s, -1), p["wo"])
    h0, h1, off = _out_heads(p, h, hd, lc)
    o = o[:, :, h0 - first:h1 - first].reshape(b, s, -1)
    rows = p["wo"]["w"].shape[0]
    return dense(o[..., off:off + rows] if o.shape[-1] != rows else o,
                 p["wo"])


def _qkv(cfg, p: Tree, x, positions, lc=None, *, all_heads=False):
    """(q, q0, k, k0, v, ks): q (B,S,hq,Dh) from query head q0, k and v
    (B,S,kv_t,Dh) from KV head k0, with RoPE on q and k (M-RoPE over
    (3, B, S) positions where the config has `mrope_sections`), and every
    rank's KV heads (`_spans`, None off a mesh). On a rank's shards q
    holds the heads its `wo` rows read and k, v the KV heads those read;
    with `all_heads` (decode), what `_heads` gives without spans."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qs, ks = (None, None) if all_heads else _spans(p, h, hd, h // kv, lc)
    q, q0 = _heads(dense(x, p["wq"]), h, hd, lc, qs)
    if qs is not None and q.shape[2] == h:        # whole: the rank's span
        a, b = qs[lc.rank]
        q, q0 = q[:, :, a:b], a
    k, k0 = _heads(dense(x, p["wk"]), kv, hd, lc, ks)
    v, _ = _heads(dense(x, p["wv"]), kv, hd, lc, ks)
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, q0, k, k0, v, ks


def _grouped_attn(q, k, v, mask, lc=None):
    """q: (B,Sq,H,Dh), k/v: (B,Sk,KV,Dh), mask: (B?,Sq,Sk) bool or None;
    with `lc` (decode), over the rank's slots of a sequence-split cache
    (`_merged`)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    logits = torch.einsum("bqngd,bknd->bngqk", qg.float(), k.float())
    logits = logits / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    o = _merged(logits, lambda p: torch.einsum("bngqk,bknd->bqngd", p, v),
                v.dtype, lc)
    return o.reshape(b, sq, h, hd)


def _merged(logits, pv, dtype, lc):
    """pv(softmax(logits) in `dtype`): over a cache whose sequence the
    data dims split, each rank's probabilities by the log-sum-exp merge
    and the ranks' P·V summed in f32 (`Local.kv_softmax`, `kv_sum`)."""
    if lc is None or lc.kv_dim is None:
        return pv(torch.softmax(logits, dim=-1).to(dtype))
    o = pv(lc.kv_softmax(logits).to(dtype))
    return lc.kv_sum(o.float()).to(o.dtype)


def _ring(lc, s_loc: int, cache_len: int, device):
    """(the rank's index of the ring buffer's slot `cache_len % S` or None
    where another rank holds it, the mask of its slots' keys): S = s_loc ·
    P slots, rank r of the P that split the sequence holding [r · s_loc,
    (r + 1) · s_loc) (P = 1 off the flip); keys past min(cache_len + 1,
    S) masked. Every rank derives both from the same cache_len, after a
    wrap too."""
    n, r = (1, 0) if lc is None else (lc.kv_size, lc.kv_rank)
    s, off = s_loc * n, r * s_loc
    slot = cache_len % s - off
    valid = torch.arange(off, off + s_loc, device=device) < min(cache_len + 1,
                                                                s)
    return (slot if 0 <= slot < s_loc else None), valid


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


def _kv_for_heads(k, k0: int, h0: int, h1: int, g: int):
    """The KV heads that query heads [h0, h1) read (query head j reads KV
    head j // g), from k holding KV heads from k0: k itself or a slice
    where the query heads cover whole groups or lie in one, else one KV
    head per query head."""
    a, b = h0 // g - k0, (h1 - 1) // g + 1 - k0
    if (h0 % g == 0 and h1 % g == 0) or b - a == 1:
        return k if (a, b) == (0, k.shape[2]) else k[:, :, a:b]
    idx = torch.arange(h0, h1, device=k.device) // g - k0
    return k[:, :, idx]


def _first_kv(k, n: int, lc) -> int:
    """The first head of a cache's K or V: all `n` heads, or the rank's."""
    return 0 if k.shape[2] == n else lc.rank * k.shape[2]


def _self_attn(cfg, p: Tree, x, positions, causal: bool, lc):
    """(output, k, v, k0, ks) of `gqa_full` / `gqa_prefill`."""
    q, q0, k, k0, v, ks = _qkv(cfg, p, x, positions, lc)
    g, h1 = cfg.n_heads // cfg.n_kv_heads, q0 + q.shape[2]
    o = _flash(q, _kv_for_heads(k, k0, q0, h1, g),
               _kv_for_heads(v, k0, q0, h1, g), causal=causal)
    return _out(p, o, cfg.n_heads, q0, lc), k, v, k0, ks


def _cache_layout(t, first: int, n: int, dim, lc, spans=None):
    """K or V (B, S, n_t, Dh), heads from `first` of `n`, in its cache's
    layout: every head (dim None), the rank's heads (dim 2) or every
    head's slice of the head dim (dim 3). Taken from t where every rank's
    t holds every head, or (dim 2) its own; else exchanged from the
    ranks' heads (`spans`, `Local.exchange`), every rank taking part."""
    tp = lc.tp
    own = [(r * n // tp, (r + 1) * n // tp) for r in range(tp)]
    if spans is None or all(sp == (0, n) for sp in spans):
        if t.shape[2] == n:
            return t if dim is None else lc.take(t, dim)
        return t                          # the rank's KV heads (dim 2)
    if dim == 2 and n % tp == 0 and list(spans) == own:
        return t
    hd = t.shape[3]
    w = hd // tp if dim == 3 else hd
    if dim == 3:
        dst = [[j * hd + r * w + i for j in range(n) for i in range(w)]
               for r in range(tp)]
    elif dim == 2:
        m = n // tp
        dst = [range(r * m * hd, (r + 1) * m * hd) for r in range(tp)]
    else:
        dst = [range(n * hd)] * tp
    src = [range(a * hd, b * hd) for a, b in spans]
    return lc.exchange(t.flatten(2), src, dst).unflatten(-1, (-1, w))


def gqa_full(cfg, p: Tree, x, positions, *, causal: bool, lc=None):
    """Training / bidirectional attention. x: (B, S, D) -> (B, S, D)."""
    return _self_attn(cfg, p, x, positions, causal, lc)[0]


def gqa_prefill(cfg, p: Tree, x, positions, lc=None):
    """Like gqa_full(causal) but also returns the cache {k, v}: (B,S,KV,Dh)
    (on a rank's shards, in the cache's layout)."""
    out, k, v, k0, ks = _self_attn(cfg, p, x, positions, True, lc)
    if lc is not None:
        dims = lc.cache_dims or {}
        k, v = (lc.kv_take(_cache_layout(t, k0, cfg.n_kv_heads, dims.get(n),
                                         lc, ks))
                for t, n in ((k, "k"), (v, "v")))
    return out, {"k": k, "v": v}


def gqa_decode(cfg, p: Tree, x, cache: Tree, cache_len, positions,
               lc=None):
    """One-step decode. x: (B, 1, D); cache k/v: (B, S, KV, Dh).

    The new token's K/V is written at `cache_len % S` (ring buffer) IN
    PLACE: the cache's tensors are updated and returned, where the
    reference returns new arrays (a decode step would otherwise copy the
    whole cache). Keys past `min(cache_len + 1, S)` are masked. Over a
    sequence-split cache (the flip) the rank holding the slot writes it
    and the ranks' partial softmaxes merge (`_ring`, `_merged`)."""
    k, v = cache["k"], cache["v"]
    dims = (lc.cache_dims or {}) if lc is not None else {}
    split = dims.get("k") == 3
    q, q0, knew, k0, vnew, _ = _qkv(cfg, p, x, positions, lc,
                                    all_heads=True)
    if lc is not None:
        knew, vnew = (_cache_layout(t, k0, cfg.n_kv_heads, dims.get(n), lc)
                      for t, n in ((knew, "k"), (vnew, "v")))
    slot, valid = _ring(lc, k.shape[1], int(cache_len), k.device)
    if slot is not None:
        k[:, slot] = knew[:, 0]
        v[:, slot] = vnew[:, 0]

    if split:
        o = _split_dim_attn(cfg, q, k, v, valid, lc)
    else:
        if lc is not None:               # the heads the rank's wo rows read
            h0, h1, _ = _out_heads(p, cfg.n_heads, cfg.head_dim, lc)
            q, q0 = q[:, :, h0 - q0:h1 - q0], h0
        g, h1 = cfg.n_heads // cfg.n_kv_heads, q0 + q.shape[2]
        k0 = _first_kv(k, cfg.n_kv_heads, lc)
        o = _grouped_attn(q, _kv_for_heads(k, k0, q0, h1, g),
                          _kv_for_heads(v, k0, q0, h1, g),
                          valid[None, None, :], lc)
    return _out(p, o, cfg.n_heads, q0, lc), {"k": k, "v": v}


def _split_dim_attn(cfg, q, k, v, valid, lc):
    """One token's attention over a cache whose head dim is split over the
    model dim (B, S, KV, Dh / P): every query head's logits summed from
    the ranks' slices by one all-reduce, the softmax (merged over the data
    dims where they split the sequence too), P·V on the rank's slice, the
    slices gathered; the output on q's heads (all heads, or the rank's
    where they split evenly)."""
    b, one, hq, hd = q.shape
    h = cfg.n_heads
    q_all = q if hq == h else lc.gather(q, 2)                 # (B,1,H,Dh)
    qs = lc.take(q_all, 3)
    kvh = k.shape[2]
    qg = qs.reshape(b, 1, kvh, h // kvh, -1)
    logits = torch.einsum("bqngd,bknd->bngqk", qg.float(), k.float())
    logits = lc.reduce(logits) / math.sqrt(hd)
    logits = torch.where(valid[None, None, None, None, :], logits, NEG_INF)
    o = _merged(logits, lambda pr: torch.einsum("bngqk,bknd->bqngd", pr, v),
                v.dtype, lc)
    o = lc.gather(o.reshape(b, 1, h, -1), 3)                  # (B,1,H,Dh)
    return o if hq == h else lc.take(o, 2)


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


def _mla_attend(cfg, p, qa, qr, ckv32, kr32, ckv, mask, lc=None):
    """One block of query rows against keys 0..K-1: qa (B,q,H,r), qr
    (B,q,H,dr), the keys' ckv / kr in f32 (B,K,·) and ckv in its own dtype,
    mask (B,q,K) bool or None; with `lc` (decode), over the rank's slots
    of a sequence-split cache. Returns (B, q, H, dv)."""
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    lg = torch.einsum("bqhr,bkr->bhqk", qa.float(), ckv32)
    lg += torch.einsum("bqhe,bke->bhqk", qr.float(), kr32)
    lg *= scale
    if mask is not None:
        lg.masked_fill_(~mask[:, None], NEG_INF)
    ol = _merged(lg, lambda pr: torch.einsum("bhqk,bkr->bqhr", pr, ckv),
                 ckv.dtype, lc)
    del lg
    wuv = p["wuv"]
    ol, wuv = promote(ol, wuv)
    return torch.einsum("bqhr,rhe->bqhe", ol, wuv)


def _mla_core(cfg, p: Tree, lc):
    """(p, h0): p with the query-side and up-projection weights narrowed
    to the heads [h0, h1) the rank's `wo` rows read, where they hold every
    head (heads that do not split evenly: the rank attends with the two
    or three heads that overlap its rows, not with all of them)."""
    h = cfg.n_heads
    h0, h1, _ = _out_heads(p, h, cfg.v_head_dim, lc)
    if h1 - h0 == h:
        return p, 0
    return dict(p, **{k: p[k][:, h0:h1] if p[k].shape[1] == h else p[k]
                      for k in ("wq", "wuq", "wuk", "wuv") if k in p}), h0


def mla_full(cfg, p: Tree, x, positions, *, causal: bool = True,
             return_cache: bool = False, lc=None):
    """MLA over a whole sequence. x: (B, S, D) -> (B, S, D), and with
    `return_cache` the latent cache {ckv (B,S,r), kr (B,S,dr)}. Causal
    attention masks by positions and runs `cfg.q_chunk` query rows at a
    time over the keys up to each chunk's last row (positions must rise
    along each row). On a rank's shards: its heads (the latent and rope
    keys whole on every rank; `_mla_core`); the cache leaves in their
    layout (the rank's slice of r and of dr where the cache splits them)."""
    s = x.shape[1]
    p, q0 = _mla_core(cfg, p, lc) if lc is not None else (p, 0)
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
    out = _out(p, o, cfg.n_heads, q0, lc)
    if return_cache:
        if lc is not None:
            dims = lc.cache_dims or {}
            ckv = lc.kv_take(ckv if dims.get("ckv") is None
                             else lc.take(ckv, 2))
            kr = lc.kv_take(kr if dims.get("kr") is None else lc.take(kr, 2))
        return out, {"ckv": ckv, "kr": kr}
    return out


def mla_decode(cfg, p: Tree, x, cache: Tree, cache_len, positions,
               lc=None):
    """Absorbed MLA decode of one token. x: (B, 1, D); cache ckv (B, S, r),
    kr (B, S, dr). The new entries are written at `cache_len % S` IN PLACE
    (as `gqa_decode`, by the rank holding the slot under the flip); keys
    past `min(cache_len + 1, S)` are masked."""
    b = x.shape[0]
    ckv, kr = cache["ckv"], cache["kr"]
    s = ckv.shape[1]
    dims = (lc.cache_dims or {}) if lc is not None else {}
    if dims.get("ckv") is not None:
        return _mla_decode_split(cfg, p, x, cache, int(cache_len), positions,
                                 lc)
    p, q0 = _mla_core(cfg, p, lc) if lc is not None else (p, 0)
    ckv_new, kr_new, qa, qr = _mla_inputs(cfg, p, x, positions)
    slot, valid = _ring(lc, s, int(cache_len), ckv.device)
    if slot is not None:
        ckv[:, slot] = ckv_new[:, 0]
        kr[:, slot] = kr_new[:, 0]
    o = _mla_attend(cfg, p, qa, qr, ckv.float(), kr.float(), ckv,
                    valid.expand(b, 1, s), lc)
    return _out(p, o, cfg.n_heads, q0, lc), {"ckv": ckv, "kr": kr}


def _mla_decode_split(cfg, p, x, cache, cache_len, positions, lc):
    """MLA decode over a latent cache split on r (and kr on dr) over the
    model dim, with `wdkv`, `wuk` and `wuv` in their stored r-shards: every
    head's queries (gathered where the rank holds some), logits partial
    over the rank's r and dr slices and summed by one all-reduce, P·ckv on
    the rank's r, the values through its `wuv` rows (partial over r),
    reduce-scattered onto the rank's heads where `wo` splits them evenly,
    else all-reduced for the rows of `wo`'s shard. The output is partial;
    the layer's exit sums it."""
    ckv, kr = cache["ckv"], cache["kr"]
    slot, valid = _ring(lc, ckv.shape[1], cache_len, ckv.device)
    ckv_new = dense(x, p["wdkv"])                             # rank's r
    kr_new = apply_rope(dense(x, p["wkr"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    kr_new = kr_new if (lc.cache_dims or {}).get("kr") is None else \
        lc.take(kr_new, 2)
    if slot is not None:
        ckv[:, slot] = ckv_new[:, 0]
        kr[:, slot] = kr_new[:, 0]
    qn, qr = _mla_q(cfg, p, x)
    qr = apply_rope(qr, positions, cfg.rope_theta)
    hq, h = qn.shape[2], cfg.n_heads
    if hq != h:
        qn, qr = lc.gather(qn, 2), lc.gather(qr, 2)
    if kr.shape[2] != qr.shape[3]:
        qr = lc.take(qr, 3)
    wuk = p["wuk"]
    qn, wuk = promote(qn, wuk)
    qa = torch.einsum("bshe,rhe->bshr", qn, wuk)              # rank's r
    lg = torch.einsum("bqhr,bkr->bhqk", qa.float(), ckv.float())
    lg += torch.einsum("bqhe,bke->bhqk", qr.float(), kr.float())
    lg = lc.reduce(lg) * (1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim))
    lg.masked_fill_(~valid[None, None, None, :], NEG_INF)
    ol = _merged(lg, lambda pr: torch.einsum("bhqk,bkr->bqhr", pr, ckv),
                 ckv.dtype, lc)
    wuv = p["wuv"]
    ol, wuv = promote(ol, wuv)
    o = torch.einsum("bqhr,rhe->bqhe", ol, wuv)               # partial
    first = 0
    if p["wo"]["w"].shape[0] != h * o.shape[-1] and h % lc.tp == 0:
        o = lc.scatter(o, 2)                                  # rank's heads
        first = lc.rank * o.shape[2]
    elif p["wo"]["w"].shape[0] != h * o.shape[-1]:
        o = lc.reduce(o)               # whole, for the rows of wo's shard
    return _out(p, o, h, first, lc), {"ckv": ckv, "kr": kr}


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


def cross_kv(cfg, p: Tree, enc_out, lc=None):
    """The encoder output's cross K and V, (B, Sk, H, Dh) each; on a
    rank's shards, the heads its `wo` rows read (`_spans`)."""
    h, hd = cfg.n_heads, cfg.head_dim
    qs = _spans(p, h, hd, 1, lc)[0]
    return (_heads(dense(enc_out, p["wk"]), h, hd, lc, qs)[0],
            _heads(dense(enc_out, p["wv"]), h, hd, lc, qs)[0])


def cross_cache(cfg, p: Tree, ck, cv, lc):
    """`cross_kv`'s K and V in the cache's layout."""
    h, dims = cfg.n_heads, lc.cache_dims or {}
    qs = _spans(p, h, cfg.head_dim, 1, lc)[0]
    first = 0 if ck.shape[2] == h else qs[lc.rank][0]
    return tuple(_cache_layout(t, first, h, dims.get(n), lc, qs)
                 for t, n in ((ck, "ck"), (cv, "cv")))


def cross_attend(cfg, p: Tree, x, k, v, lc=None):
    """x (B, Sq, D) attends over the cross K/V (B, Sk, H, Dh), no mask and
    no RoPE, in `cfg.q_chunk` query rows at a time: each row's softmax is
    its own, so the values are those of one pass, and the live f32 logits
    are (B, H, q_chunk, Sk) (ROADMAP.md §C (24)). On a rank's shards, the
    heads its `wo` rows read, over K/V of those heads (`cross_kv`)."""
    sq = x.shape[1]
    h, hd = cfg.n_heads, cfg.head_dim
    qs = _spans(p, h, hd, 1, lc)[0]
    q, q0 = _heads(dense(x, p["wq"]), h, hd, lc, qs)
    if lc is not None:
        h0, h1 = qs[lc.rank]
        q, q0 = q[:, :, h0 - q0:h1 - q0], h0
        k0 = 0 if k.shape[2] == h else h0
        k, v = (_kv_for_heads(t, k0, h0, h1, 1) for t in (k, v))
    parts = [_grouped_attn(q[:, c0:c0 + cfg.q_chunk], k, v, None)
             for c0 in range(0, sq, cfg.q_chunk)]
    o = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return _out(p, o, h, q0, lc)


def cross_full(cfg, p: Tree, x, enc_out):
    """x: (B, Sq, D) attends over enc_out (B, Sk, D) (no mask, no rope)."""
    return cross_attend(cfg, p, x, *cross_kv(cfg, p, enc_out))
