"""RWKV6 ("Finch") block: data-dependent-decay linear attention — port of
`repro.models.rwkv`.

Train and prefill run the chunked WKV recurrence

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

chunk by chunk in a Python loop that carries the f32 state: within a chunk
of length C, an inter-chunk term (the carried state), an intra-chunk
"attention" with relative-decay weights kept as the masked (C, C, K)
exponent tensor, and the state update. Every exponent is a difference of
cumulative log decays with s <= t, so <= 0: nothing overflows. The
reference runs a sequence whose length is not a multiple of `chunk` as one
chunk, a (B, H, S, S, K) f32 tensor (92 GB at rwkv6-3b for a 3,000-token
prompt); the port runs the full chunks and then a ragged last chunk for any
S, the same sums in another order (ROADMAP.md §C (22)).

Decode is the O(1)-state step. It writes the carried state and the token
shift (`state`, `x_prev`) IN PLACE and returns those tensors, where the
reference returns new arrays, as `attention.gqa_decode` does with K/V
(ROADMAP.md §C (16)).

Under a sharding context the mixers run on one rank's shards inside the
layer's `local_map` (each function's `lc`): time mixing on the heads the
rank's `wo` rows read (`_span`: its own where the heads split evenly,
else the two or three that overlap its rows, their r, k, v, g columns
fetched from the ranks' column shards by `Local.exchange`), the decay
and the head norm's weights sliced to those channels, the output partial
through `wo`'s row shard; where the heads do not split, the cache splits
the state's key dim (`_state_layout`; decode sums r's product over the
ranks' slices). Channel mixing runs k through its column shard, the
partial `kk @ wv` reduce-scattered onto the rank's channels, gated there
by r's column shard, and the result all-gathered whole. Under
Megatron-SP both mixers take the sequence all-gathered by the layer
(`parallel.Local.enter`), so each token shift reads its previous token
across the shards' boundaries, and the prefill's `xp_tm`, `xp_cm` and
`state` are the whole sequence's on every rank.

Casts follow the reference's: r, k, v and the log decays in f32 (the
decay LoRA's products too), the mixing weights in the activation dtype,
the head group norm in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, Tree, matmul

LORA_MIX = 32     # TIME_MIX_EXTRA_DIM
LORA_DECAY = 64


def time_mix_spec(cfg) -> Tree:
    d = cfg.d_model
    h = d // cfg.rwkv_head_dim
    k = cfg.rwkv_head_dim
    f32 = torch.float32
    return {
        "mu_x": ParamSpec((d,), ("embed",), init="zeros", dtype=f32),
        "mu5": ParamSpec((5, d), ("null", "embed"), init="zeros", dtype=f32),
        "lora_a": ParamSpec((d, 5 * LORA_MIX), ("embed", "null")),
        "lora_b": ParamSpec((5, LORA_MIX, d), ("null", "null", "embed")),
        "w0": ParamSpec((d,), ("embed",), init="const", scale=-0.6, dtype=f32),
        "wa": ParamSpec((d, LORA_DECAY), ("embed", "null")),
        "wb": ParamSpec((LORA_DECAY, d), ("null", "embed")),
        "u": ParamSpec((h, k), ("heads", "head_dim"), init="normal",
                       scale=0.3, dtype=f32),
        "wr": ParamSpec((d, d), ("embed", "heads")),
        "wk": ParamSpec((d, d), ("embed", "heads")),
        "wv": ParamSpec((d, d), ("embed", "heads")),
        "wg": ParamSpec((d, d), ("embed", "heads")),
        "wo": ParamSpec((d, d), ("heads", "embed")),
        "ln_scale": ParamSpec((d,), ("embed",), init="ones", dtype=f32),
        "ln_bias": ParamSpec((d,), ("embed",), init="zeros", dtype=f32),
    }


def channel_mix_spec(cfg) -> Tree:
    d, f = cfg.d_model, cfg.d_ff
    f32 = torch.float32
    return {
        "mu_r": ParamSpec((d,), ("embed",), init="zeros", dtype=f32),
        "mu_k": ParamSpec((d,), ("embed",), init="zeros", dtype=f32),
        "wr": ParamSpec((d, d), ("embed", "mlp")),
        "wk": ParamSpec((d, f), ("embed", "mlp")),
        "wv": ParamSpec((f, d), ("mlp", "embed")),
    }


def _ddlerp(p: Tree, x, sx):
    """Data-dependent token-shift mixing -> [xw, xk, xv, xr, xg]."""
    base = x + sx * p["mu_x"].to(x.dtype)
    lo = torch.tanh(matmul(base, p["lora_a"]))               # (..., 5*LM)
    lo = lo.unflatten(-1, (5, LORA_MIX))
    delta = torch.einsum("...cl,cld->c...d", lo, p["lora_b"].to(lo.dtype))
    return [x + sx * (p["mu5"][c].to(x.dtype) + delta[c].to(x.dtype))
            for c in range(5)]


def _head_groupnorm(p: Tree, o, h: int, k: int, eps: float = 64e-5,
                    span=None):
    """Per-head LayerNorm over the value dim (RWKV's GroupNorm(H)), in f32
    with the population variance (jnp.var's); on a rank's heads, the
    channels [c0, c1) of the scale and bias (`span`)."""
    b, t, d = o.shape
    of = o.reshape(b, t, -1, k).float()
    mu = of.mean(-1, keepdim=True)
    var = of.var(-1, keepdim=True, correction=0)
    of = (of - mu) * torch.rsqrt(var + eps)
    scale, bias = p["ln_scale"], p["ln_bias"]
    if scale.shape[0] != d:
        scale, bias = scale[span[0]:span[1]], bias[span[0]:span[1]]
    return of.reshape(b, t, d) * scale + bias


def _chunk_wkv(r, k, v, logw, u, state):
    """One chunk of the WKV recurrence.

    r/k/v: (B, H, C, K) f32; logw: (B, H, C, K) (<= 0); u: (H, K);
    state: (B, H, K, V) f32. Returns (o (B,H,C,V), new_state).
    """
    la = torch.cumsum(logw, dim=2)                           # (B,H,C,K)
    lp = la - logw                                           # La(t-1)
    # inter-chunk: r_t decayed to chunk start times carry state
    o_inter = (r * torch.exp(lp)) @ state
    # intra-chunk: masked pairwise decayed scores, s < t
    c = r.shape[2]
    pos = torch.arange(c, device=r.device)
    later = (pos[:, None] > pos[None, :])[None, None, :, :, None]
    expo = lp[:, :, :, None, :] - la[:, :, None, :, :]       # (B,H,t,s,K)
    pw = torch.exp(expo.masked_fill(~later, float("-inf")))
    scores = (r[:, :, :, None, :] * k[:, :, None, :, :] * pw).sum(-1)
    diag = (r * u[:, None, :] * k).sum(-1)                   # (B,H,C)
    scores = scores + torch.diag_embed(diag)
    o_intra = scores @ v
    # state update: decay to chunk end
    k_dec = k * torch.exp(la[:, :, -1:, :] - la)             # e^{La(C)-La(t)}
    new_state = (state * torch.exp(la[:, :, -1, :])[..., None]
                 + k_dec.transpose(-1, -2) @ v)
    return o_inter + o_intra, new_state


def _decay(p: Tree, xw):
    """The log decays -exp(w0 + tanh(xw wa) wb), f32, every channel."""
    return -torch.exp(p["w0"].float()
                      + torch.tanh(xw.float() @ p["wa"].float())
                      @ p["wb"].float())


def _span(p: Tree, d: int, hk: int, lc, rank=None):
    """(c0, c1, off): the channels [c0, c1) of the heads whose outputs the
    rank's (or `rank`'s) `wo` rows read, and where those rows start in
    them; every channel where `wo` is whole."""
    rows = p["wo"].shape[0]
    if lc is None or rows == d:
        return 0, d, 0
    r0 = (lc.rank if rank is None else rank) * rows
    c0 = r0 // hk * hk
    return c0, -(-(r0 + rows) // hk) * hk, r0 - c0


def _proj(x, w, d: int, hk: int, lc, spans=None):
    """x @ w on the rank's columns, and its first channel: every channel
    where `w` is whole; else the channels [c0, c1) = spans[rank]: the
    rank's own where its column shard holds just those, else their
    columns from the ranks' shards (`Local.exchange`). Without `spans`:
    the rank's heads where the model dim splits them evenly, else every
    channel, all-gathered."""
    t = matmul(x, w)
    if lc is None or t.shape[-1] == d:
        return t, 0
    n = t.shape[-1]
    if spans is None:
        if (d // hk) % lc.tp == 0:
            return t, lc.rank * n
        return lc.gather(t, t.dim() - 1), 0
    a, b = spans[lc.rank]
    if b - a == n and a == lc.rank * n:
        return t, a
    src = [range(q * n, (q + 1) * n) for q in range(lc.tp)]
    return lc.exchange(t, src, [range(x0, x1) for x0, x1 in spans]), a


def _state_layout(p: Tree, st, h: int, hk: int, lc):
    """A prefill's final state (B, h_t, K, K) of the rank's heads
    (`time_mix_full`) in its cache's layout: as it is where the cache
    splits the heads; where it splits the key dim (heads that do not
    split evenly), the rank's slice of every head's: each head is taken
    from the rank whose `wo` rows start in it, and one reduce-scatter over
    the key dim hands out the slices."""
    if lc is None or (lc.cache_dims or {}).get("state") != 2:
        return st
    d = h * hk
    if all(_span(p, d, hk, lc, r)[:2] == (0, d) for r in range(lc.tp)):
        return lc.take(st, 2)
    rows = p["wo"].shape[0]
    h0 = _span(p, d, hk, lc)[0] // hk
    full = st.new_zeros(st.shape[0], h, hk, hk)
    for j in range(h0, h0 + st.shape[1]):
        if j * hk // rows == lc.rank:
            full[:, j] = st[:, j - h0]
    return lc.scatter(full, 2)


def time_mix_full(cfg, p: Tree, x, *, chunk: int = 64,
                  state=None, x_prev=None, return_state: bool = False,
                  lc=None):
    """RWKV6 attention over a full sequence. x: (B, S, D). With
    `return_state`: (out, state (B, H, K, K) f32, x[:, -1:]). On a rank's
    shards: the heads its `wo` rows read (`_span`), their output rows
    partial through its `wo` shard, and the state of those heads."""
    b, s, d = x.shape
    hk = cfg.rwkv_head_dim
    c0, c1, off = _span(p, d, hk, lc)
    spans = (None if lc is None
             else [_span(p, d, hk, lc, r)[:2] for r in range(lc.tp)])
    h = (c1 - c0) // hk
    if x_prev is None:
        x_prev = x.new_zeros(b, 1, d)
    sx = torch.cat([x_prev, x[:, :-1]], dim=1) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)
    del sx

    def chans(t, first):                         # channels [c0, c1)
        return t if t.shape[-1] == c1 - c0 else t[..., c0 - first:c1 - first]

    def heads(t):                                            # (B,H,S,K) f32
        return t.reshape(b, s, h, hk).transpose(1, 2).float().contiguous()

    r = heads(chans(*_proj(xr, p["wr"], d, hk, lc, spans)))
    kk = heads(chans(*_proj(xk, p["wk"], d, hk, lc, spans)))
    v = heads(chans(*_proj(xv, p["wv"], d, hk, lc, spans)))
    g = F.silu(chans(*_proj(xg, p["wg"], d, hk, lc, spans)))
    del xk, xv, xr, xg
    logw = heads(chans(_decay(p, xw), 0))
    del xw
    u = p["u"] if p["u"].shape[0] == h else p["u"][c0 // hk:c1 // hk]

    if state is None:
        state = x.new_zeros(b, h, hk, hk, dtype=torch.float32)
    outs = []
    for t0 in range(0, s, chunk):
        at = slice(t0, t0 + chunk)
        o, state = _chunk_wkv(r[:, :, at], kk[:, :, at], v[:, :, at],
                              logw[:, :, at], u, state)
        outs.append(o)
    del r, kk, v, logw
    o = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
    del outs
    o = o.transpose(1, 2).reshape(b, s, c1 - c0)
    o = _head_groupnorm(p, o, h, hk, span=(c0, c1)).to(x.dtype) * g
    rows = p["wo"].shape[0]
    out = matmul(o if rows == c1 - c0 else o[..., off:off + rows], p["wo"])
    if return_state:
        return out, state, x[:, -1:].clone()
    return out


def time_mix_step(cfg, p: Tree, x, state, x_prev, lc=None):
    """O(1) decode step. x: (B, 1, D); state: (B, H, K, V) f32; x_prev:
    (B, 1, D). Writes `state` and `x_prev` in place and returns them. On
    a rank's shards, with the state of its heads, or of every head's
    slice of the key dim (heads that do not split evenly)."""
    b, one, d = x.shape
    hk = cfg.rwkv_head_dim
    sx = x_prev - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)
    r, first = _proj(xr, p["wr"], d, hk, lc)
    h = r.shape[-1] // hk
    r = r.reshape(b, h, hk).float()
    kk = _proj(xk, p["wk"], d, hk, lc)[0].reshape(b, h, hk).float()
    v = _proj(xv, p["wv"], d, hk, lc)[0].reshape(b, h, hk).float()
    g = F.silu(_proj(xg, p["wg"], d, hk, lc)[0])
    logw = _decay(p, xw)
    w = torch.exp(logw[..., first:first + h * hk].reshape(b, h, hk))

    ru_kv = (r * p["u"] * kk).sum(-1)                        # (B,H)
    if state.shape[2] != hk:
        # the state's key dim split over the model dim (heads that do not
        # divide it): r's product summed from the ranks' slices
        r, kk, w = (lc.take(t, -1) for t in (r, kk, w))
        o = lc.reduce((r[:, :, None, :] @ state)[:, :, 0])
    else:
        o = (r[:, :, None, :] @ state)[:, :, 0]
    o = o + ru_kv[..., None] * v
    state.mul_(w[..., None]).add_(kk[..., :, None] * v[..., None, :])
    x_prev.copy_(x)

    # the heads the rank's wo rows read, from those it holds
    c0, c1, off = _span(p, d, hk, lc)
    o = o.reshape(b, 1, h * hk)[..., c0 - first:c1 - first]
    o = _head_groupnorm(p, o, (c1 - c0) // hk, hk, span=(c0, c1))
    o = o.to(x.dtype) * g[..., c0 - first:c1 - first]
    rows = p["wo"].shape[0]
    return (matmul(o if rows == c1 - c0 else o[..., off:off + rows],
                   p["wo"]), state, x_prev)


def _channel_mix(p: Tree, x, sx, lc=None):
    """sigmoid(xr wr) * (relu(xk wk)^2 wv); on a rank's shards the partial
    `kk @ wv` reduce-scattered onto the rank's channels, gated there, and
    all-gathered whole (the block's output is not partial). Under
    Megatron-SP x is the gathered sequence and the layer keeps its rows of
    the output, so the gather's backward sums the ranks' gradients."""
    xr = x + sx * p["mu_r"].to(x.dtype)
    xk = x + sx * p["mu_k"].to(x.dtype)
    kk = torch.square(F.relu(matmul(xk, p["wk"])))
    if lc is None or not lc.sharded:
        return torch.sigmoid(matmul(xr, p["wr"])) * matmul(kk, p["wv"])
    vv = lc.scatter(matmul(kk, p["wv"]), -1)
    return lc.gather(torch.sigmoid(matmul(xr, p["wr"])) * vv, -1,
                     partial=lc.seq)


def channel_mix_full(cfg, p: Tree, x, x_prev=None, lc=None):
    b, s, d = x.shape
    if x_prev is None:
        x_prev = x.new_zeros(b, 1, d)
    sx = torch.cat([x_prev, x[:, :-1]], dim=1) - x
    return _channel_mix(p, x, sx, lc)


def channel_mix_step(cfg, p: Tree, x, x_prev, lc=None):
    """One token; writes `x_prev` in place and returns it."""
    sx = x_prev - x
    x_prev.copy_(x)
    return _channel_mix(p, x, sx, lc), x_prev
