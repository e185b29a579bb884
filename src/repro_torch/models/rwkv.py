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


def _head_groupnorm(p: Tree, o, h: int, k: int, eps: float = 64e-5):
    """Per-head LayerNorm over the value dim (RWKV's GroupNorm(H)), in f32
    with the population variance (jnp.var's)."""
    b, t, d = o.shape
    of = o.reshape(b, t, h, k).float()
    mu = of.mean(-1, keepdim=True)
    var = of.var(-1, keepdim=True, correction=0)
    of = (of - mu) * torch.rsqrt(var + eps)
    return of.reshape(b, t, d) * p["ln_scale"] + p["ln_bias"]


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


def time_mix_full(cfg, p: Tree, x, *, chunk: int = 64,
                  state=None, x_prev=None, return_state: bool = False):
    """RWKV6 attention over a full sequence. x: (B, S, D). With
    `return_state`: (out, state (B, H, K, K) f32, x[:, -1:])."""
    b, s, d = x.shape
    hk = cfg.rwkv_head_dim
    h = d // hk
    if x_prev is None:
        x_prev = x.new_zeros(b, 1, d)
    sx = torch.cat([x_prev, x[:, :-1]], dim=1) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)
    del sx

    def heads(t):                                            # (B,H,S,K) f32
        return t.reshape(b, s, h, hk).transpose(1, 2).float().contiguous()

    r = heads(matmul(xr, p["wr"]))
    kk = heads(matmul(xk, p["wk"]))
    v = heads(matmul(xv, p["wv"]))
    g = F.silu(matmul(xg, p["wg"]))
    del xk, xv, xr, xg
    logw = heads(-torch.exp(
        p["w0"].float()
        + torch.tanh(xw.float() @ p["wa"].float()) @ p["wb"].float()))
    del xw

    if state is None:
        state = x.new_zeros(b, h, hk, hk, dtype=torch.float32)
    outs = []
    for t0 in range(0, s, chunk):
        at = slice(t0, t0 + chunk)
        o, state = _chunk_wkv(r[:, :, at], kk[:, :, at], v[:, :, at],
                              logw[:, :, at], p["u"], state)
        outs.append(o)
    del r, kk, v, logw
    o = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
    del outs
    o = o.transpose(1, 2).reshape(b, s, d)
    o = _head_groupnorm(p, o, h, hk).to(x.dtype) * g
    out = matmul(o, p["wo"])
    if return_state:
        return out, state, x[:, -1:].clone()
    return out


def time_mix_step(cfg, p: Tree, x, state, x_prev):
    """O(1) decode step. x: (B, 1, D); state: (B, H, K, V) f32; x_prev:
    (B, 1, D). Writes `state` and `x_prev` in place and returns them."""
    b, one, d = x.shape
    hk = cfg.rwkv_head_dim
    h = d // hk
    sx = x_prev - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)
    r = matmul(xr, p["wr"]).reshape(b, h, hk).float()
    kk = matmul(xk, p["wk"]).reshape(b, h, hk).float()
    v = matmul(xv, p["wv"]).reshape(b, h, hk).float()
    g = F.silu(matmul(xg, p["wg"]))
    logw = -torch.exp(
        p["w0"].float()
        + torch.tanh(xw.float() @ p["wa"].float()) @ p["wb"].float())
    w = torch.exp(logw.reshape(b, h, hk))

    ru_kv = (r * p["u"] * kk).sum(-1)                        # (B,H)
    o = (r[:, :, None, :] @ state)[:, :, 0] + ru_kv[..., None] * v
    state.mul_(w[..., None]).add_(kk[..., :, None] * v[..., None, :])
    x_prev.copy_(x)

    o = o.reshape(b, 1, d)
    o = _head_groupnorm(p, o, h, hk).to(x.dtype) * g
    return matmul(o, p["wo"]), state, x_prev


def channel_mix_full(cfg, p: Tree, x, x_prev=None):
    b, s, d = x.shape
    if x_prev is None:
        x_prev = x.new_zeros(b, 1, d)
    sx = torch.cat([x_prev, x[:, :-1]], dim=1) - x
    xr = x + sx * p["mu_r"].to(x.dtype)
    xk = x + sx * p["mu_k"].to(x.dtype)
    kk = torch.square(F.relu(matmul(xk, p["wk"])))
    return torch.sigmoid(matmul(xr, p["wr"])) * matmul(kk, p["wv"])


def channel_mix_step(cfg, p: Tree, x, x_prev):
    """One token; writes `x_prev` in place and returns it."""
    sx = x_prev - x
    xr = x + sx * p["mu_r"].to(x.dtype)
    xk = x + sx * p["mu_k"].to(x.dtype)
    x_prev.copy_(x)
    kk = torch.square(F.relu(matmul(xk, p["wk"])))
    return torch.sigmoid(matmul(xr, p["wr"])) * matmul(kk, p["wv"]), x_prev
