"""Mamba-1 selective SSM block (for the Jamba hybrid) — port of
`repro.models.mamba`.

Under a sharding context the block runs on one rank's shards inside the
layer's `local_map`, the inner dim d_in split over the model dim (the
scan reduces over none of it): `in_proj`, the conv, `dt_w` and the state
on the rank's channels; the x_proj product partial over them and summed
by one all-reduce (whose gradient is summed too: every rank reads it);
the output partial through `out_proj`'s row shard. The reference's batch
pins (`anchor`) are GSPMD constraints; a local shard keeps its batch.

Train and prefill run the chunked selective scan: within a chunk the
recurrence h_t = Abar_t h_{t-1} + dBx_t is an associative scan over the
chunk axis (`_linear_scan`, the odd-even recursion of
`jax.lax.associative_scan`: 2 log2(C) levels of torch ops, O(C) work,
multiplying only decays in (0, 1]), plus the carried state decayed by
exp(cumulative log decay) (exponents <= 0). The carry crosses chunks in a
Python loop; the live set is (B, C, d_in, N) f32. The reference runs a
sequence whose length is not a multiple of `chunk` as one chunk, a (B, S,
d_in, N) tensor; the port runs the full chunks and then a ragged last
chunk for any S, the same sums in another order (ROADMAP.md §C (22)).

Decode is the O(1) state step plus a (kc - 1)-deep conv window. It writes
both (`state`, `conv_state`) IN PLACE and returns those tensors, where the
reference returns new arrays (ROADMAP.md §C (16)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, Tree, matmul


def mamba_spec(cfg) -> Tree:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    kc = cfg.mamba_conv
    dt_rank = -(-d // 16)
    f32 = torch.float32
    return {
        "in_proj": ParamSpec((d, 2, di), ("embed", "null", "mlp")),
        "conv_w": ParamSpec((kc, di), ("conv", "mlp"), init="normal",
                            scale=0.2),
        "conv_b": ParamSpec((di,), ("mlp",), init="zeros", dtype=f32),
        "x_proj": ParamSpec((di, dt_rank + 2 * n), ("mlp", "null")),
        "dt_w": ParamSpec((dt_rank, di), ("null", "mlp")),
        "dt_b": ParamSpec((di,), ("mlp",), init="const", scale=-4.6,
                          dtype=f32),  # softplus^-1(~0.01)
        "a_log": ParamSpec((di, n), ("mlp", "state"), init="const", scale=0.0,
                           dtype=f32),
        "dskip": ParamSpec((di,), ("mlp",), init="ones", dtype=f32),
        "out_proj": ParamSpec((di, d), ("mlp", "embed")),
    }


def _in_proj(p: Tree, x):
    """x (B, S, D) @ in_proj (D, 2, di) -> (xin, z), each (B, S, di)."""
    d, _, di = p["in_proj"].shape
    xz = matmul(x, p["in_proj"].reshape(d, 2 * di))
    return xz[..., :di], xz[..., di:]


def _ssm_params(cfg, p: Tree, u, lc=None):
    """u: (B, T, di) post-conv activations -> (dt, Bmat, Cmat) f32."""
    d = cfg.d_model
    n = cfg.mamba_d_state
    dt_rank = -(-d // 16)
    xdbc = matmul(u, p["x_proj"])                            # (B,T,rank+2N)
    if lc is not None and lc.sharded:
        xdbc = lc.reduce(xdbc, both=True)
    dt_low = xdbc[..., :dt_rank]
    bmat = xdbc[..., dt_rank:dt_rank + n].float()
    cmat = xdbc[..., dt_rank + n:].float()
    dt = F.softplus(matmul(dt_low, p["dt_w"]).float()
                    + p["dt_b"])                             # (B,T,di)
    return dt, bmat, cmat


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h = 0: the inclusive scan
    of (a, b) pairs under (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), by
    `jax.lax.associative_scan`'s recursion (adjacent pairs combined, the
    odd positions scanned recursively, the even ones filled in from them),
    so its products are the reference's."""
    n = a.shape[1]
    if n < 2:
        return b
    a_o, b_o = a[:, 1::2], b[:, 1::2]
    odd = _linear_scan(a[:, 0:-1:2] * a_o, a_o * b[:, 0:-1:2] + b_o)
    prev = odd if n % 2 else odd[:, :-1]
    h = torch.empty_like(b)
    h[:, :1] = b[:, :1]
    h[:, 2::2] = a[:, 2::2] * prev + b[:, 2::2]
    h[:, 1::2] = odd
    return h


def _chunk_ssm(dt, bmat, cmat, u, a, h0):
    """One chunk. dt/u: (B,C,di); bmat/cmat: (B,C,N); a: (di,N) (< 0);
    h0: (B,di,N). Returns (y (B,C,di), h_end)."""
    dta = dt[..., None] * a                                  # (B,C,di,N)
    la = torch.cumsum(dta, dim=1)                            # <= 0
    dbx = (dt * u.float())[..., None] * bmat[:, :, None, :]
    # h_t = e^{la_t} h0 + sum_{s<=t} e^{la_t - la_s} dbx_s: the carry term's
    # exponents are <= 0; the in-chunk term multiplies decays in (0, 1]
    h_all = _linear_scan(torch.exp(dta), dbx) + torch.exp(la) * h0[:, None]
    y = (h_all @ cmat[..., None])[..., 0]                    # (B,C,di)
    return y, h_all[:, -1].clone()


def mamba_full(cfg, p: Tree, x, *, chunk: int = 256, state=None,
               conv_state=None, return_state: bool = False, ctx=None):
    """x: (B, S, D) -> (B, S, D). Causal conv + selective scan. With
    `return_state`: (out, state (B, di, N) f32, conv window (B, kc-1, di)).
    `ctx` is the block's `parallel.Local` on one rank's shards (None: one
    device)."""
    b, s, d = x.shape
    di = p["in_proj"].shape[-1]
    n = cfg.mamba_d_state
    kc = cfg.mamba_conv

    xin, z = _in_proj(p, x)                                  # (B,S,di)
    if conv_state is None:
        conv_state = x.new_zeros(b, kc - 1, di)
    xpad = torch.cat([conv_state, xin], dim=1)               # (B,S+kc-1,di)
    del xin
    u = sum(xpad[:, i:i + s] * p["conv_w"][i].to(x.dtype) for i in range(kc))
    u = F.silu(u + p["conv_b"].to(x.dtype))

    dt, bmat, cmat = _ssm_params(cfg, p, u, ctx)
    a = -torch.exp(p["a_log"])                               # (di,N) < 0

    if state is None:
        state = x.new_zeros(b, di, n, dtype=torch.float32)
    ys = []
    for t0 in range(0, s, chunk):
        at = slice(t0, t0 + chunk)
        y, state = _chunk_ssm(dt[:, at], bmat[:, at], cmat[:, at], u[:, at],
                              a, state)
        ys.append(y)
    del dt, bmat, cmat
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    del ys

    y = y + u.float() * p["dskip"]
    out = matmul(y.to(x.dtype) * F.silu(z), p["out_proj"])
    if return_state:
        return (out, state,
                xpad[:, -(kc - 1):].clone() if kc > 1 else conv_state)
    return out


def mamba_step(cfg, p: Tree, x, state, conv_state, lc=None):
    """Decode step. x: (B,1,D); state: (B,di,N) f32; conv_state:
    (B,kc-1,di). Writes `state` and `conv_state` in place and returns
    them."""
    kc = cfg.mamba_conv
    xin, z = _in_proj(p, x)                                  # (B,1,di)

    xwin = torch.cat([conv_state, xin], dim=1)               # (B,kc,di)
    u = sum(xwin[:, i:i + 1] * p["conv_w"][i].to(x.dtype) for i in range(kc))
    u = F.silu(u + p["conv_b"].to(x.dtype))                  # (B,1,di)
    conv_state.copy_(xwin[:, 1:])

    dt, bmat, cmat = _ssm_params(cfg, p, u, lc)
    a = -torch.exp(p["a_log"])
    abar = torch.exp(dt[:, 0, :, None] * a)                  # (B,di,N)
    dbx = (dt[:, 0] * u[:, 0].float())[..., None] * bmat[:, 0, None, :]
    state.mul_(abar).add_(dbx)
    y = (state @ cmat[:, 0, :, None])[..., 0][:, None]       # (B,1,di)
    y = y + u.float() * p["dskip"]
    out = matmul(y.to(x.dtype) * F.silu(z), p["out_proj"])
    return out, state, conv_state
