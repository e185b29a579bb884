"""Causal (or full) attention with an online softmax — wrapper and plain
version of the CUDA kernels in `csrc/flash_attn.cu`.

Port of `repro.kernels.flash_attn` (`flash_attention`, `ref_attention`), with
the same contract: q, k, v `(B, H, S, D)` with equal heads, float32 or
bfloat16, `S` divisible by `bq` and `bk`; the output has the input's dtype.
Logits, softmax statistics and the accumulator are float32.

A CUDA tensor launches a kernel or raises; a CPU tensor runs
`flash_attention_plain`, the plain PyTorch version of the same function,
which the tests and the chip smoke hold the kernels against. `_route`
picks the kernel by dtype and head dim: bfloat16 with `D % 8 == 0` runs the
tensor-core kernel ("wgmma": bf16 products, P split into two bf16 terms
for the PV product), float32 and other bfloat16 head dims the CUDA-core
kernel ("fma": f32 products). Both take head dims up to 128. `bq` and `bk`
keep the reference's contract (`S` divisible by both) but only set the
TPU kernel's order of summation: each CUDA kernel tiles its own way,
masking a partial last tile.

`flash_attention` is differentiable on every device through one
`torch.autograd.Function`: its forward is the dispatch above (the kernel
on a CUDA tensor, the plain version on a CPU one), its backward
`flash_attention_backward_plain`, plain PyTorch on both devices, which
recomputes P in f32 from the saved q, k, v. The reference has no backward
kernel: it differentiates its grouped einsum (ROADMAP.md §C (19)).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.utils import trace

NEG_INF = -1e30

ROUTES = ("wgmma", "fma")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, o; bh, S, D; scale; causal; stream
_ARGTYPES = [_P] * 4 + [_I] * 3 + [ctypes.c_float, _I, _P]


def __getattr__(name):
    # CUDA kernel launches in this process: `LAUNCHES_BY_ROUTE` per route,
    # the counters `flash_attn.<route>` of `utils.trace`; `LAUNCHES` their
    # total
    if name in ("LAUNCHES", "LAUNCHES_BY_ROUTE"):
        counts = trace.counters()
        by_route = {r: counts.get(f"flash_attn.{r}", 0) for r in ROUTES}
        return by_route if name == "LAUNCHES_BY_ROUTE" else sum(
            by_route.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _lib():
    """The built `csrc/flash_attn.cu` with its C entries' signatures set:
    `flash_attn_fwd` (fma route, after a dtype code),
    `flash_attn_fwd_wgmma` (bf16 only) and `flash_attn_wgmma_smem_bytes`
    (a wgmma block's shared memory for a padded head dim)."""
    lib = _build.load("flash_attn")
    lib.flash_attn_fwd.argtypes = [_I] + _ARGTYPES
    lib.flash_attn_fwd_wgmma.argtypes = _ARGTYPES
    lib.flash_attn_wgmma_smem_bytes.argtypes = [_I]
    for fn in (lib.flash_attn_fwd, lib.flash_attn_fwd_wgmma,
               lib.flash_attn_wgmma_smem_bytes):
        fn.restype = ctypes.c_int
    return lib


def _route(dtype: torch.dtype, d: int) -> str:
    """Which CUDA kernel runs a head dim `d` of `dtype`: "wgmma" (tensor
    cores) for bfloat16 with d % 8 == 0, whose rows TMA can load, else
    "fma" (CUDA cores; float32 keeps full f32 products, as the reference's
    2e-4 tolerance needs). A head dim above 128 raises: neither kernel
    takes it."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernels take head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    return "wgmma" if dtype == torch.bfloat16 and d % 8 == 0 else "fma"


def _check(q, k, v, bq: int, bk: int) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise ValueError(f"{name} must be a (B, H, S, D) tensor")
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"q, k, v must have equal shapes (equal heads), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    s = q.shape[2]
    if bq < 1 or bk < 1 or s % bq or s % bk:
        raise ValueError(f"sequence length {s} must be divisible by bq={bq} "
                         f"and bk={bk}")


def flash_attention(q, k, v, *, bq: int = 128, bk: int = 128,
                    causal: bool = True) -> torch.Tensor:
    """q/k/v: (B, H, S, D) -> (B, H, S, D), S divisible by bq and bk.

    A CPU tensor runs the plain version; any other device goes to the CUDA
    kernel, which raises for what it cannot run. Either way the output
    carries `_FlashFunction`'s node when an input requires grad."""
    _check(q, k, v, bq, bk)
    return _FlashFunction.apply(q, k, v, causal)


class _FlashFunction(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward:
    `flash_attention_backward_plain` on the saved q, k, v, on both."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal)
        return _flash_attention_cuda(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_backward_plain(
            q, k, v, dout.contiguous(), ctx.causal), None)


def _flash_attention_cuda(q, k, v, *, causal):
    b, h, s, d = q.shape
    route = _route(q.dtype, d)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash-attention kernel runs on CUDA tensors, "
                         f"got {dev}")
    lib = _lib()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    ptrs = [x.data_ptr() for x in (q, k, v, out)]
    args = (*ptrs, b * h, s, d, 1.0 / d ** 0.5, int(causal))
    if route == "wgmma" and any(p % 16 for p in ptrs):
        raise ValueError("the wgmma kernel loads q, k, v by TMA, which needs "
                         "16-byte aligned tensors")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "wgmma":
            rc = lib.flash_attn_fwd_wgmma(*args, stream)
        else:
            rc = lib.flash_attn_fwd(_DTYPE_CODES[q.dtype], *args, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn {route} kernel launch failed: CUDA "
                           f"error {rc}")
    trace.count(f"flash_attn.{route}")
    return out


# one bf16 rounding: |out - plain| <= 2^-7 |plain| + 1e-5 per element. Two
# roundings of the same f32 value (up to summation order) to bf16 can differ
# by one bf16 ulp, at most 2^-7 of the value; 1e-5 covers values near 0.
ELEMENT_REL, ELEMENT_ABS = 2.0 ** -7, 1e-5


def element_ratio(out, plain) -> float:
    """max over elements of |out - plain| / (2^-7 |plain| + 1e-5): at most 1
    when every element of `out` is within one bf16 rounding of `plain`'s."""
    out, plain = out.float(), plain.float()
    return float(((out - plain).abs()
                  / (ELEMENT_REL * plain.abs() + ELEMENT_ABS)).max())


# bytes of float32 logits one step of the plain version may hold
PLAIN_LOGIT_BYTES = 1 << 30


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          logit_bytes: int = PLAIN_LOGIT_BYTES):
    """The kernel's function in plain PyTorch, on any device: the
    reference's oracle (`ref_attention`) — f32 logits divided by sqrt(D),
    the causal mask at NEG_INF, a softmax, the product with f32 values,
    rounded to the input dtype — computed per head in chunks of query rows
    so that one chunk's logits stay under `logit_bytes`. Under the causal
    mask a chunk reads only the keys up to its last row: the others would
    weigh exactly 0."""
    b, h, s, d = q.shape
    f32 = torch.float32
    out = torch.empty_like(q)
    qf, kf, vf = (x.reshape(b * h, s, d) for x in (q, k, v))
    of = out.view(b * h, s, d)
    rows = max(1, min(s, logit_bytes // (4 * max(s, 1))))
    for g in range(b * h):
        kg, vg = kf[g].to(f32), vf[g].to(f32)
        for r0 in range(0, s, rows):
            r1 = min(s, r0 + rows)
            kend = r1 if causal else s
            logits = (qf[g, r0:r1].to(f32) @ kg[:kend].T) / (d ** 0.5)
            if causal:
                qpos = torch.arange(r0, r1, device=q.device)[:, None]
                kpos = torch.arange(kend, device=q.device)[None, :]
                logits = logits.masked_fill(kpos > qpos, NEG_INF)
            p = torch.softmax(logits, dim=-1)
            of[g, r0:r1] = (p @ vg[:kend]).to(q.dtype)
    return out


def flash_attention_backward_plain(q, k, v, dout, causal: bool = True, *,
                                   logit_bytes: int = PLAIN_LOGIT_BYTES):
    """(dq, dk, dv) of `flash_attention` at (q, k, v) for the output's
    gradient `dout`, in plain PyTorch on any device, each rounded once to
    the input dtype. P is recomputed in f32 as the plain version computes
    it (the causal mask at NEG_INF, a softmax over logits divided by
    sqrt(D)), for groups of heads or chunks of query rows whose logits stay
    under `logit_bytes`; then dV = Pᵀ dO, dP = dO Vᵀ,
    dS = P ∘ (dP − rowsum(P ∘ dP)), dQ = dS K / sqrt(D) and
    dK = dSᵀ Q / sqrt(D). dK and dV sum over row chunks in f32."""
    b, h, s, d = q.shape
    f32, scale = torch.float32, d ** 0.5
    grads = [torch.empty_like(x) for x in (q, k, v)]
    qf, kf, vf, dof = (x.reshape(b * h, s, d) for x in (q, k, v, dout))
    dqf, dkf, dvf = (x.view(b * h, s, d) for x in grads)
    # whole heads per step while one head's logits fit, else row chunks
    rows = max(1, min(s, logit_bytes // (4 * max(s, 1))))
    heads = max(1, logit_bytes // (4 * max(s, 1) ** 2)) if rows == s else 1
    for g0 in range(0, b * h, heads):
        g1 = min(b * h, g0 + heads)
        kg, vg = kf[g0:g1].to(f32), vf[g0:g1].to(f32)
        dk = torch.zeros_like(kg)
        dv = torch.zeros_like(vg)
        for r0 in range(0, s, rows):
            r1 = min(s, r0 + rows)
            kend = r1 if causal else s
            qc, doc = qf[g0:g1, r0:r1].to(f32), dof[g0:g1, r0:r1].to(f32)
            logits = (qc @ kg[:, :kend].transpose(1, 2)) / scale
            if causal:
                qpos = torch.arange(r0, r1, device=q.device)[:, None]
                kpos = torch.arange(kend, device=q.device)[None, :]
                logits = logits.masked_fill(kpos > qpos, NEG_INF)
            p = torch.softmax(logits, dim=-1)
            del logits
            dv[:, :kend] += p.transpose(1, 2) @ doc
            dp = doc @ vg[:, :kend].transpose(1, 2)
            ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
            del p, dp
            dqf[g0:g1, r0:r1] = ((ds @ kg[:, :kend]) / scale).to(q.dtype)
            dk[:, :kend] += ds.transpose(1, 2) @ qc
        dkf[g0:g1] = (dk / scale).to(k.dtype)
        dvf[g0:g1] = dv.to(v.dtype)
    return tuple(grads)
