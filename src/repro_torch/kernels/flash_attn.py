"""Causal (or full) attention with an online softmax — wrapper and plain
version of the CUDA kernel `csrc/flash_attn.cu`.

Port of `repro.kernels.flash_attn` (`flash_attention`, `ref_attention`), with
the same contract: q, k, v `(B, H, S, D)` with equal heads, float32 or
bfloat16, `S` divisible by `bq` and `bk`; the output has the input's dtype.
Logits, softmax statistics and the accumulator are float32.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
`flash_attention_plain`, the plain PyTorch version of the same function,
which the tests and the chip smoke hold the kernel against. `bq` and `bk`
keep the reference's contract (`S` divisible by both) but only set the
TPU kernel's order of summation: the CUDA kernel tiles by its own 128
query and 128 key rows, masking a partial last tile, for head dims up to
128. It has no backward, as the reference has none.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

LAUNCHES = 0  # CUDA kernel launches in this process (bumped per launch)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
# dtype; q, k, v, o; bh, S, D; scale; causal; stream
_ARGTYPES = [_I] + [_P] * 4 + [_I] * 3 + [ctypes.c_float, _I, _P]


def _lib():
    """The built `csrc/flash_attn.cu` with its C entry's signature set."""
    lib = _build.load("flash_attn")
    lib.flash_attn_fwd.argtypes = _ARGTYPES
    lib.flash_attn_fwd.restype = ctypes.c_int
    return lib


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
    kernel, which raises for what it cannot run."""
    _check(q, k, v, bq, bk)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    return _flash_attention_cuda(q, k, v, causal=causal)


def _flash_attention_cuda(q, k, v, *, causal):
    global LAUNCHES
    b, h, s, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash-attention kernel runs on CUDA tensors, "
                         f"got {dev}")
    lib = _lib()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.flash_attn_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b * h, s, d, 1.0 / d ** 0.5, int(causal),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


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
