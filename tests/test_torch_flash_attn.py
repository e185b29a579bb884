"""The port's flash attention (`repro_torch.kernels.flash_attn`) against the
reference's (`repro.kernels.flash_attn`): the Pallas kernel in interpret
mode and its oracle `ref_attention`, on the same numpy-seeded inputs.

Tolerances are the reference's own (`tests/test_flash_and_streaming.py`):
2e-4 in f32, 3e-2 in bf16 with the dtype kept, 1e-5 across block sizes. On
the CPU the wrapper runs the plain version; the `gpu`-marked tests in
`test_torch_guards.py` hold the CUDA kernels against it on the card. The
tensor-core kernel's arithmetic (bf16 products, P split into two bf16
terms for the PV product) is emulated here in plain PyTorch and held to
the same full-size element check as the kernel on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as ref_flash
from repro.kernels.flash_attn import ref_attention
from repro_torch.kernels import _build, flash_attn
from repro_torch.utils import trace

SHAPES = [
    (2, 2, 128, 32, 64, 64, True),
    (1, 4, 256, 16, 128, 64, True),
    (2, 1, 128, 64, 32, 128, True),
    (1, 2, 128, 32, 64, 64, False),
    (1, 1, 64, 8, 64, 64, True),      # single block
]
# block shapes off the CUDA kernel's 128 x 128 tile: S not a multiple of 128
# (a masked partial tile on the card), bq/bk the TPU kernel never had
ODD_TILES = [
    (1, 2, 96, 40, 32, 48, True),
    (1, 1, 96, 24, 16, 96, False),
    (2, 1, 80, 128, 16, 40, True),
]


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32).astype(dtype)
            for _ in range(3)]


def _torch(xs, dtype=torch.float32, device="cpu"):
    return [torch.from_numpy(x).to(device=device, dtype=dtype) for x in xs]


def _emulate_wgmma(q, k, v, *, split_p, causal=True, bk=128):
    """The tensor-core kernel's arithmetic for one head, in plain PyTorch:
    bf16 q, k, v; f32 logits, m, l and accumulator; an online softmax over
    `bk`-key tiles; P enters the PV product as bf16, either split into
    P_hi = bf16(P) and P_lo = bf16(P - P_hi), both products summed in f32
    (`split_p`), or rounded once. l is summed from the f32 P. The output is
    rounded to bf16 at the end."""
    s, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((s, 1), flash_attn.NEG_INF)
    l = torch.zeros(s, 1)
    acc = torch.zeros(s, d)
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, bk):
        k1 = min(s, k0 + bk)
        logits = (qf @ kf[k0:k1].T) / d ** 0.5
        if causal:
            logits = logits.masked_fill(torch.arange(k0, k1)[None] > rows,
                                        flash_attn.NEG_INF)
        m_new = torch.maximum(m, logits.max(dim=1, keepdim=True).values)
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vf[k0:k1]
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ vf[k0:k1]
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


@pytest.mark.parametrize("oracle", ["kernel", "ref_attention"])
@pytest.mark.parametrize("b,h,s,d,bq,bk,causal", SHAPES + ODD_TILES)
def test_flash_matches_reference(b, h, s, d, bq, bk, causal, oracle):
    q, k, v = _qkv((b, h, s, d), seed=b * 100 + s)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref = (ref_flash(jq, jk, jv, bq=bq, bk=bk, causal=causal)
           if oracle == "kernel" else ref_attention(jq, jk, jv, causal=causal))
    out = flash_attn.flash_attention(*_torch((q, k, v)), bq=bq, bk=bk,
                                     causal=causal)
    assert out.dtype == torch.float32 and out.shape == (b, h, s, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_flash_bf16_matches_reference():
    q, k, v = _qkv((1, 2, 128, 32), seed=0)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    ref = ref_flash(jq, jk, jv, bq=64, bk=64)
    out = flash_attn.flash_attention(*_torch((q, k, v), torch.bfloat16),
                                     bq=64, bk=64)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=3e-2,
                               atol=3e-2)


def test_flash_block_size_invariance():
    q, k, v = _torch(_qkv((1, 2, 128, 16), seed=7))
    a = flash_attn.flash_attention(q, k, v, bq=32, bk=32)
    b = flash_attn.flash_attention(q, k, v, bq=128, bk=64)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_chunking_is_exact(causal):
    """Chunks of query rows (and, under the causal mask, the keys cut at the
    chunk's last row) change nothing but the summation order."""
    q, k, v = _torch(_qkv((1, 2, 96, 16), seed=3))
    whole = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    chunked = flash_attn.flash_attention_plain(q, k, v, causal=causal,
                                               logit_bytes=4 * 96 * 7)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)


# -- the tensor-core kernel's arithmetic -----------------------------------------

SPLIT_SEEDS = [6, 11]


@pytest.mark.parametrize("seed", SPLIT_SEEDS)
def test_split_p_emulation_meets_the_element_check(seed):
    """P split into bf16 hi + lo keeps every output element within one bf16
    rounding of the plain version (element ratio <= 1), and within the
    reference's bf16 tolerance of its oracle, at S=2048, D=128, causal."""
    q, k, v = _qkv((1, 1, 2048, 128), seed=seed)
    tq, tk, tv = _torch((q, k, v), torch.bfloat16)
    plain = flash_attn.flash_attention_plain(tq, tk, tv)
    emu = _emulate_wgmma(tq[0, 0], tk[0, 0], tv[0, 0], split_p=True)
    assert flash_attn.element_ratio(emu, plain[0, 0]) <= 1.0
    ref = ref_attention(*(jnp.asarray(x).astype(jnp.bfloat16)
                          for x in (q, k, v)))
    ref = torch.from_numpy(np.asarray(ref[0, 0], np.float32))
    assert flash_attn.element_ratio(emu, ref) <= 1.0
    np.testing.assert_allclose(emu.float().numpy(),
                               ref.numpy(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("seed", SPLIT_SEEDS)
def test_bf16_p_emulation_fails_the_element_check(seed):
    """The reason for the split: P rounded once to bf16 moves outputs by
    more than one bf16 rounding of the plain version's."""
    tq, tk, tv = _torch(_qkv((1, 1, 2048, 128), seed=seed), torch.bfloat16)
    plain = flash_attn.flash_attention_plain(tq, tk, tv)
    emu = _emulate_wgmma(tq[0, 0], tk[0, 0], tv[0, 0], split_p=False)
    assert flash_attn.element_ratio(emu, plain[0, 0]) > 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_split_p_emulation_with_a_partial_tile(causal):
    """S not a multiple of the 128-key tile: the emulation's partial last
    tile agrees with the plain version as the whole tiles do."""
    tq, tk, tv = _torch(_qkv((1, 1, 300, 72), seed=5), torch.bfloat16)
    plain = flash_attn.flash_attention_plain(tq, tk, tv, causal=causal)
    emu = _emulate_wgmma(tq[0, 0], tk[0, 0], tv[0, 0], split_p=True,
                         causal=causal)
    assert flash_attn.element_ratio(emu, plain[0, 0]) <= 1.0


def test_element_ratio_is_one_bf16_rounding():
    """A bf16 rounding of the plain values reads <= 1; an error of 2^-6 of
    each value reads > 1."""
    plain = torch.from_numpy(np.random.default_rng(2).standard_normal(4096)
                             .astype(np.float32))
    assert flash_attn.element_ratio(plain.bfloat16(), plain) <= 1.0
    assert flash_attn.element_ratio(plain * (1 + 2.0 ** -6), plain) > 1.0


def test_launches_is_the_sum_over_routes(monkeypatch):
    monkeypatch.setattr(trace, "_COUNTS", {})
    trace.count("flash_attn.wgmma", 3)
    trace.count("flash_attn.fma", 2)
    assert flash_attn.LAUNCHES_BY_ROUTE == {"wgmma": 3, "fma": 2}
    assert flash_attn.LAUNCHES == 5


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 40, "wgmma"),
    (torch.bfloat16, 12, "fma"), (torch.bfloat16, 127, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 16, "fma"),
])
def test_route_by_dtype_and_head_dim(dtype, d, route):
    assert flash_attn._route(dtype, d) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_raises_above_128(dtype):
    with pytest.raises(ValueError, match="head dims up to 128"):
        flash_attn._route(dtype, 136)


# -- guards -------------------------------------------------------------------


@pytest.mark.parametrize("bq,bk", [(48, 64), (64, 48), (0, 64)])
def test_indivisible_sequence_raises(bq, bk):
    q, k, v = _torch(_qkv((1, 1, 128, 8), seed=1))
    with pytest.raises(ValueError, match="divisible"):
        flash_attn.flash_attention(q, k, v, bq=bq, bk=bk)


def test_unequal_shapes_dtypes_and_layouts_raise():
    q, k, v = _torch(_qkv((1, 2, 64, 8), seed=2))
    with pytest.raises(ValueError, match="equal shapes"):
        flash_attn.flash_attention(q, k[:, :1], v[:, :1], bq=32, bk=32)
    with pytest.raises(ValueError, match="tensor"):
        flash_attn.flash_attention(q[0], k[0], v[0], bq=32, bk=32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attn.flash_attention(q.half(), k.half(), v.half(), bq=32,
                                   bk=32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attn.flash_attention(q, k.bfloat16(), v, bq=32, bk=32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attn.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), bq=1, bk=1)
    with pytest.raises(ValueError, match="lie on"):
        flash_attn.flash_attention(q, k.to("meta"), v, bq=32, bk=32)


def test_device_tensors_never_reach_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU launches the CUDA kernel or raises;
    the plain version is never the fallback."""
    def plain_called(*a, **k):
        raise AssertionError("plain version reached for a device tensor")

    monkeypatch.setattr(flash_attn, "flash_attention_plain", plain_called)
    z = torch.zeros(1, 2, 64, 16, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        flash_attn.flash_attention(z, z, z, bq=32, bk=32)
    # any bq/bk dividing S reaches the kernel, which tiles its own way
    y = torch.zeros(1, 2, 96, 16, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        flash_attn.flash_attention(y, y, y, bq=16, bk=48)
    # a head dim the kernel is not built for raises before any build
    w = torch.zeros(1, 1, 64, 160, device="meta")
    with pytest.raises(ValueError, match="head dims up to 128"):
        flash_attn.flash_attention(w, w, w, bq=32, bk=32)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        flash_attn._lib()


def test_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attn._flash_attention_cuda(*_torch(_qkv((1, 1, 64, 8), 4)),
                                         causal=True)


def test_build_target_is_its_own_library():
    t = _build._target("flash_attn")
    assert t.name.startswith("libflash_attn_") and t.parent == _build.BUILD_DIR
    assert t != _build._target("natsa_mp")
