"""The port's flash attention (`repro_torch.kernels.flash_attn`) against the
reference's (`repro.kernels.flash_attn`): the Pallas kernel in interpret
mode and its oracle `ref_attention`, on the same numpy-seeded inputs.

Tolerances are the reference's own (`tests/test_flash_and_streaming.py`):
2e-4 in f32, 3e-2 in bf16 with the dtype kept, 1e-5 across block sizes. On
the CPU the wrapper runs the plain version; the `gpu`-marked tests in
`test_torch_guards.py` hold the CUDA kernel against it on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as ref_flash
from repro.kernels.flash_attn import ref_attention
from repro_torch.kernels import _build, flash_attn

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
