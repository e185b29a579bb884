"""The port's MoE FFN and multi-head latent attention
(`repro_torch.models.moe`, `repro_torch.models.attention`) against the
reference's (`repro.models.moe._moe_local` without a context,
`repro.models.attention.mla_full` / `mla_decode`), on the CPU.

Inputs come from a numpy seed; the reference's weights (`init_params` of
its own specs) are carried across with `models.convert._to_torch`. The
smoke configs compute in f32 over bf16 weights. Tolerances: outputs within
1e-5 · (1 + max|ref|) (the two frameworks sum in other orders, ~1e-7
observed), the aux loss within 1e-6, dispatch slots and kept masks equal.
The router logits of every case are checked tie-free at the top-k
boundary (`lax.top_k` keeps the lower index at a tie, `torch.topk`
promises no order), so a routing difference is a fault, not a tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattention
from repro.models import moe as rmoe
from repro.models.common import init_params as rinit
from repro_torch import configs
from repro_torch.models import attention, convert, moe
from repro_torch.models.common import tree_map

MOE_ARCHS = ["olmoe-1b-7b", "deepseek-v2-lite-16b"]
MLA_ARCHS = ["deepseek-v2-lite-16b", "minicpm3-4b"]
TIE_GAP = 1e-5      # the frameworks' router logits differ by ~1e-7


def _tol(ref):
    return 1e-5 * (1.0 + float(np.abs(np.asarray(ref)).max()))


def _weights(spec, seed):
    """(the reference's tree, the same weights as torch tensors)."""
    ref = rinit(jax.random.key(seed), spec)
    return ref, tree_map(convert._to_torch, jax.tree.map(np.asarray, ref))


def _x(shape, seed, skew=0.0):
    """Normal activations; `skew` adds one shared direction to every token,
    so the router favours the same experts and capacity drops entries."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if skew:
        x += skew * rng.standard_normal(shape[-1]).astype(np.float32)
    return x


def _ref_dispatch(rcfg, rp, x):
    """The reference's routing of x, from its own pieces (`_moe_local`'s
    first lines): (logits, flat expert ids, slot, keep)."""
    n = x.shape[0] * x.shape[1]
    xt = jnp.asarray(x).reshape(n, -1)
    logits = (xt.astype(jnp.float32) @ rp["router"]).astype(jnp.float32)
    _, eids = jax.lax.top_k(logits, rcfg.top_k)
    flat_e = eids.reshape(-1).astype(jnp.int32)
    cap = (n if n <= 1024 else
           int(rcfg.moe_capacity_factor * n * rcfg.top_k / rcfg.n_experts)
           + 1)
    slot, keep = rmoe._dispatch_indices(flat_e, cap)
    return (np.asarray(logits), np.asarray(flat_e), np.asarray(slot),
            np.asarray(keep))


def _top_k_gap(logits, k):
    """The smallest gap between the k-th and (k+1)-th logit of a token."""
    s = np.sort(logits, axis=-1)[:, ::-1]
    return float((s[:, k - 1] - s[:, k]).min())


# ---------------------------------------------------------------------------
# dispatch


@pytest.mark.parametrize("case", ["random", "one_expert", "boundary"])
def test_dispatch_indices_match_reference(case):
    rng = np.random.default_rng(3)
    n, e = 1000, 8
    ids = {"random": rng.integers(0, e, n),
           "one_expert": np.full(n, 5),
           "boundary": np.repeat(np.arange(e), n // e)}[case].astype(np.int32)
    counts = np.bincount(ids, minlength=e)
    for cap in sorted({1, 10, int(counts.max()) - 1, int(counts.max()),
                       int(counts.max()) + 1, n}):
        rslot, rkeep = rmoe._dispatch_indices(jnp.asarray(ids), cap)
        slot, keep = moe._dispatch_indices(torch.from_numpy(ids), cap)
        assert slot.dtype == torch.int32 and keep.dtype == torch.bool
        np.testing.assert_array_equal(slot.numpy(), np.asarray(rslot))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))
        assert int(keep.sum()) == int(np.minimum(counts, cap).sum())


def test_capacity_rule_matches_reference():
    cfg = configs.get_config("olmoe-1b-7b")
    assert [moe._capacity(cfg, n) for n in (1, 128, 1024)] == [1, 128, 1024]
    for n in (1025, 4096, 6 * 32768):
        assert moe._capacity(cfg, n) == int(1.25 * n * 8 / 64) + 1
    assert moe._capacity(cfg, 1025) == 161


# ---------------------------------------------------------------------------
# the MoE FFN


@pytest.mark.parametrize("bs,skew", [((2, 12), 0.0), ((1, 1024), 0.7),
                                     ((1, 1025), 0.7), ((2, 1024), 0.7),
                                     ((4, 600), 0.0)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_reference(arch, bs, skew):
    """Dropless (n <= 1024) and capacity (n > 1024) regimes: output, aux,
    slots and kept masks; the skewed capacity cases drop entries."""
    rcfg, cfg = rconfigs.get_smoke(arch), configs.get_smoke(arch)
    rp, p = _weights(rmoe.moe_spec(rcfg), seed=11)
    x = _x((*bs, cfg.d_model), seed=bs[1], skew=skew)
    n = bs[0] * bs[1]
    rlogits, rflat, rslot, rkeep = _ref_dispatch(rcfg, rp, x)
    assert _top_k_gap(rlogits, cfg.top_k) > TIE_GAP
    ref, raux = rmoe._moe_local(rcfg, rp, jnp.asarray(x), None)
    with torch.no_grad():
        got, aux = moe.moe_ffn(cfg, p, torch.from_numpy(x))
        _, _, flat_e, slot, keep, cap = moe._route(
            cfg, p, torch.from_numpy(x).reshape(n, -1))
    assert cap == (n if n <= 1024 else moe._capacity(cfg, n))
    np.testing.assert_array_equal(flat_e.numpy(), rflat)
    np.testing.assert_array_equal(slot.numpy(), rslot)
    np.testing.assert_array_equal(keep.numpy(), rkeep)
    if n > 1024 and skew:
        assert 0 < int((~keep).sum()) < keep.numel() // 2, "no drops"
    if n <= 1024:
        assert bool(keep.all())
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_tol(ref))
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(raux)) <= 1e-6


def test_moe_ffn_tokens_with_every_entry_dropped_get_the_shared_experts():
    cfg = configs.get_smoke("deepseek-v2-lite-16b")
    _, p = _weights(rmoe.moe_spec(rconfigs.get_smoke(
        "deepseek-v2-lite-16b")), seed=5)
    x = torch.from_numpy(_x((1, 2048, cfg.d_model), seed=4, skew=3.0))
    with torch.no_grad():
        out, _ = moe.moe_ffn(cfg, p, x)
        _, _, _, _, keep, _ = moe._route(cfg, p, x[0])
        shared = moe.swiglu(p["shared"], x[0])
    gone = ~keep.reshape(-1, cfg.top_k).any(dim=1)
    assert int(gone.sum()) > 0
    assert torch.equal(out[0, gone], shared[gone])


# ---------------------------------------------------------------------------
# multi-head latent attention


def _mla(arch, seed=13):
    rcfg, cfg = rconfigs.get_smoke(arch), configs.get_smoke(arch)
    rp, p = _weights(rattention.mla_spec(rcfg), seed)
    return rcfg, rp, cfg, p


@pytest.mark.parametrize("s,causal", [(6, True), (8, True), (12, True),
                                      (16, True), (24, True), (12, False)])
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_full_matches_reference(arch, s, causal):
    """S <= q_chunk (one block), S % q_chunk != 0 (the reference's
    unchunked branch, the port's ragged last chunk), S a multiple of
    q_chunk (both chunked); the latent cache too."""
    rcfg, rp, cfg, p = _mla(arch)
    assert cfg.q_chunk == 8
    x = _x((2, s, cfg.d_model), seed=s)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    ref, rcache = rattention.mla_full(rcfg, rp, jnp.asarray(x),
                                      jnp.asarray(pos), causal=causal,
                                      q_chunk=rcfg.q_chunk,
                                      return_cache=True)
    with torch.no_grad():
        got, cache = attention.mla_full(cfg, p, torch.from_numpy(x),
                                        torch.from_numpy(pos), causal=causal,
                                        return_cache=True)
        plain = attention.mla_full(cfg, p, torch.from_numpy(x),
                                   torch.from_numpy(pos), causal=causal)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_tol(ref))
    assert torch.equal(plain, got)
    assert sorted(cache) == sorted(rcache) == ["ckv", "kr"]
    for key, shape in (("ckv", (2, s, cfg.kv_lora_rank)),
                       ("kr", (2, s, cfg.qk_rope_dim))):
        r = np.asarray(rcache[key])
        assert cache[key].shape == r.shape == shape
        np.testing.assert_allclose(cache[key].numpy(), r, rtol=0,
                                   atol=_tol(r))


@pytest.mark.parametrize("cache_len", [3, 9, 17])
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_decode_matches_reference(arch, cache_len):
    """One step on a seeded latent cache of 12 slots (cache_len 17 wraps
    to slot 5 with every slot valid); the slot is written in place."""
    rcfg, rp, cfg, p = _mla(arch)
    s, b = 12, 2
    rng = np.random.default_rng(cache_len)
    cache = {"ckv": rng.standard_normal((b, s, cfg.kv_lora_rank)),
             "kr": rng.standard_normal((b, s, cfg.qk_rope_dim))}
    cache = {k: (0.5 * v).astype(np.float32) for k, v in cache.items()}
    x = _x((b, 1, cfg.d_model), seed=cache_len + 1)
    pos = np.full((b, 1), cache_len, np.int32)
    ref, rnew = rattention.mla_decode(
        rcfg, rp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                   cache.items()},
        jnp.int32(cache_len), jnp.asarray(pos))
    port_cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with torch.no_grad():
        got, new = attention.mla_decode(cfg, p, torch.from_numpy(x),
                                        port_cache, cache_len,
                                        torch.from_numpy(pos))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_tol(ref))
    slot = cache_len % s
    for key in ("ckv", "kr"):
        assert new[key] is port_cache[key]          # in place
        r = np.asarray(rnew[key])
        np.testing.assert_allclose(new[key].numpy(), r, rtol=0, atol=_tol(r))
        assert np.array_equal(np.delete(new[key].numpy(), slot, axis=1),
                              np.delete(cache[key], slot, axis=1))


def test_mla_causal_chunks_skip_only_masked_keys():
    """A causal chunk reads the keys up to its last row: the same values
    as attending every key under the position mask (smoke deepseek, one
    chunk of 8 against the whole of 24)."""
    _, _, cfg, p = _mla("deepseek-v2-lite-16b")
    x = torch.from_numpy(_x((1, 24, cfg.d_model), seed=2))
    pos = torch.arange(24, dtype=torch.int32)[None]
    wide = dataclasses.replace(cfg, q_chunk=24)
    with torch.no_grad():
        chunked = attention.mla_full(cfg, p, x, pos)
        whole = attention.mla_full(wide, p, x, pos)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
