"""The RWKV6 and Mamba blocks (`repro_torch.models.rwkv`,
`repro_torch.models.mamba`) against the reference's (`repro.models.rwkv`,
`repro.models.mamba`), module by module, on the CPU.

The same inputs and weights, drawn with numpy from a seed, go through both
packages. Bounds, each element against the reference's value: f32 within
1e-5 · (1 + max|ref|) (the two frameworks sum in other orders), bf16
within 2^-7 · max|ref| (one bf16 rounding of the output's largest value),
as `test_torch_lm_models.test_layer_functions_match_reference`; a whole
bf16 Mamba block within 2^-5 · max|ref| (`chip_smoke.TOL_LM_BF16`, four
roundings): the reference's XLA computes the conv taps and the gates in
f32 inside its fusions and rounds once, the port rounds each op to bf16
as the card does, and a u one bf16 step apart reaches the output through
x_proj, dt, the scan and the gate. Each package then reads up to 2.25 ·
2^-7 of max|out| from the same block in f32, and they read 1.69 · 2^-7
from each other (S = 12). The
chunked forms are held at S = 12 (not a multiple of the chunk, 8: the
reference runs it as one chunk, the port as a full chunk and a ragged one,
ROADMAP.md §C (22)) and S = 16 (two full chunks), with a carried state and
token shift going in and coming out; and against a chain of the decode
steps, which write their state in place. The in-chunk scan is held bit
for bit to `jax.lax.associative_scan` (the same products in the same
order) and within 1e-6 to the sequential f64 recurrence. The twin of
`tests/test_consistency.py::test_chunk_size_invariance` holds whole smoke
models at chunk 4 and 5 (ragged) against chunk 16 within its 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import mamba as rmamba
from repro.models import rwkv as rrwkv
from repro.models import transformer as rtransformer
from repro.models.common import init_params as rinit
from repro_torch import configs
from repro_torch.models import convert, mamba, rwkv, transformer

SEQ_LENS = [12, 16]
DTYPES = ["float32", "bfloat16"]
CHUNK = 8
# offsets of the drawn leaves that the init rules keep away from 0
OFFSET = {"w0": -0.6, "dt_b": -4.6}


def _close(got, ref, dtype="float32", roundings=1):
    """f32: 1e-5 · (1 + max|ref|); bf16: `roundings` bf16 roundings of
    max|ref| (2^-7 each)."""
    ref = np.asarray(ref, np.float32)
    tol = (1e-5 * (1 + np.abs(ref).max()) if dtype == "float32"
           else roundings * 2 ** -7 * np.abs(ref).max())
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


def _draw(spec, seed):
    """Every leaf of a block's spec drawn N(0, 1) / sqrt(fan in) (1-d
    leaves N(0, 0.5)) plus OFFSET, in the leaf's dtype: (reference tree,
    port tree)."""
    rng = np.random.default_rng(seed)
    ref = {}
    for key, s in spec.items():
        a = rng.standard_normal(s.shape).astype(np.float32)
        a = (a / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else 0.5 * a)
        ref[key] = jnp.asarray(a + OFFSET.get(key, 0.0)).astype(s.dtype)
    return ref, {k: convert._to_torch(np.asarray(v)) for k, v in ref.items()}


def _both(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _rwkv_cfgs():
    return rconfigs.get_smoke("rwkv6-3b"), configs.get_smoke("rwkv6-3b")


def _mamba_cfgs():
    """jamba's smoke widths with the published conv window and state
    size (4, 16)."""
    kw = dict(mamba_conv=4, mamba_d_state=16)
    return (dataclasses.replace(rconfigs.get_smoke("jamba-v0.1-52b"), **kw),
            dataclasses.replace(configs.get_smoke("jamba-v0.1-52b"), **kw))


# ---------------------------------------------------------------------------
# RWKV6


@pytest.mark.parametrize("dtype", DTYPES)
def test_head_groupnorm_matches_reference(dtype):
    """The population variance (jnp.var's; torch.var's default is
    Bessel's), eps 64e-5, f32 out whatever comes in."""
    rcfg, cfg = _rwkv_cfgs()
    rng = np.random.default_rng(1)
    h, k = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    o_r, o_t = _both(rng, (2, 5, cfg.d_model), dtype, 3.0)
    rp, tp = _draw(rrwkv.time_mix_spec(rcfg), 2)
    got = rwkv._head_groupnorm(tp, o_t, h, k)
    assert got.dtype == torch.float32
    _close(got, rrwkv._head_groupnorm(rp, o_r, h, k))


@pytest.mark.parametrize("c", [5, CHUNK])
def test_chunk_wkv_matches_reference(c):
    rng = np.random.default_rng(c)
    b, h, k = 2, 3, 16
    r, kk, v = (rng.standard_normal((b, h, c, k)).astype(np.float32)
                for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, h, c, k)) - 0.6).astype(np.float32)
    u = (0.3 * rng.standard_normal((h, k))).astype(np.float32)
    state = rng.standard_normal((b, h, k, k)).astype(np.float32)
    args = (r, kk, v, logw, u, state)
    ro, rs = rrwkv._chunk_wkv(*map(jnp.asarray, args))
    go, gs = rwkv._chunk_wkv(*map(torch.from_numpy, args))
    _close(go, ro)
    _close(gs, rs)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", SEQ_LENS)
def test_time_mix_full_matches_reference(s, dtype):
    rcfg, cfg = _rwkv_cfgs()
    rng = np.random.default_rng(s)
    rp, tp = _draw(rrwkv.time_mix_spec(rcfg), 3)
    x_r, x_t = _both(rng, (2, s, cfg.d_model), dtype)
    xp_r, xp_t = _both(rng, (2, 1, cfg.d_model), dtype)
    st = rng.standard_normal((2, 2, cfg.rwkv_head_dim,
                              cfg.rwkv_head_dim)).astype(np.float32)
    ro, rs, rx = rrwkv.time_mix_full(rcfg, rp, x_r, chunk=CHUNK,
                                     state=jnp.asarray(st), x_prev=xp_r,
                                     return_state=True)
    go, gs, gx = rwkv.time_mix_full(cfg, tp, x_t, chunk=CHUNK,
                                    state=torch.from_numpy(st), x_prev=xp_t,
                                    return_state=True)
    assert go.dtype == x_t.dtype and gs.dtype == torch.float32
    _close(go, ro, dtype)
    _close(gs, rs, dtype)
    assert torch.equal(gx, x_t[:, -1:])
    # without a carried state or shift, and without returning them
    _close(rwkv.time_mix_full(cfg, tp, x_t, chunk=CHUNK),
           rrwkv.time_mix_full(rcfg, rp, x_r, chunk=CHUNK), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_time_mix_step_matches_reference_in_place(dtype):
    rcfg, cfg = _rwkv_cfgs()
    rng = np.random.default_rng(4)
    rp, tp = _draw(rrwkv.time_mix_spec(rcfg), 5)
    x_r, x_t = _both(rng, (2, 1, cfg.d_model), dtype)
    xp_r, xp_t = _both(rng, (2, 1, cfg.d_model), dtype)
    st = rng.standard_normal((2, 2, cfg.rwkv_head_dim,
                              cfg.rwkv_head_dim)).astype(np.float32)
    ro, rs, rx = rrwkv.time_mix_step(rcfg, rp, x_r, jnp.asarray(st), xp_r)
    state = torch.from_numpy(st.copy())
    go, gs, gx = rwkv.time_mix_step(cfg, tp, x_t, state, xp_t)
    assert gs is state and gx is xp_t
    _close(go, ro, dtype)
    _close(gs, rs, dtype)
    assert torch.equal(gx, x_t)


@pytest.mark.parametrize("s", SEQ_LENS)
def test_time_mix_full_equals_a_chain_of_steps(s):
    """The chunked form against s decode steps from the same state and
    shift: outputs, the final state and the shift."""
    rcfg, cfg = _rwkv_cfgs()
    rng = np.random.default_rng(6)
    _, tp = _draw(rrwkv.time_mix_spec(rcfg), 7)
    _, x = _both(rng, (2, s, cfg.d_model), "float32")
    _, xp = _both(rng, (2, 1, cfg.d_model), "float32")
    st = torch.from_numpy(rng.standard_normal(
        (2, 2, cfg.rwkv_head_dim, cfg.rwkv_head_dim)).astype(np.float32))
    full, fs, fx = rwkv.time_mix_full(cfg, tp, x, chunk=CHUNK, state=st,
                                      x_prev=xp, return_state=True)
    state, shift = st.clone(), xp.clone()
    outs = [rwkv.time_mix_step(cfg, tp, x[:, t:t + 1], state, shift)[0]
            for t in range(s)]
    _close(torch.cat(outs, dim=1), full.numpy())
    _close(state, fs.numpy())
    assert torch.equal(shift, fx)


@pytest.mark.parametrize("dtype", DTYPES)
def test_channel_mix_matches_reference(dtype):
    """channel_mix_full with and without a shift, channel_mix_step (in
    place), and a chain of steps against the full form."""
    rcfg, cfg = _rwkv_cfgs()
    rng = np.random.default_rng(8)
    rp, tp = _draw(rrwkv.channel_mix_spec(rcfg), 9)
    x_r, x_t = _both(rng, (2, 12, cfg.d_model), dtype)
    xp_r, xp_t = _both(rng, (2, 1, cfg.d_model), dtype)
    full = rwkv.channel_mix_full(cfg, tp, x_t, xp_t)
    _close(full, rrwkv.channel_mix_full(rcfg, rp, x_r, xp_r), dtype)
    _close(rwkv.channel_mix_full(cfg, tp, x_t),
           rrwkv.channel_mix_full(rcfg, rp, x_r), dtype)
    ro, rx = rrwkv.channel_mix_step(rcfg, rp, x_r[:, :1], xp_r)
    shift = xp_t.clone()
    go, gx = rwkv.channel_mix_step(cfg, tp, x_t[:, :1], shift)
    assert gx is shift and torch.equal(gx, x_t[:, :1])
    _close(go, ro, dtype)
    shift = xp_t.clone()
    steps = [rwkv.channel_mix_step(cfg, tp, x_t[:, t:t + 1], shift)[0]
             for t in range(12)]
    assert torch.equal(torch.cat(steps, dim=1), full)


# ---------------------------------------------------------------------------
# Mamba


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 16, 17, 256])
def test_linear_scan_is_the_reference_scan(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.2, 1.0, (2, n, 6, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 6, 4)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]

    _, ref = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    got = mamba._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    h, seq = np.zeros((2, 6, 4)), []
    for t in range(n):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(seq, 1), rtol=0,
                               atol=1e-6 * (1 + np.abs(seq).max()))


@pytest.mark.parametrize("c", [5, CHUNK])
def test_chunk_ssm_matches_reference(c):
    rng = np.random.default_rng(c + 20)
    b, di, n = 2, 12, 16
    dt = np.log1p(np.exp(rng.standard_normal((b, c, di)) - 1.0)).astype(
        np.float32)
    bmat, cmat = (rng.standard_normal((b, c, n)).astype(np.float32)
                  for _ in range(2))
    u = rng.standard_normal((b, c, di)).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal((di, n))).astype(np.float32)
    h0 = rng.standard_normal((b, di, n)).astype(np.float32)
    args = (dt, bmat, cmat, u, a, h0)
    ry, rh = rmamba._chunk_ssm(*map(jnp.asarray, args))
    gy, gh = mamba._chunk_ssm(*map(torch.from_numpy, args))
    _close(gy, ry)
    _close(gh, rh)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", SEQ_LENS)
def test_mamba_full_matches_reference(s, dtype):
    rcfg, cfg = _mamba_cfgs()
    rng = np.random.default_rng(s + 30)
    rp, tp = _draw(rmamba.mamba_spec(rcfg), 10)
    di = cfg.mamba_expand * cfg.d_model
    x_r, x_t = _both(rng, (2, s, cfg.d_model), dtype)
    cv_r, cv_t = _both(rng, (2, cfg.mamba_conv - 1, di), dtype)
    st = rng.standard_normal((2, di, cfg.mamba_d_state)).astype(np.float32)
    ro, rs, rc = rmamba.mamba_full(rcfg, rp, x_r, chunk=CHUNK,
                                   state=jnp.asarray(st), conv_state=cv_r,
                                   return_state=True)
    go, gs, gc = mamba.mamba_full(cfg, tp, x_t, chunk=CHUNK,
                                  state=torch.from_numpy(st),
                                  conv_state=cv_t, return_state=True)
    assert go.dtype == x_t.dtype and gs.dtype == torch.float32
    assert gc.shape == (2, cfg.mamba_conv - 1, di) and gc.is_contiguous()
    _close(go, ro, dtype, roundings=4)
    _close(gs, rs, dtype, roundings=4)
    _close(gc, rc, dtype)
    _close(mamba.mamba_full(cfg, tp, x_t, chunk=CHUNK),
           rmamba.mamba_full(rcfg, rp, x_r, chunk=CHUNK), dtype, roundings=4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_step_matches_reference_in_place(dtype):
    rcfg, cfg = _mamba_cfgs()
    rng = np.random.default_rng(40)
    rp, tp = _draw(rmamba.mamba_spec(rcfg), 11)
    di = cfg.mamba_expand * cfg.d_model
    x_r, x_t = _both(rng, (2, 1, cfg.d_model), dtype)
    cv_r, cv_t = _both(rng, (2, cfg.mamba_conv - 1, di), dtype)
    st = rng.standard_normal((2, di, cfg.mamba_d_state)).astype(np.float32)
    ro, rs, rc = rmamba.mamba_step(rcfg, rp, x_r, jnp.asarray(st), cv_r)
    state, conv = torch.from_numpy(st.copy()), cv_t.clone()
    go, gs, gc = mamba.mamba_step(cfg, tp, x_t, state, conv)
    assert gs is state and gc is conv
    _close(go, ro, dtype)
    _close(gs, rs, dtype)
    _close(gc, rc, dtype)


@pytest.mark.parametrize("s", SEQ_LENS)
def test_mamba_full_equals_a_chain_of_steps(s):
    rcfg, cfg = _mamba_cfgs()
    rng = np.random.default_rng(50)
    _, tp = _draw(rmamba.mamba_spec(rcfg), 12)
    di = cfg.mamba_expand * cfg.d_model
    _, x = _both(rng, (2, s, cfg.d_model), "float32")
    _, cv = _both(rng, (2, cfg.mamba_conv - 1, di), "float32")
    st = torch.from_numpy(rng.standard_normal(
        (2, di, cfg.mamba_d_state)).astype(np.float32))
    full, fs, fc = mamba.mamba_full(cfg, tp, x, chunk=CHUNK, state=st,
                                    conv_state=cv, return_state=True)
    state, conv = st.clone(), cv.clone()
    outs = [mamba.mamba_step(cfg, tp, x[:, t:t + 1], state, conv)[0]
            for t in range(s)]
    _close(torch.cat(outs, dim=1), full.numpy())
    _close(state, fs.numpy())
    _close(conv, fc.numpy())         # in_proj of 1 row vs of S rows


# ---------------------------------------------------------------------------
# chunking


@pytest.mark.parametrize("fn,name", [(rwkv, "_chunk_wkv"),
                                     (mamba, "_chunk_ssm")])
def test_a_ragged_sequence_runs_full_chunks_then_the_rest(monkeypatch, fn,
                                                          name):
    """S = 12 at chunk 8: one chunk of 8 and one of 4 (the reference runs
    one chunk of 12); S = 16: two of 8."""
    arch = "rwkv6-3b" if fn is rwkv else "jamba-v0.1-52b"
    cfg = dataclasses.replace(configs.get_smoke(arch), rwkv_chunk=CHUNK,
                              mamba_chunk=CHUNK)
    model = transformer.Transformer(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    seen, real = [], getattr(fn, name)

    def counted(*args):
        seen.append(args[0].shape[2 if fn is rwkv else 1])
        return real(*args)

    monkeypatch.setattr(fn, name, counted)
    layers = sum(cfg.layer_kind(i).mixer in ("rwkv", "mamba")
                 for i in range(cfg.n_layers))
    for s, want in ((12, [8, 4]), (16, [8, 8])):
        seen.clear()
        with torch.no_grad():
            transformer.forward(cfg, model, torch.zeros(2, s,
                                                        dtype=torch.int32),
                                mode="train")
        assert seen == want * layers


@pytest.mark.parametrize("small", [4, 5])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_chunk_size_invariance(arch, small):
    """The twin of the reference's test: whole smoke models (the
    reference's weights) at chunk `small` against chunk 16, within its
    2e-3, beside the reference's own at chunk 4 against 16; chunk 5 leaves
    a ragged last chunk of 1."""
    rcfg, cfg = rconfigs.get_smoke(arch), configs.get_smoke(arch)
    params = rinit(jax.random.key(5), rtransformer.model_spec(rcfg))
    model = transformer.Transformer(cfg, device="cpu")
    model.load_state_dict(convert.params_from_reference(
        jax.tree.map(np.asarray, params)))
    tok = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                            (2, 16)).astype(np.int32)

    def port(c):
        with torch.no_grad():
            return transformer.forward(
                dataclasses.replace(cfg, rwkv_chunk=c, mamba_chunk=c), model,
                torch.from_numpy(tok), mode="train")[0].numpy()

    def ref(c):
        return np.asarray(rtransformer.forward(
            dataclasses.replace(rcfg, rwkv_chunk=c, mamba_chunk=c), params,
            jnp.asarray(tok), mode="train", ctx=None)[0])

    np.testing.assert_allclose(port(small), port(16), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ref(4), ref(16), rtol=2e-3, atol=2e-3)
    lg = ref(16)
    np.testing.assert_allclose(port(small), lg, rtol=0,
                               atol=1e-4 * (1 + np.abs(lg).max()))
