"""The port's AdamW (`repro_torch.optim.adamw`) against the reference's
(`repro.optim.adamw`), on the CPU.

The twins of `tests/test_substrate.py`'s optimizer tests run on the port;
one `apply_updates` step on the same f32 params, grads and state (numpy
from a seed) agrees with the reference's within 1e-6 relative (of each
leaf's max |ref|), without and with int8 compression; the schedule agrees
at every step of a short run within 1e-6 relative; int8 quantization is
the reference's bit for bit. The port updates in place: the returned
params and state are the ones passed in.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import transformer as rtransformer
from repro.optim import adamw as radamw
from repro_torch import configs
from repro_torch.models import convert, transformer
from repro_torch.optim import adamw

REL = 1e-6


def _quad_problem():
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2
    return params, loss


def _grad(loss, params):
    ps = {k: v.detach().requires_grad_() for k, v in params.items()}
    gs = torch.autograd.grad(loss(ps), list(ps.values()))
    return dict(zip(ps, gs))


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_converges(compress):
    c = adamw.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=300,
                          weight_decay=0.0, compress=compress)
    params, loss = _quad_problem()
    state = (adamw.init_state_with_error_feedback(params) if compress
             else adamw.init_state(params))
    for _ in range(300):
        g = _grad(loss, params)
        params, state, met = adamw.apply_updates(c, params, g, state)
    assert float(loss(params)) < 1e-3, float(loss(params))
    assert float(met["lr"]) < c.lr


def test_grad_clip():
    c = adamw.AdamWConfig(clip_norm=1.0, warmup_steps=0, total_steps=10)
    params, _ = _quad_problem()
    before = {k: v.clone() for k, v in params.items()}
    state = adamw.init_state(params)
    g = {"w": torch.tensor([1e6, 1e6]), "b": torch.tensor(1e6)}
    p2, state, met = adamw.apply_updates(c, params, g, state)
    assert p2 is params
    assert float(met["grad_norm"]) > 1e5
    delta = max(float((p2[k] - before[k]).abs().max()) for k in ("w", "b"))
    assert delta < 0.01  # clipped step is bounded by ~lr


def test_compression_error_feedback_accumulates():
    """int8 quantization must not lose small persistent gradients."""
    c = adamw.AdamWConfig(lr=0.01, warmup_steps=0, total_steps=1000,
                          weight_decay=0.0, compress=True)
    params = {"w": torch.tensor([0.0, 100.0])}
    state = adamw.init_state_with_error_feedback(params)
    for _ in range(50):
        g = {"w": torch.tensor([1e-3, 1.0])}
        params, state, _ = adamw.apply_updates(c, params, g, state)
    assert float(params["w"][0]) < -1e-3  # moved despite quantization


SHAPES = {"w": (8, 6), "b": (6,), "nest": {"k": (3, 4, 5), "s": ()}}


def _tree(rng, shapes, fn):
    return {k: _tree(rng, v, fn) if isinstance(v, dict) else fn(rng, v)
            for k, v in shapes.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _close(got, ref, what):
    ref, got = dict(_leaves(ref)), dict(_leaves(got))
    assert list(got) == list(ref)
    for k in ref:
        r = np.asarray(ref[k], np.float64)
        g = np.asarray(got[k].numpy() if isinstance(got[k], torch.Tensor)
                       else got[k], np.float64)
        tol = REL * max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(g - r).max()) <= tol, (what, k)


@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_matches_reference(compress):
    rng = np.random.default_rng(4)
    normal = lambda r, s: r.standard_normal(s).astype(np.float32)
    params, grads = _tree(rng, SHAPES, normal), _tree(rng, SHAPES, normal)
    m = _tree(rng, SHAPES, lambda r, s: 0.1 * normal(r, s))
    v = _tree(rng, SHAPES, lambda r, s: r.random(s).astype(np.float32))
    err = _tree(rng, SHAPES, lambda r, s: 0.01 * normal(r, s))
    c = radamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20,
                           clip_norm=0.5, compress=compress)
    tc = adamw.AdamWConfig(**dataclasses.asdict(c))
    j = lambda t: jax.tree.map(jnp.asarray, t)
    t = lambda tr: jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tr)
    rstate = {"m": j(m), "v": j(v), "step": jnp.asarray(5, jnp.int32),
              "err": j(err) if compress else None}
    state = {"m": t(m), "v": t(v), "step": torch.tensor(5, dtype=torch.int32),
             "err": t(err) if compress else None}
    tparams = t(params)
    rp, rs, rmet = radamw.apply_updates(c, j(params), j(grads), rstate)
    gp, gs, gmet = adamw.apply_updates(tc, tparams, t(grads), state)
    assert gp is tparams and gs is state
    _close(gp, rp, "params")
    for key in ("m", "v") + (("err",) if compress else ()):
        _close(gs[key], rs[key], key)
    assert int(gs["step"]) == int(rs["step"]) == 6
    for key in ("grad_norm", "lr"):
        r = float(rmet[key])
        assert abs(float(gmet[key]) - r) <= REL * abs(r), key


def test_schedule_matches_reference_at_every_step():
    c = radamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=30,
                           min_lr_frac=0.1)
    tc = adamw.AdamWConfig(**dataclasses.asdict(c))
    for step in range(40):
        ref = float(radamw.schedule(c, jnp.asarray(step, jnp.int32)))
        got = adamw.schedule(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - ref) <= REL * abs(ref), step


def test_quantize_and_global_norm_match_reference():
    rng = np.random.default_rng(9)
    g = (rng.standard_normal(1000) * np.logspace(-4, 2, 1000)).astype(
        np.float32)
    rq, rs = radamw._quantize_int8(jnp.asarray(g))
    q, s = adamw._quantize_int8(torch.from_numpy(g))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    tree = {"a": g[:300].reshape(30, 10), "b": {"c": g[300:]}}
    ref = float(radamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(adamw.global_norm(jax.tree.map(torch.from_numpy, tree)))
    assert abs(got - ref) <= REL * ref


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-7b",
                                  "deepseek-v2-lite-16b", "jamba-v0.1-52b"])
def test_decay_follows_the_reference_layout(arch):
    """A leaf decays where its reference counterpart has rank >= 2: the
    stacked decoder layers' norm gains and biases do; those of a layer the
    reference keeps unstacked (deepseek's dense first layer) and the final
    norm do not."""
    cfg = configs.get_smoke(arch)
    rspec = rtransformer.model_spec(rconfigs.get_smoke(arch))
    prefix, period, n = cfg.layer_groups()
    ref_rank, port = {}, {}     # port path -> reference rank, port leaf

    def put(path, shape, stacked):
        ref_rank[path] = len(shape)
        port[path] = torch.empty(shape[1:] if stacked else shape)
    for path, s in _leaves({k: v for k, v in rspec.items()
                            if k not in ("prefix", "period")}):
        put(path, s.shape, False)
    for i, sub in rspec.get("prefix", {}).items():
        for path, s in _leaves(sub, f"layers.{i}."):
            put(path, s.shape, False)
    for j, sub in rspec.get("period", {}).items():
        for p in range(n):
            i = len(prefix) + p * len(period) + int(j)
            for path, s in _leaves(sub, f"layers.{i}."):
                put(path, s.shape, True)
    want = {k for k, r in ref_rank.items() if r >= 2}
    assert convert.decayed_paths(port, cfg) == want
    assert any(p.dim() < 2 for p in port.values())
    if arch in ("llama3-8b", "qwen2-7b"):      # families the port builds
        model = transformer.Transformer(cfg, device="cpu")
        assert ({k: p.shape for k, p in model.named_parameters()}
                == {k: t.shape for k, t in port.items()})
        assert convert.decayed_paths(model, cfg) == want
