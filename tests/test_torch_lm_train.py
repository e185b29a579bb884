"""The port's LM training path (ROADMAP.md §A9 (ii)) against the
reference's, on the CPU: flash attention's backward, the train step, remat
and the trainer with its checkpoints.

Tolerances, each element against its reference value:
- `flash_attention_backward_plain` (f32): within 1e-5 · (1 + max|ref|) of
  `jax.grad` through the reference's `ref_attention` and of autograd
  through `flash_attention_plain`.
- One `make_train_step` on each smoke config (dense GQA, MoE, MLA, MLA +
  MoE with deepseek's unstacked dense first layer, whose 1-d leaves AdamW
  does not decay, RWKV6, jamba, whisper with its frames and its encoder
  stacked under `enc.blk` in the reference, qwen2-vl over (3, B, T)
  positions split on their batch axis), at `microbatches` 1 and 2, against `jax.jit` of the reference's, from the same weights
  (carried by `models.convert`) and batch. With the weights in f32, loss,
  grad norm, new params, m and v are within 1e-5 · (1 + max|ref|). With
  the weights in bf16, as the configs ship them, both packages keep each
  gradient leaf in its parameter's dtype (bf16; each microbatch's
  gradient is rounded before the f32 sum), and the two frameworks' sums
  fall on either side of a bf16 rounding boundary now and then: the grad
  norm may then also differ by one bf16 rounding of itself (2^-7 of it),
  each element of m by one bf16 rounding of its leaf's largest value
  (2^-7 max|ref|; twice that for v, quadratic in the gradient), since a
  microbatch's gradient can round at a larger magnitude than the mean
  keeps. Loss and new params keep 1e-5 · (1 + max|ref|). One leaf is
  apart in the new params: the K projection's bias (qwen's `qkv_bias`)
  has a gradient of exactly 0 (the softmax is invariant to a shift shared
  by all keys), so both packages feed AdamW rounding noise there and
  `g / (|g| + eps)` is any value in (-1, 1): its new value is held within
  2 lr of the reference's. On the MoE and MLA configs, an element whose
  (clipped) gradient the reference puts within 100 eps of 0, but not at
  0, moves by lr · g / (|g| + eps), which is not yet ±lr and follows the
  gradient's rounding noise (one minicpm3 embedding element, g ~ 3e-8,
  moved 8% of lr apart in f32): its new value is held within 1e-5 · (1 +
  max|ref|) of AdamW's step recomputed from the port's own m and v, op
  for op, while m holds its gradient to the reference's as every other
  element's. An element whose reference gradient is exactly 0 keeps the
  bound of the rest. With bf16 weights and 2 microbatches on those
  configs and the rest past the dense GQA ones, an element whose two
  microbatch gradients cancel gets the same treatment: its first moment
  differs in sign (or in being 0) between the packages, within the m
  bound, and the reference's mean gradient |m| / (1 - beta1) is within
  one bf16 rounding (2^-8) of the sum of the port's two microbatch
  gradients |g_1| + |g_2| at that element. It exempts one element of
  qwen2-vl's case, emb[96, 23]: microbatch gradients -0.1089 and
  +0.1089 that sum to exactly 0 in the port and to 1.8e-5 in the
  reference (8.4e-5 of their sum); and one of deepseek's, which the
  100 eps rule already holds; none in any other case. The dense GQA
  configs take neither rule.
- remat on against off (with the MoE aux carried out of each
  checkpointed layer), and the trainer's runs against each other: bit
  for bit.
- A checkpoint resumed across packages: final losses within 1e-4.

The flash kernel cannot run here; a `gpu`-marked test in
`test_torch_guards.py` and `chip_smoke.py` hold the Function's CUDA route
on the card.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.checkpoint import ckpt as rckpt
from repro.data import pipeline as rpipe
from repro.kernels.flash_attn import ref_attention
from repro.launch import train as rtrain
from repro.models import steps as rsteps
from repro.models import transformer as rtransformer
from repro.models.common import init_params as rinit
from repro.optim import adamw as radamw
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.kernels import flash_attn
from repro_torch.launch import train
from repro_torch.models import convert, steps, transformer
from repro_torch.optim import adamw

GQA = ["llama3-8b", "qwen2-7b", "qwen2.5-32b"]
DENSE = GQA + ["olmoe-1b-7b", "deepseek-v2-lite-16b", "minicpm3-4b",
               "rwkv6-3b", "jamba-v0.1-52b", "whisper-large-v3",
               "qwen2-vl-2b"]
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _tol(ref):
    return 1e-5 * (1.0 + float(np.abs(np.asarray(ref, np.float64)).max()))


# ---------------------------------------------------------------------------
# flash attention's backward


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,logit_bytes", [
    ((2, 3, 64, 16), flash_attn.PLAIN_LOGIT_BYTES),   # all heads at once
    ((1, 2, 96, 8), 4 * 96 * 96),                     # one head a step
    ((1, 2, 80, 32), 4 * 80 * 24),                    # row chunks of 24
])
def test_backward_plain_matches_reference_grad(shape, logit_bytes, causal):
    q, k, v, do = _qkv(shape, 11)
    _, vjp = jax.vjp(lambda a, b, c: ref_attention(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tdo = torch.from_numpy(do)
    plain = torch.autograd.grad(
        flash_attn.flash_attention_plain(tq, tk, tv, causal=causal),
        (tq, tk, tv), tdo)
    got = flash_attn.flash_attention_backward_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), tdo, causal,
        logit_bytes=logit_bytes)
    for name, g, r, p in zip("qkv", got, ref, plain):
        assert g.dtype == torch.float32 and g.shape == shape
        assert float((g - torch.from_numpy(r.copy())).abs().max()) <= _tol(r), name
        assert float((g - p).abs().max()) <= _tol(p.numpy()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_is_differentiable_through_its_function(dtype):
    """On a tensor that requires grad the output carries the Function's
    node, and its gradients are the plain backward's, bit for bit, in the
    input dtype."""
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _qkv((1, 2, 32, 16), 3))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attn.flash_attention(*leaves, bq=32, bk=32)
    assert type(out.grad_fn).__name__ == "_FlashFunctionBackward"
    got = torch.autograd.grad(out, leaves, do)
    want = flash_attn.flash_attention_backward_plain(q, k, v, do, True)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)
    assert flash_attn.flash_attention(q, k, v, bq=32, bk=32).grad_fn is None


# ---------------------------------------------------------------------------
# the train step against the reference's


def _models(arch, weights, seed=7):
    rcfg, cfg = rconfigs.get_smoke(arch), configs.get_smoke(arch)
    params = rinit(jax.random.key(seed), rtransformer.model_spec(rcfg))
    model = transformer.Transformer(cfg, device="cpu")
    if weights == "f32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        model = model.float()
    model.load_state_dict(convert.params_from_reference(
        jax.tree.map(np.asarray, params)))
    return rcfg, params, cfg, model


def _batch(cfg, b=4, t=16, seed=1):
    """Tokens and labels; whisper's frames; M-RoPE positions whose t and h
    streams differ from w (and from row to row, so a wrong microbatch
    split would show)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        out["frames"] = (rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.mrope_sections:
        w = np.arange(t)
        row = np.arange(b)[:, None]
        out["positions"] = np.stack([np.broadcast_to(w // 6 + row, (b, t)),
                                     (w // 2 + row) % 3,
                                     np.broadcast_to(w, (b, t))]).astype(
                                         np.int32)
    return out


def _ref_leaves(tree):
    """The reference's tree -> {port path: float64 numpy}."""
    return {k: v.double().numpy() for k, v in convert.params_from_reference(
        jax.tree.map(np.asarray, tree)).items()}


def _first_step(c, p, m, v, lr, decayed):
    """`p` after AdamW's first step with moments `m` and `v`, op for op as
    `adamw.apply_updates` forms it, as float64 numpy."""
    step = torch.tensor(1.0)
    b1c, b2c = 1 - c.beta1 ** step, 1 - c.beta2 ** step
    delta = (m / b1c) / ((v / b2c).sqrt() + c.eps)
    p32 = p.float()
    if decayed:
        delta = delta + p32 * c.weight_decay
    return (p32 - delta * lr).to(p.dtype).double().numpy()


def _abs_grad_sum(cfg, model, batch, mb):
    """{path: sum over the `mb` microbatches of |g_i|}, each g_i the
    port's gradient of one microbatch's loss (split as the train step
    splits: M-RoPE positions on their batch axis), as float64 numpy."""
    loss_fn = steps.make_loss_fn(cfg)
    names, tensors = zip(*adamw.leaves(model).items())
    out = {n: 0.0 for n in names}
    for i in range(mb):
        one = {k: torch.from_numpy(np.ascontiguousarray(np.split(
            v, mb, axis=1 if k == "positions" and cfg.mrope_sections
            else 0)[i])) for k, v in batch.items()}
        with torch.enable_grad():
            loss, _ = loss_fn(model, one)
            g = torch.autograd.grad(loss, tensors, allow_unused=True,
                                    materialize_grads=True)
        for n, x in zip(names, g):
            out[n] = out[n] + np.abs(x.double().numpy())
    return out


@pytest.mark.parametrize("weights", ["f32", "bf16"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", DENSE)
def test_train_step_matches_reference(arch, microbatches, weights):
    rcfg, params, cfg, model = _models(arch, weights)
    batch = _batch(cfg)
    ropt = radamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    opt = adamw.AdamWConfig(**dataclasses.asdict(ropt))
    rparams, rstate, rmet = jax.jit(rsteps.make_train_step(
        rcfg, None, ropt, microbatches=microbatches))(
        params, radamw.init_state(params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    gsum = (_abs_grad_sum(cfg, model, batch, microbatches)
            if weights == "bf16" and microbatches > 1 and arch not in GQA
            else None)
    state = adamw.init_state(model)
    old = {k: t.detach().clone() for k, t in model.named_parameters()}
    got_model, got_state, met = steps.make_train_step(
        cfg, None, opt, microbatches=microbatches)(
        model, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got_model is model and got_state is state
    assert sorted(met) == sorted(rmet) == ["aux", "ce", "grad_norm", "loss",
                                           "lr"]
    bf16 = 2.0 ** -7 if weights == "bf16" else 0.0
    for key in met:
        r = float(rmet[key])
        slack = bf16 * abs(r) if key == "grad_norm" else 0.0
        assert abs(float(met[key]) - r) <= _tol(r) + slack, key
    assert int(state["step"]) == int(rstate["step"]) == 1
    lr = float(rmet["lr"])
    new = {k: v.double().numpy() for k, v in model.state_dict().items()}
    ref_m = _ref_leaves(rstate["m"])
    ms, vs = adamw.leaves(state["m"]), adamw.leaves(state["v"])
    decay = convert.decayed_paths(old, cfg)
    for path, r in _ref_leaves(rparams).items():
        err = np.abs(new[path] - r)
        if path.endswith("mixer.wk.b"):      # a gradient of exactly 0
            assert float(err.max()) <= 2 * lr, path
            continue
        if arch not in GQA:
            rm, pm = ref_m[path], ms[path].double().numpy()
            # AdamW's move is not sign-saturated where 0 < |g| < 100 eps
            apart = (rm != 0) & (np.abs(rm) < (1 - opt.beta1) * 100
                                 * opt.eps)
            if gsum is not None:
                # bf16: two microbatch gradients that cancel to within one
                # rounding of their sum, to a sign (or zero) the packages
                # need not share
                apart |= ((np.sign(pm) != np.sign(rm))
                          & (np.abs(pm - rm) <= bf16 * np.abs(rm).max())
                          & (np.abs(rm) <= (1 - opt.beta1) * 2.0 ** -8
                             * gsum[path]))
        else:
            apart = np.zeros(err.shape, bool)
        if apart.any():
            want = _first_step(opt, old[path], ms[path], vs[path],
                               met["lr"], path in decay)
            moved = np.abs(new[path] - want)[apart]
            assert float(moved.max()) <= _tol(r), path
            err = err[~apart]
        assert float(err.max(initial=0)) <= _tol(r), path
    for key, mult in (("m", 1), ("v", 2)):
        got = {k: v.double().numpy()
               for k, v in adamw.leaves(state[key]).items()}
        for path, r in _ref_leaves(rstate[key]).items():
            err = float(np.abs(got[path] - r).max())
            assert err <= _tol(r) + mult * bf16 * float(np.abs(r).max()), (
                key, path, err)


def test_remat_gives_the_same_bits():
    cfg = configs.get_smoke("llama3-8b")
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = transformer.Transformer(
            c, device="cpu", generator=torch.Generator().manual_seed(3))
        state = adamw.init_state(model)
        step = steps.make_train_step(c, None, opt, microbatches=2)
        mets = [step(model, state, batch)[2] for _ in range(2)]
        out.append((model.state_dict(), state, mets))
    (p0, s0, m0), (p1, s1, m1) = out
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    for key in ("m", "v"):
        a, b = adamw.leaves(s0[key]), adamw.leaves(s1[key])
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x[k], y[k]) for x, y in zip(m0, m1) for k in x)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"])
def test_remat_carries_the_moe_aux(arch):
    """A remat train step equals the plain one bit for bit on the MoE
    families, aux included (the checkpointed layer returns it beside its
    output), and the aux reaches the loss: AUX_WEIGHT · aux > 0."""
    cfg = configs.get_smoke(arch)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = transformer.Transformer(
            c, device="cpu", generator=torch.Generator().manual_seed(3))
        state = adamw.init_state(model)
        met = steps.make_train_step(c, None, opt, microbatches=2)(
            model, state, batch)[2]
        out.append((model.state_dict(), met))
    (p0, m0), (p1, m1) = out
    assert float(m0["aux"]) > 0
    assert abs(float(m0["loss"]) - float(
        m0["ce"] + steps.AUX_WEIGHT * m0["aux"])) <= 1e-6
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """With remat the backward runs every layer's attention again: two
    flash calls per layer per microbatch, as on the card."""
    calls = []
    real = flash_attn.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(flash_attn, "flash_attention", counted)
    cfg = configs.get_smoke("llama3-8b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    opt = adamw.AdamWConfig()
    for remat, per_layer in ((False, 1), (True, 2)):
        c = dataclasses.replace(cfg, remat=remat)
        model = transformer.Transformer(
            c, device="cpu", generator=torch.Generator().manual_seed(3))
        calls.clear()
        steps.make_train_step(c, None, opt, microbatches=2)(
            model, adamw.init_state(model), batch)
        assert len(calls) == per_layer * c.n_layers * 2, remat
        calls.clear()
        with torch.no_grad():
            transformer.forward(c, model, batch["tokens"], mode="train")
        assert len(calls) == c.n_layers


# ---------------------------------------------------------------------------
# the trainer


class _Crash(Exception):
    pass


def _crash_at(monkeypatch, mod, step):
    """Make `mod.TokenStream.batch` raise at `step`: a run killed after its
    checkpoint of that step."""
    real = mod.TokenStream.batch

    def batch(self, s, **kw):
        if s == step:
            raise _Crash(s)
        return real(self, s, **kw)

    monkeypatch.setattr(mod.TokenStream, "batch", batch)


def _argv(ckpt_dir, steps=4, arch="llama3-8b", **extra):
    argv = ["--arch", arch, "--smoke", "--steps", str(steps),
            "--batch", "4", "--seq", "16", "--ckpt-every", "2",
            "--log-every", "1", "--ckpt-dir", str(ckpt_dir)]
    for k, v in extra.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv


def _arrays(ckpt_dir, step):
    path = os.path.join(ckpt_dir, f"step_{step:010d}", "arrays.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def ref_bf16_restore(monkeypatch):
    """The reference's `ckpt.restore` casts each loaded array to its
    target's dtype; a bf16 leaf loads as raw `|V2` words, and numpy has no
    cast from those to ml_dtypes' bfloat16, so the reference cannot restore
    its own bf16 checkpoints here. Reinterpret the words after its checks
    (the same bytes, checksums verified first)."""
    real = rckpt._load_step

    def load(directory, step):
        arrays, meta = real(directory, step)
        return ({k: a.view(ml_dtypes.bfloat16) if a.dtype == np.dtype("V2")
                 else a for k, a in arrays.items()}, meta)

    monkeypatch.setattr(rckpt, "_load_step", load)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_trainer_resumes_bit_for_bit(tmp_path, monkeypatch, microbatches):
    straight = train.main(_argv(tmp_path / "a", device="cpu",
                                microbatches=microbatches))
    with monkeypatch.context() as mp:
        _crash_at(mp, train, 2)
        with pytest.raises(_Crash):
            train.main(_argv(tmp_path / "b", device="cpu",
                             microbatches=microbatches))
    assert rckpt.latest_step(str(tmp_path / "b")) == 2
    resumed = train.main(_argv(tmp_path / "b", device="cpu",
                               microbatches=microbatches))
    assert resumed == straight
    a, b = _arrays(tmp_path / "a", 4), _arrays(tmp_path / "b", 4)
    assert sorted(a) == sorted(b)
    assert all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
               for k in a)


def test_trainer_resumed_at_its_end_keeps_its_loss(tmp_path):
    """A run resumed from the checkpoint of its last step takes no step and
    returns the loss that checkpoint recorded."""
    done = train.main(_argv(tmp_path, steps=2, device="cpu"))
    assert train.main(_argv(tmp_path, steps=2, device="cpu")) == done


def test_checkpoint_layout_is_the_reference_tree(tmp_path):
    """The port's checkpoint holds the reference's trainer tree: the same
    array names, shapes and dtypes."""
    train.main(_argv(tmp_path / "p", steps=2, device="cpu"))
    rtrain.main(_argv(tmp_path / "r", steps=2))
    p, r = _arrays(tmp_path / "p", 2), _arrays(tmp_path / "r", 2)
    assert sorted(p) == sorted(r)
    assert all(p[k].shape == r[k].shape and p[k].dtype == r[k].dtype
               for k in p)


def test_port_checkpoint_resumes_in_the_reference(tmp_path, monkeypatch,
                                                  ref_bf16_restore):
    with monkeypatch.context() as mp:
        _crash_at(mp, pipeline, 2)
        with pytest.raises(_Crash):
            train.main(_argv(tmp_path / "p", device="cpu"))
    shutil.copytree(tmp_path / "p", tmp_path / "r")
    port = train.main(_argv(tmp_path / "p", device="cpu"))
    ref = rtrain.main(_argv(tmp_path / "r"))
    assert abs(port - ref) <= 1e-4, (port, ref)


def test_reference_checkpoint_resumes_in_the_port(tmp_path, monkeypatch,
                                                  ref_bf16_restore):
    with monkeypatch.context() as mp:
        _crash_at(mp, rpipe, 2)
        with pytest.raises(_Crash):
            rtrain.main(_argv(tmp_path / "r"))
    shutil.copytree(tmp_path / "r", tmp_path / "p")
    ref = rtrain.main(_argv(tmp_path / "r"))
    port = train.main(_argv(tmp_path / "p", device="cpu"))
    assert abs(port - ref) <= 1e-4, (port, ref)


def test_moe_mla_checkpoint_resumes_across_packages(tmp_path, monkeypatch,
                                                   ref_bf16_restore):
    """deepseek-v2-lite's smoke config (an unstacked dense first layer, MLA
    and MoE layers stacked): the port's checkpoint of step 2 holds the
    reference's tree and resumes in the reference, and the reference's in
    the port, each run's final loss within 1e-4 of the other package's."""
    arch = "deepseek-v2-lite-16b"
    with monkeypatch.context() as mp:
        _crash_at(mp, pipeline, 2)
        with pytest.raises(_Crash):
            train.main(_argv(tmp_path / "p", arch=arch, device="cpu"))
    p = _arrays(tmp_path / "p", 2)
    assert any(k.startswith("params/prefix/0/") for k in p)
    shutil.copytree(tmp_path / "p", tmp_path / "r")
    port = train.main(_argv(tmp_path / "p", arch=arch, device="cpu"))
    ref = rtrain.main(_argv(tmp_path / "r", arch=arch))
    assert abs(port - ref) <= 1e-4, (port, ref)
    r = _arrays(tmp_path / "r", 4)
    assert sorted(r) == sorted(_arrays(tmp_path / "p", 4))
    shutil.copytree(tmp_path / "r", tmp_path / "back")
    ref = rtrain.main(_argv(tmp_path / "r", steps=6, arch=arch))
    port = train.main(_argv(tmp_path / "back", steps=6, arch=arch,
                            device="cpu"))
    assert abs(port - ref) <= 1e-4, (port, ref)


def test_cli_runs_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "llama3-8b", "--smoke", "--device", "cpu", "--batch", "4",
           "--seq", "16", "--ckpt-dir", str(tmp_path)]
    first = subprocess.run(cmd + ["--steps", "3"], env=env, check=True,
                           capture_output=True, text=True, timeout=300)
    assert "[train] done: final loss" in first.stdout
    again = subprocess.run(cmd + ["--steps", "5"], env=env, check=True,
                           capture_output=True, text=True, timeout=300)
    assert "[train] resumed from step 3" in again.stdout
    assert "[train] step     4" in again.stdout


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-2b"])
def test_encdec_and_mrope_checkpoints_resume_across_packages(
        tmp_path, monkeypatch, ref_bf16_restore, arch):
    """whisper (the frames both trainers draw from `default_rng(0)`, the
    encoder stacked under `enc.blk`, `pos_emb`) and qwen2-vl (positions
    0..seq-1 in all three streams): the port's checkpoint holds the
    reference trainer's tree, and resumed in either package from the
    port's step 2 the final losses agree within 1e-4."""
    with monkeypatch.context() as mp:
        _crash_at(mp, pipeline, 2)
        with pytest.raises(_Crash):
            train.main(_argv(tmp_path / "p", arch=arch, device="cpu"))
    rtrain.main(_argv(tmp_path / "layout", steps=2, arch=arch))
    p, r = _arrays(tmp_path / "p", 2), _arrays(tmp_path / "layout", 2)
    assert sorted(p) == sorted(r)
    assert all(p[k].shape == r[k].shape and p[k].dtype == r[k].dtype
               for k in p)
    shutil.copytree(tmp_path / "p", tmp_path / "r")
    port = train.main(_argv(tmp_path / "p", arch=arch, device="cpu"))
    ref = rtrain.main(_argv(tmp_path / "r", arch=arch))
    assert abs(port - ref) <= 1e-4, (port, ref)
