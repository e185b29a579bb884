"""One rank of the port's multi-rank CPU checks: run as

    python tests/_torch_mesh_worker.py SUITE RANK WORLD STORE OUT

with a gloo group over a `FileStore` (no TCP port), or, for the `trace`
suite, alone over a fake 4-rank group. Rank 0 writes the suite's results
to OUT as JSON. The test files (`test_torch_mesh_*.py`,
`test_torch_distributed_mp.py` and the one-rank checks of the scheduler's
tests) start the ranks and read the results; the reference's side runs in
its own subprocess there (`reference_side`). The mesh is 2 x 2
(data, model) but for the anytime suites, whose mesh is the 1-D
`workers` axis over every rank; the `trace` and `flip_dryrun` suites run
rank 0 alone over a fake 4-rank group.
"""

import dataclasses
import datetime
import json
import os
import sys
import warnings
import zlib

import numpy as np

warnings.filterwarnings("ignore")

STEP_ARCHS = ["llama3-8b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
              "minicpm3-4b", "rwkv6-3b", "jamba-v0.1-52b",
              "whisper-large-v3", "qwen2-vl-2b"]
# (arch, layout): tp for every family, ep for olmoe, sp for llama3-8b,
# rwkv6-3b, jamba and whisper (its encoder's frames split too),
# llama3-8b with one KV head (its cache split on the head dim), rwkv6-3b
# and whisper with one head (a replicated mixer over a cache split on the
# head dim), llama3-8b and jamba with remat (each layer's local_map
# recomputed), and three heads of 16 on the 2-way model axis, which cut a
# head (`h3`: llama3-8b with one KV head, whisper's self and cross
# attention, qwen2-vl-2b's M-RoPE, rwkv6-3b's time mixing, MLA with and
# without q-LoRA)
STEP_CASES = ([(a, "tp") for a in STEP_ARCHS]
              + [("olmoe-1b-7b", "ep"), ("llama3-8b", "sp"),
                 ("llama3-8b/kv1", "tp"), ("rwkv6-3b/h1", "tp"),
                 ("whisper-large-v3/h1", "tp"), ("llama3-8b/remat", "tp"),
                 ("jamba-v0.1-52b/remat", "tp"), ("llama3-8b/h3", "tp"),
                 ("llama3-8b/h3", "sp"), ("whisper-large-v3/h3", "tp"),
                 ("qwen2-vl-2b/h3", "tp"), ("rwkv6-3b/h3", "tp"),
                 ("minicpm3-4b/h3", "tp"), ("deepseek-v2-lite-16b/h3", "tp"),
                 ("rwkv6-3b", "sp"), ("jamba-v0.1-52b", "sp"),
                 ("whisper-large-v3", "sp")])
TRACE_ARCHS = ["llama3-8b", "olmoe-1b-7b", "qwen2-7b", "deepseek-v2-lite-16b",
               "minicpm3-4b", "rwkv6-3b", "jamba-v0.1-52b",
               "whisper-large-v3", "qwen2-vl-2b", "llama3-8b/h3",
               "llama3-8b/mh3", "whisper-large-v3/h3", "rwkv6-3b/h3",
               "minicpm3-4b/h3"]


def variant(cfg, name: str):
    """A smoke config's test variant, for either package's config: `kv1`
    one KV head, `remat`, `h1` one head, `h3` three heads of 16 (one KV
    head, or three where the config's KV heads are its heads; RWKV6 at
    width 48), `mh3`
    three heads and three KV heads of 16."""
    import dataclasses

    rep = dataclasses.replace
    if name == "kv1":
        return rep(cfg, n_kv_heads=1)
    if name == "remat":
        return rep(cfg, remat=True)
    if name == "h1" and cfg.rwkv_mode:
        return rep(cfg, rwkv_head_dim=cfg.d_model)
    if name == "h1":
        return rep(cfg, n_heads=1, n_kv_heads=1, head_dim=cfg.d_model)
    if name == "h3" and cfg.rwkv_mode:
        return rep(cfg, d_model=48, rwkv_head_dim=16)
    if name == "h3":
        kv = 3 if cfg.n_kv_heads == cfg.n_heads else 1
        return rep(cfg, n_heads=3, n_kv_heads=kv, head_dim=16)
    if name == "mh3":
        return rep(cfg, n_heads=3, n_kv_heads=3, head_dim=16)
    assert not name, name
    return cfg


def smoke(arch):
    from repro_torch import configs

    name, _, var = arch.partition("/")
    return variant(configs.get_smoke(name), var)


def moe_inputs(seed=0):
    """The MoE twin's f32 parameters and input, numpy, from a seed."""
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.common import tree_leaves

    cfg = configs.get_smoke("olmoe-1b-7b")
    rng = np.random.default_rng(seed)
    flat = {}
    for path, s in tree_leaves(moe.moe_spec(cfg)):
        flat[path] = (rng.standard_normal(s.shape) / np.sqrt(
            s.shape[-2] if len(s.shape) >= 2 else 1)).astype(np.float32)
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    return cfg, flat, x


MOE_RULES = {"dp": {"batch": "data", "mlp": None, "experts": None},
             "tp": {"batch": "data", "mlp": "model", "experts": None},
             "ep": {"batch": "data", "mlp": None, "experts": "model"}}


def suite_moe(mesh):
    import torch

    from repro_torch.launch import sharding as sh
    from repro_torch.models import moe
    from repro_torch.models.common import (
        TP_RULES, sanitized_pspecs, tree_leaves, tree_nest)

    cfg, flat, x = moe_inputs()
    p = tree_nest({k: torch.from_numpy(v) for k, v in flat.items()})
    xt = torch.from_numpy(x)
    local, aux_local = moe.moe_ffn(cfg, p, xt)
    out = {"local": local.numpy().tolist(), "aux_local": float(aux_local)}
    for name, rules in MOE_RULES.items():
        r = dict(TP_RULES, **rules)
        ctx = moe.ShardCtx(mesh=mesh, dp=("data",), tp="model", rules=r)
        ps = dict(tree_leaves(sanitized_pspecs(moe.moe_spec(cfg), r, mesh)))
        pd = tree_nest({k: sh.distribute(torch.from_numpy(v),
                                         sh.named(mesh, ps[k]))
                        for k, v in flat.items()})
        xd = sh.distribute(xt, sh.named(mesh, ("data", None, None)))
        o, aux = moe.moe_ffn(cfg, pd, xd, ctx)
        out[name] = o.full_tensor().numpy().tolist()
        out[f"aux_{name}"] = float(aux.full_tensor())
        out[f"local_{name}"] = list(o.to_local().shape)
    out["mesh"] = _mesh_checks(mesh)
    return out


def _mesh_checks(mesh):
    """`launch.mesh` on the 4-rank group: a mesh of another size raises,
    the worker mesh spans the group, `dp_axes` names the data axes."""
    from repro_torch.launch import mesh as lmesh

    try:
        lmesh.compat_mesh((2, 4), ("data", "model"), devices="cpu")
        mismatch = "built"
    except ValueError as e:
        mismatch = str(e)
    workers = lmesh.make_worker_mesh()
    return {"mismatch": mismatch,
            "workers": [list(workers.mesh.shape), workers.mesh_dim_names],
            "dp_axes": list(lmesh.dp_axes(mesh)),
            "names": list(mesh.mesh_dim_names),
            "coordinate": mesh.get_coordinate()}


def _model(cfg):
    import torch

    from repro_torch.models import transformer

    m = transformer.Transformer(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    for q in m.parameters():
        q.data = q.data.float()
    return m


def _batch(cfg, b, s):
    import torch

    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=g).to(torch.int32)
    lab = torch.randint(0, cfg.vocab_size, (b, s), generator=g).to(torch.int32)
    extra = {}
    if cfg.mrope_sections:
        pos = torch.arange(s).expand(b, s)
        extra["positions"] = torch.stack([pos, pos // 2, pos]).to(torch.int32)
    if cfg.is_encdec:
        extra["frames"] = torch.randn(b, cfg.encoder_seq, cfg.d_model,
                                      generator=g).to(cfg.dtype)
    return tok, lab, extra


def _err(a, b) -> float:
    return float((a.full_tensor() - b).abs().max())


def suite_steps(mesh):
    """Every case's train, prefill and decode steps with a ShardCtx
    against ctx=None on the same weights: the train step against ctx=None
    over 2 microbatches (one per data shard, which is what a data-sharded
    step averages), prefill's logits and cache, and 6 teacher-forced
    decode steps' logits."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import steps, transformer
    from repro_torch.optim import adamw

    res = {}
    for arch, layout in STEP_CASES:
        cfg = smoke(arch)
        b, s, t_dec = 4, 16, 6
        tok, lab, extra = _batch(cfg, b, s)
        ctx = sh.make_ctx(mesh, cfg, None, layout=layout)
        # one warmup step, so the first step moves every weight by ~lr
        opt = adamw.AdamWConfig(warmup_steps=1)
        m0 = _model(cfg)
        init = {k: q.detach().clone() for k, q in m0.named_parameters()}
        st0 = adamw.init_state(m0)
        _, _, met0 = steps.make_train_step(cfg, None, opt, microbatches=2)(
            m0, st0, {"tokens": tok, "labels": lab, **extra})
        m1 = sh.distribute_params(_model(cfg), mesh, cfg, ctx.rules)
        st1 = adamw.init_state(m1)
        _, _, met1 = steps.make_train_step(cfg, ctx, opt)(
            m1, st1, {"tokens": tok, "labels": lab, **extra})
        p0 = dict(m0.named_parameters())
        r = {"loss": [float(met0["loss"]), float(met1["loss"].full_tensor())],
             "grad_norm": [float(met0["grad_norm"]),
                           float(met1["grad_norm"].full_tensor())],
             "param_err": max(_err(q, p0[k])
                              for k, q in m1.named_parameters()),
             "param_step": max(float((q - init[k]).abs().max())
                               for k, q in p0.items()),
             **_update_errs(opt, init, p0, dict(m1.named_parameters()),
                            st0),
             "m_err": _moment_err(st0, st1)}
        mp = _model(cfg)
        md = sh.distribute_params(_model(cfg), mesh, cfg, ctx.rules)
        lg0, c0 = steps.make_prefill_step(cfg)(mp, {"tokens": tok, **extra})
        lg1, c1 = steps.make_prefill_step(cfg, ctx)(
            md, {"tokens": tok, **extra})
        r["prefill"] = _err(lg1, lg0)
        r["prefill_cache"] = max(_err(c1[i][k], c0[i][k])
                                 for i in range(len(c0)) for k in c0[i])
        r["scale"] = float(lg0.abs().max())
        fr = extra.get("frames")
        cz = transformer.init_cache(cfg, mp, b, t_dec, frames=fr)
        frd = (steps.shard_batch(cfg, ctx, {"frames": fr})["frames"]
               if fr is not None else None)
        cd = transformer.init_cache(cfg, md, b, t_dec, frames=frd, ctx=ctx)
        dec0, dec1 = steps.make_decode_step(cfg), steps.make_decode_step(
            cfg, ctx)
        e = 0.0
        for t in range(t_dec):
            l0, cz = dec0(mp, cz, {"tokens": tok[:, t:t + 1],
                                   "cache_len": t})
            l1, cd = dec1(md, cd, {"tokens": tok[:, t:t + 1],
                                   "cache_len": t})
            e = max(e, _err(l1, l0))
        r["decode"] = e
        r["decode_scale"] = float(l0.abs().max())
        res[f"{arch}|{layout}"] = r
    return res


# -- the SP decode flip (test_torch_mesh_flip.py) ----------------------------

# batch 1 (below the 2 data ranks: the batch replicated, every K/V and
# latent cache split on its sequence over "data"), a 16-token prompt, 6
# teacher-forced decode steps into FLIP_SLOTS slots; `wrap` decodes into
# 20 slots, so its writes cross from rank 1's slots (10..19) into rank
# 0's (0, 1)
FLIP_ARCHS = ["llama3-8b", "llama3-8b/kv1", "jamba-v0.1-52b",
              "deepseek-v2-lite-16b", "whisper-large-v3", "rwkv6-3b"]
FLIP_PROMPT, FLIP_STEPS, FLIP_SLOTS, FLIP_WRAP_SLOTS = 16, 6, 22, 20
FLIP_CASES = FLIP_ARCHS + ["llama3-8b|wrap"]
# against the reference's own flipped decode; the wrap case there too,
# since ctx=None's ring write is the port's own code
FLIP_REF_CASES = ["llama3-8b", "jamba-v0.1-52b", "llama3-8b|wrap"]
# planted faults of the merge, each run on the wrap case
FLIP_FAULTS = ("no_rescale", "own_denominator")


def flip_tokens(cfg):
    """The flip cases' (1, prompt + steps) tokens, numpy, from a seed."""
    rng = np.random.default_rng(3)
    return rng.integers(0, cfg.vocab_size,
                        (1, FLIP_PROMPT + FLIP_STEPS)).astype(np.int32)


def flip_frames(cfg):
    rng = np.random.default_rng(4)
    return rng.standard_normal((1, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)


def _seq_leaf(cfg, i, key) -> bool:
    from repro_torch.models import transformer

    spec = transformer.layer_cache_spec(cfg, cfg.layer_kind(i), 1, 1)
    return "kv_seq" in spec[key].axes


def _grown(cfg, pre, slots):
    """A prefill cache (full tensors) in a decode cache of `slots` slots:
    the prompt's slots first, the other leaves whole."""
    import torch

    from repro_torch.models import transformer

    out = []
    for i, (layer, spec) in enumerate(zip(pre, transformer.cache_spec(
            cfg, 1, slots))):
        c = {}
        for k, t in layer.items():
            if _seq_leaf(cfg, i, k):
                c[k] = torch.zeros(spec[k].shape, dtype=t.dtype)
                c[k][:, :t.shape[1]] = t
            else:
                c[k] = t.clone()
        out.append(c)
    return out


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _bound_err(got, want):
    """max|got - want| over the dense bound's scale 1 + max|want|."""
    g, w = _whole(got), _whole(want)
    return float((g - w).abs().max()) / (1.0 + float(w.abs().max()))


def flip_run(cfg, model, mesh, slots, ctx):
    """A prefill of the flip prompt and FLIP_STEPS teacher-forced decode
    steps into `slots` slots, with `ctx` (None: one process) on `model`:
    (prefill logits, prefill cache, decode logits, cache after decode),
    every tensor whole."""
    import torch

    from repro_torch.launch import sharding as sh
    from repro_torch.models import steps

    tok = torch.from_numpy(flip_tokens(cfg))
    batch = {"tokens": tok[:, :FLIP_PROMPT]}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(flip_frames(cfg))
    lg, pre = steps.make_prefill_step(cfg, ctx)(model, batch)
    pre = [{k: _whole(t) for k, t in layer.items()} for layer in pre]
    cache = _grown(cfg, pre, slots)
    if ctx is not None:
        cache = sh.distribute_cache(cache, mesh, cfg, 1, slots, ctx.rules)
    dec = steps.make_decode_step(cfg, ctx)
    out = []
    for t in range(FLIP_STEPS):
        at = FLIP_PROMPT + t
        lgd, cache = dec(model, cache, {"tokens": tok[:, at:at + 1],
                                        "cache_len": at})
        out.append(_whole(lgd))
    return (_whole(lg), pre, torch.cat(out, dim=1),
            [{k: _whole(t) for k, t in layer.items()} for layer in cache])


def flip_ctx(mesh, cfg, slots):
    """The flip's ctx: `make_ctx` for a decode of global batch 1."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import sharding as sh

    return sh.make_ctx(mesh, cfg, ShapeSpec("flip", slots, 1, "decode"))


def _flip_errs(got, want) -> dict:
    (lg1, pre1, dec1, c1), (lg0, pre0, dec0, c0) = got, want
    return {"prefill": _bound_err(lg1, lg0),
            "prefill_cache": max(_bound_err(pre1[i][k], pre0[i][k])
                                 for i in range(len(pre0)) for k in pre0[i]),
            "decode": max(_bound_err(dec1[:, t], dec0[:, t])
                          for t in range(FLIP_STEPS)),
            "decode_cache": max(_bound_err(c1[i][k], c0[i][k])
                                for i in range(len(c0)) for k in c0[i])}


def _no_rescale(lg, group):
    """A planted fault: the merge without the rescale by the global max."""
    import torch

    from repro_torch.models.parallel import _all_reduce

    e = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    return e / _all_reduce(e.sum(dim=-1, keepdim=True), group)


def _own_denominator(lg, group):
    """A planted fault: each rank's probabilities over its own sum, the
    other ranks' denominators left out."""
    import torch

    from repro_torch.models.parallel import _all_reduce

    m = lg.amax(dim=-1, keepdim=True)
    e = torch.exp(lg - m)
    scale = torch.exp(m - _all_reduce(m, group, "max"))
    return e * (scale / (e.sum(dim=-1, keepdim=True) * scale))


def suite_flip(mesh):
    """Every flip case with the flip's ctx against ctx=None on the same
    weights: the prefill's last-position logits and its cache, each
    decode step's logits and the cache after them, every leaf gathered
    whole; where the cache's sequence is split; the planted merge faults
    on the wrap case; and FLIP_REF_CASES on the reference's weights
    (written by its `flip` part), with their logits."""
    from torch.distributed.tensor import Shard

    from repro_torch.launch import sharding as sh
    from repro_torch.models import convert, parallel, transformer

    res = {}
    for case in FLIP_CASES:
        arch, _, tag = case.partition("|")
        cfg = smoke(arch)
        slots = FLIP_WRAP_SLOTS if tag == "wrap" else FLIP_SLOTS
        ctx = flip_ctx(mesh, cfg, slots)
        want = flip_run(cfg, _model(cfg), mesh, slots, None)
        md = sh.distribute_params(_model(cfg), mesh, cfg, ctx.rules)
        r = _flip_errs(flip_run(cfg, md, mesh, slots, ctx), want)
        shs = sh.cache_shardings(mesh, cfg, 1, slots, ctx.rules)
        r["split_leaves"] = sorted(
            f"{i}.{k}" for i, layer in enumerate(shs)
            for k, one in layer.items()
            if isinstance(one.placements[0], Shard)
            and one.placements[0].dim == 1)
        r["rules"] = {k: ctx.rules[k] for k in ("batch", "kv_seq")}
        if tag == "wrap":
            saved = parallel.softmax_merge
            for name, fault in zip(FLIP_FAULTS, (_no_rescale,
                                                 _own_denominator)):
                parallel.softmax_merge = fault
                try:
                    r[f"fault_{name}"] = _flip_errs(
                        flip_run(cfg, md, mesh, slots, ctx), want)
                finally:
                    parallel.softmax_merge = saved
        res[case] = r
    tmp = os.environ["MESH_WORKER_TMP"]
    for case in FLIP_REF_CASES:
        arch, _, tag = case.partition("|")
        slots = FLIP_WRAP_SLOTS if tag == "wrap" else FLIP_SLOTS
        cfg = smoke(arch)
        with np.load(os.path.join(tmp, f"flip_params_{arch}.npz")) as z:
            flat = {k: z[k] for k in z.files}
        state = convert.params_from_reference(_nest_flat(flat))
        model = transformer.Transformer(cfg, device="cpu")
        model.load_state_dict({k: v.float() for k, v in state.items()})
        ctx = flip_ctx(mesh, cfg, slots)
        sh.distribute_params(model, mesh, cfg, ctx.rules)
        lg, _, dec, _ = flip_run(cfg, model, mesh, slots, ctx)
        res[f"ref|{case}"] = {"prefill": lg[:, -1].tolist(),
                              "decode": dec.tolist()}
    return res


def _nest_flat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def suite_flip_dryrun(mesh):
    """The dry-run's record of a flipped decode cell (global batch 1 below
    the 2 data ranks) at smoke size on the fake 2 x 2 group, for the
    hybrid (jamba) and a dense config."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    tmp = os.environ["MESH_WORKER_TMP"]
    out = {}
    for arch in ("jamba-v0.1-52b", "llama3-8b"):
        shape = ShapeSpec("smoke_long", 64, 1, "decode")
        rec = dryrun.run_cell(arch, shape, False, tmp, force=True,
                              cfg=smoke(arch), mesh=mesh)
        out[arch] = {k: rec.get(k) for k in ("ok", "error",
                                              "collectives_raw", "memory")}
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _update_errs(opt, init, p0, p1, st0) -> dict:
    """How far the sharded step's update is from ctx=None's where AdamW's
    first step is well conditioned: at elements whose ctx=None gradient
    (`m / (1 - beta1)` after one step) is at least 10 eps, where the step
    is lr · g / (|g| + eps) and a relative change δ of g moves it by at
    most δ / 10 of lr; nearer 0 (exact zeros too, which the other path may
    round to ±1e-12), a rounding of g is a visible share of lr. Also the
    share of elements left out."""
    m0 = _flat(st0["m"])
    err, n_out, n = 0.0, 0, 0
    for k, q in p1.items():
        d = (q.full_tensor() - init[k]) - (p0[k] - init[k])
        g0 = m0[k] / (1 - opt.beta1)
        keep = g0.abs() >= 10 * opt.eps
        if keep.any():
            err = max(err, float(d[keep].abs().max()))
        n_out += int((~keep).sum())
        n += keep.numel()
    return {"update_err": err, "ill_conditioned": n_out / n}


def _moment_err(st0, st1) -> float:
    a, b = _flat(st0["m"]), _flat(st1["m"])
    return max(_err(b[k], a[k]) for k in a)


def suite_trace(mesh):
    """The train-mode forward of each smoke config at (2, 16) tokens on a
    fake 2x2 mesh under TP rules: every collective the port issues (kind,
    result bytes, group size, wire bytes), from the dry-run's tally; and
    the dry-run's records of two smoke cells."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, report
    from repro_torch.launch import sharding as sh
    from repro_torch.models import steps, transformer

    out = {}
    for arch in TRACE_ARCHS:
        cfg = smoke(arch)
        ctx = sh.make_ctx(mesh, cfg, None, layout="tp")
        model = transformer.Transformer(cfg, device="meta")
        sh.distribute_params(model, mesh, cfg, ctx.rules)
        tok = torch.empty((2, 16), dtype=torch.int32, device="meta")
        batch = {"tokens": tok}
        if cfg.mrope_sections:
            batch["positions"] = torch.empty((3, 2, 16), dtype=torch.int32,
                                             device="meta")
        if cfg.is_encdec:
            batch["frames"] = torch.empty((2, cfg.encoder_seq, cfg.d_model),
                                          dtype=cfg.dtype, device="meta")
        batch = steps.shard_batch(cfg, ctx, batch)
        tally, log = dryrun.Tally(), _GatherLog()
        with torch.no_grad(), dryrun.traced(tally, model), log:
            transformer.forward(cfg, model, batch["tokens"], mode="train",
                                ctx=ctx, positions=batch.get("positions"),
                                frames=batch.get("frames"))
        colls = [c for v in tally.costs.values() for c in v["collectives"]]
        out[arch] = [[c.kind, c.result_bytes, c.group, c.wire_bytes]
                     for c in colls]
        out[f"{arch}|gathered_weights"] = _gathered_weights(model, log)
    recs = {}
    tmp = os.environ["MESH_WORKER_TMP"]
    for arch in ("llama3-8b", "olmoe-1b-7b"):
        for kind, bsz in (("train", 16), ("prefill", 4), ("decode", 4)):
            shape = ShapeSpec(f"smoke_{kind}", 16, bsz, kind)
            rec = dryrun.run_cell(arch, shape, False, tmp, force=True,
                                  cfg=smoke(arch), mesh=mesh)
            recs[f"{arch}|{kind}"] = rec
    # the global count of one dense layer's forward at the same shapes
    cfg = smoke("llama3-8b")
    d, f, h, kv, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    n = 4 * 16
    proj = 2 * n * d * (h * hd + 2 * kv * hd) + 2 * n * h * hd * d
    ffn = 2 * n * d * 2 * f + 2 * n * f * d
    attn = 4.0 * 4 * h * (16 * 17 / 2) * hd
    out["dense_layer_global_flops"] = proj + ffn + attn
    out["records"] = recs
    import contextlib
    import io

    for name in ("llama3-8b__smoke_prefill__single.json",):
        assert os.path.exists(os.path.join(tmp, name))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.main(["--artifacts", tmp])
    out["report"] = buf.getvalue()
    return out


def _gather_log_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class GatherLog(TorchDispatchMode):
        """The input shape of every all-gather this rank issues."""

        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket.__name__ == "all_gather_into_tensor":
                self.shapes.append(tuple(args[0].shape))
            return func(*args, **(kwargs or {}))

    return GatherLog


def _GatherLog():
    return _gather_log_mode()()


def _gathered_weights(model, log) -> list:
    """The parameters (by leaf name) whose local shard has the shape of
    an all-gather's input: the weights gathered per use."""
    out = set()
    for path, q in model.named_parameters():
        local = tuple(q.to_local().shape)
        if local in log.shapes and local != tuple(q.shape):
            out.add(path.rsplit(".", 2)[-2] if path.endswith((".w", ".b"))
                    else path.rsplit(".", 1)[-1])
    return sorted(out)


# -- the anytime rounds over a group (test_torch_distributed_mp.py) --------

ANY_SUITES = ("anytime", "one_rank")
FAKE_SUITES = ("trace", "flip_dryrun")
ANY_TIMEOUT_S = 120          # a rank left alone in a collective fails
ANY_M = 20
ANY_KW = dict(band=16, chunks_per_worker=4)
# name -> (AB join, k); the exclusions are the scheduler's defaults (5, 0)
ANY_CASES = {"self_k1": (False, 1), "ab_k1": (True, 1),
             "self_k4": (False, 4), "ab_k4": (True, 4)}
# failures in consecutive rounds, then resumes onto 3, 2 and 4 workers
ANY_CHAIN = (("step", (1, 3)), ("step", (1,)), ("step", (0, 2, 3)),
             ("ckpt",), ("resume", 3), ("step", ()), ("step", (2,)),
             ("ckpt",), ("resume", 2), ("step", ()), ("ckpt",),
             ("resume", 4), ("run",))
ANY_CHAIN_CASES = ("self_k1", "ab_k4")
ANY_FAULT_SEED = 5
ANY_FAULTS = dict(n_rounds=64, n_workers=4, p_worker_crash=0.15,
                  p_round_failure=0.3, max_round_failures=2,
                  p_checkpoint_kill=0.2, p_checkpoint_flip=0.2)
ANY_SUPERVISED_CASES = ("self_k1", "ab_k4")
# the workers that sweep their chunk of round 1; the rest are idle
ANY_IDLE = ((0, 2), (3,), ())
ANY_IDLE_CASES = ("self_k1", "ab_k1", "self_k4", "ab_k4")


def any_series():
    """The twin's series: n = 600 and 250, as `test_distributed_mp.py`."""
    rng = np.random.default_rng(1)
    ts = np.cumsum(rng.normal(size=600)).astype(np.float32)
    ts_b = np.cumsum(rng.normal(size=250)).astype(np.float32)
    return ts, ts_b


def any_make(cls, devices, case, ts=None, **kw):
    """`cls`, either package's `AnytimeScheduler`, for an ANY_CASES case;
    `devices` is the port's device list or mesh, or the reference's
    mesh."""
    ab, k = ANY_CASES[case]
    a, b = any_series()
    return cls(a if ts is None else ts, ANY_M, devices,
               ts_b=b if ab else None, k=k, **{**ANY_KW, **kw})


def _hex(x):
    a = np.ascontiguousarray(x.cpu().numpy() if hasattr(x, "cpu")
                             else np.asarray(x))
    return [a.dtype.str, list(a.shape), a.tobytes().hex()]


def any_array(h):
    """The array `_hex` wrote, bits unchanged."""
    dt, shape, data = h
    return np.frombuffer(bytes.fromhex(data), dtype=dt).reshape(shape)


def any_states(states):
    """Running states (a side may be None) with their bits."""
    return [None if st is None else [_hex(st.corr), _hex(st.index)]
            for st in states]


def any_dump(state):
    """A `SchedulerState` with its bits."""
    return {"frac": state.fraction_done, "done": _hex(state.done),
            "sides": any_states((state.profile, state.profile_b))}


def any_chain(make, ckdir):
    """ANY_CHAIN from a fresh `make()`: the state after each step, resume
    and run; checkpoint n goes to `ckdir/chain{n}.npz`."""
    sch, states, n = make(), [], 0
    for op, *arg in ANY_CHAIN:
        if op == "step":
            sch.step_round(fail_workers=set(arg[0]))
        elif op == "ckpt":
            n += 1
            sch.checkpoint(os.path.join(ckdir, f"chain{n}.npz"))
            continue
        elif op == "resume":
            sch = make()
            sch.resume(os.path.join(ckdir, f"chain{n}.npz"),
                       n_workers=arg[0])
        else:
            sch.run()
        states.append(any_dump(sch.state))
    return states


def any_supervised(make, path):
    """A supervised run under the seeded schedule: its state and report."""
    from repro_torch.core.faults import FaultInjector, FaultPolicy

    sch = make()
    sch.run_supervised(FaultPolicy(checkpoint_every=1,
                                   worker_failure_threshold=3,
                                   sleep=lambda _s: None),
                       checkpoint_path=path,
                       injector=FaultInjector.seeded(ANY_FAULT_SEED,
                                                     **ANY_FAULTS))
    rep = dataclasses.asdict(sch.supervised_report)
    rep["worker_failures"] = sorted(rep["worker_failures"].items())
    return {"state": any_dump(sch.state),
            "report": json.loads(json.dumps(rep))}


def any_idle(sch):
    """Round 1's bounds with only the ANY_IDLE workers live, each applied
    to the state after round 0: the merged states."""
    sch.step_round()
    k0s, k1s = sch._round_bounds(sch.plan.rounds[1])
    out = []
    for live in ANY_IDLE:
        off = ~np.isin(np.arange(len(k0s)), live)
        a0, a1 = k0s.copy(), k1s.copy()
        a0[off] = a1[off] = sch._k_empty
        out.append(any_states(sch._run_round(sch.state, a0, a1)))
    return out


def any_tie_states(rank):
    """Rank `rank`'s states for the merges' tie rules: correlations that
    tie across ranks, indices that tell the ranks apart ((l,) and
    (l, 3))."""
    import torch

    from repro_torch.core.matrix_profile import NEG, ProfileState, TopKState

    i32 = torch.int32
    one = ProfileState(
        torch.tensor([0.5, 0.9 if rank % 2 else 0.8, 0.3, NEG]),
        torch.tensor([rank, 4 - rank, 2 * rank, -1], dtype=i32))
    topk = TopKState(
        torch.tensor([[0.9, 0.9, 0.1], [0.7, 0.2 + 0.1 * rank, NEG]]),
        torch.tensor([[rank, 10 + rank, 20 + rank], [30 + rank, 40 + rank,
                                                     -1]], dtype=i32))
    return one, topk


def _own_index_pmax(state, group):
    """A planted fault: the correlations' all-reduce without the index
    reduction, each rank keeping its own index."""
    import torch.distributed as dist

    from repro_torch.core.matrix_profile import ProfileState

    gmax = state.corr.clone()
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    return ProfileState(gmax, state.index.clone())


def _gathered(value):
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, value)
    return got


def _raised(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def suite_anytime(mesh):
    """The scheduler with one rank per worker: every case round by round,
    each rank's final state, the failure and resume chains, supervised
    runs, rounds with idle ranks, the merges' tie rules, the guard against
    ranks given different series or plans, a device list under the group,
    and the planted index-reduction fault."""
    import torch.distributed as dist

    from repro_torch.core import distributed
    from repro_torch.core import plan as tplan
    from repro_torch.core.scheduler import AnytimeScheduler

    ckdir = os.path.join(os.environ["MESH_WORKER_TMP"], "anytime_ckpt")

    def mk(case, **kw):
        return any_make(AnytimeScheduler, mesh, case, **kw)

    out = {"rounds": {}, "final_crc": {}, "chain": {}, "supervised": {},
           "idle": {}}
    for case in ANY_CASES:
        sch = mk(case)
        out["rounds"][case] = [any_dump(sch.step_round())
                               for _ in range(sch.plan.n_rounds)]
        out["final_crc"][case] = _gathered(zlib.crc32(json.dumps(
            any_dump(sch.state)).encode()))
    for case in ANY_CHAIN_CASES:
        d = os.path.join(ckdir, case)
        os.makedirs(d, exist_ok=True)
        out["chain"][case] = any_chain(lambda: mk(case), d)
    for case in ANY_SUPERVISED_CASES:
        out["supervised"][case] = any_supervised(
            lambda: mk(case), os.path.join(ckdir, f"sup_{case}.npz"))
    for case in ANY_IDLE_CASES:
        out["idle"][case] = any_idle(mk(case))
    group, size, rank = distributed._worker_group(mesh)
    one, topk = any_tie_states(rank)
    out["ties"] = any_states((distributed._pmax_group(one, group),
                              distributed._allreduce_topk_group(topk, group,
                                                                size)))
    ts, _ = any_series()
    bent = ts.copy()
    bent[123] += 1.0
    rank = dist.get_rank()
    out["guard"] = {
        "series": _gathered(_raised(
            lambda: mk("self_k1", ts=bent if rank == 2 else None))),
        "band": _gathered(_raised(
            lambda: mk("self_k1", band=32 if rank == 1 else 16)))}
    out["too_many_workers"] = _gathered(_raised(
        lambda: mk("self_k1").resume(
            os.path.join(ckdir, "self_k1", "chain1.npz"), n_workers=5)))
    plan = dataclasses.replace(tplan.plan_sweep(
        ANY_M, 581, backend="distributed", device="cpu"), n_bands=2)
    out["device_list"] = {
        "scheduler": _raised(lambda: AnytimeScheduler(ts, ANY_M,
                                                      ["cpu"] * 4,
                                                      **ANY_KW)),
        "round_executor": _raised(lambda: tplan.round_executor(plan,
                                                               ["cpu"]))}
    saved = distributed._pmax_group
    distributed._pmax_group = _own_index_pmax
    try:
        sch = mk("self_k1")
        out["planted"] = [any_dump(sch.step_round())
                          for _ in range(sch.plan.n_rounds)]
    finally:
        distributed._pmax_group = saved
    return out


def suite_one_rank(mesh):
    """A one-rank group: nothing is left unported, `round_executor` takes
    the mesh, and each case runs to its end."""
    from repro_torch.core import plan as tplan
    from repro_torch.core.scheduler import AnytimeScheduler

    plan = dataclasses.replace(tplan.plan_sweep(
        ANY_M, 581, backend="distributed", device="cpu"), n_bands=2)
    out = {"not_ported": dict(tplan._NOT_PORTED),
           "executor": callable(tplan.round_executor(plan, mesh)),
           "runs": {}}
    for case in ANY_CASES:
        sch = any_make(AnytimeScheduler, mesh, case)
        out["runs"][case] = any_dump(sch.run())
    return out


def reference_anytime(out_path):
    """The reference's scheduler on 4 forced host devices: every case round
    by round, and the group's first chain checkpoint resumed and run."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    from repro.core.scheduler import AnytimeScheduler
    from repro.launch.mesh import compat_mesh

    mesh = compat_mesh((4,), ("workers",))
    out = {"rounds": {}}
    for case in ANY_CASES:
        sch = any_make(AnytimeScheduler, mesh, case)
        out["rounds"][case] = [any_dump(sch.step_round())
                               for _ in range(sch.plan.n_rounds)]
    sch = any_make(AnytimeScheduler, mesh, "self_k1")
    sch.resume(os.path.join(os.environ["MESH_WORKER_TMP"], "anytime_ckpt",
                            "self_k1", "chain1.npz"))
    out["resumed"] = any_dump(sch.run())
    with open(out_path, "w") as f:
        json.dump(out, f)


def reference_flip(out_path):
    """The reference's flipped decode on 4 forced host devices, a 2 x 2
    (data, model) mesh, `make_ctx` with a ShapeSpec of global batch 1 (the
    batch replicated, `kv_seq` over "data"): FLIP_REF_CASES at f32 weights
    drawn from PRNGKey(0), written for the port's side
    (`flip_params_<arch>.npz`), the prefill's last-position logits and
    FLIP_STEPS teacher-forced decode steps into FLIP_SLOTS slots (the
    wrap case FLIP_WRAP_SLOTS), each step jitted with the rule table's
    shardings."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import configs
    from repro.configs.base import ShapeSpec
    from repro.launch import sharding as rsh
    from repro.launch.mesh import compat_mesh
    from repro.models import steps, transformer
    from repro.models.common import init_params
    from repro_torch.models import convert

    mesh = compat_mesh((2, 2), ("data", "model"))
    tmp = os.environ["MESH_WORKER_TMP"]
    out = {}
    for case in FLIP_REF_CASES:
        arch, _, tag = case.partition("|")
        slots = FLIP_WRAP_SLOTS if tag == "wrap" else FLIP_SLOTS
        name, _, var = arch.partition("/")
        cfg = variant(configs.get_smoke(name), var)
        params = jax.tree.map(lambda a: a.astype(jnp.float32), init_params(
            jax.random.PRNGKey(0), transformer.model_spec(cfg)))
        np.savez(os.path.join(tmp, f"flip_params_{arch}.npz"),
                 **_flat(jax.tree.map(np.asarray, params)))
        ctx = rsh.make_ctx(mesh, cfg, ShapeSpec("flip", slots, 1, "decode"))
        rules = ctx.rules
        psh = rsh.param_shardings(mesh, cfg, rules)
        params = jax.device_put(params, psh)
        tok = jnp.asarray(flip_tokens(cfg))
        bsh = NamedSharding(mesh, P(rules["batch"], None))
        pre = jax.jit(steps.make_prefill_step(cfg, ctx),
                      in_shardings=(psh, {"tokens": bsh}))
        lg, pc = pre(params, {"tokens": tok[:, :FLIP_PROMPT]})
        grown = _grown(cfg, convert.cache_from_reference(
            jax.tree.map(np.asarray, pc)), slots)
        cache = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                             convert.cache_to_reference(grown, cfg))
        csh = rsh.cache_shardings(mesh, cfg, 1, slots, rules)
        cache = jax.device_put(cache, csh)
        dec = jax.jit(steps.make_decode_step(cfg, ctx),
                      in_shardings=(psh, csh, {"tokens": bsh,
                                               "cache_len": None}))
        outs = []
        for t in range(FLIP_STEPS):
            at = FLIP_PROMPT + t
            lgd, cache = dec(params, cache, {"tokens": tok[:, at:at + 1],
                                             "cache_len": jnp.int32(at)})
            outs.append(np.asarray(lgd, np.float32))
        out[case] = {"prefill": np.asarray(lg, np.float32)[:, -1].tolist(),
                     "decode": np.concatenate(outs, axis=1).tolist(),
                     "kv_seq": rules["kv_seq"], "batch": rules["batch"]}
    with open(out_path, "w") as f:
        json.dump(out, f)


def reference_side(out_path, part):
    """The reference's side, in a process of its own with 4 forced host
    devices on a 2 x 2 (data, model) mesh: its MoE (`moe_ffn` under each
    rule set, and `_moe_local` unsharded) on the twin's inputs, and the
    collectives of each smoke config's compiled train-mode forward at
    (2, 16) tokens under TP rules, with the scanned layer body's
    collectives marked (XLA lists a while body once). The `anytime` part
    is `reference_anytime`'s."""
    if part == "anytime":
        return reference_anytime(out_path)
    if part == "flip":
        return reference_flip(out_path)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro import configs
    from repro.launch import sharding as rsh
    from repro.launch.mesh import compat_mesh
    from repro.launch.roofline import parse_collectives
    from repro.models import moe, transformer
    from repro.models.common import init_params

    mesh = compat_mesh((2, 2), ("data", "model"))
    out = {}
    cfg, flat, x = moe_inputs()
    p = {}
    for path, v in flat.items():
        node = p
        *head, last = path.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    xj = jnp.asarray(x)
    rcfg = configs.get_smoke("olmoe-1b-7b")
    ref, aux = moe._moe_local(rcfg, p, xj, None)
    out["moe"] = {"local": np.asarray(ref).tolist(), "aux_local": float(aux)}
    for name, rules in (MOE_RULES if part == "moe" else {}).items():
        ctx = moe.ShardCtx(mesh=mesh, dp=("data",), tp="model", rules=rules)
        o, a = jax.jit(lambda pp, xx: moe.moe_ffn(rcfg, pp, xx, ctx))(p, xj)
        out["moe"][name] = np.asarray(o).tolist()
        out["moe"][f"aux_{name}"] = float(a)
    out["trace"] = {}
    for arch in (TRACE_ARCHS if part == "trace" else []):
        name, _, var = arch.partition("/")
        c = variant(configs.get_smoke(name), var)
        ctx = rsh.make_ctx(mesh, c, None, layout="tp")
        psh = rsh.param_shardings(mesh, c, ctx.rules)
        params = init_params(jax.random.PRNGKey(0), transformer.model_spec(c))
        bsh = NamedSharding(mesh, P(ctx.rules["batch"], None))
        args = [params, jnp.zeros((2, 16), jnp.int32)]
        shard = [psh, bsh]
        if c.mrope_sections:
            args.append(jnp.zeros((3, 2, 16), jnp.int32))
            shard.append(NamedSharding(mesh, P(None, ctx.rules["batch"],
                                               None)))
        else:
            args.append(None)
            shard.append(None)
        if c.is_encdec:
            args.append(jnp.zeros((2, c.encoder_seq, c.d_model), c.dtype))
            shard.append(NamedSharding(mesh, P(ctx.rules["batch"], None,
                                               None)))
        else:
            args.append(None)
            shard.append(None)

        def f(pp, t, pos, fr, c=c, ctx=ctx):
            return transformer.forward(c, pp, t, mode="train", ctx=ctx,
                                       positions=pos, frames=fr)[0]

        txt = jax.jit(f, in_shardings=tuple(shard)).lower(*args).compile() \
            .as_text()
        lines = [ln for ln in txt.splitlines()
                 if any(k in ln for k in ("all-reduce", "all-gather",
                                          "reduce-scatter", "all-to-all",
                                          "collective-permute"))]
        in_body = []
        for ln in lines:
            one = parse_collectives(ln, 2)
            if one:
                in_body.append([one[0].kind, one[0].result_bytes,
                                one[0].wire_bytes, "while/body" in ln])
        out["trace"][arch] = {
            "collectives": in_body,
            "layer_groups": [len(c.layer_groups()[0]),
                             len(c.layer_groups()[1]),
                             c.layer_groups()[2]]}
    with open(out_path, "w") as f:
        json.dump(out, f)


def main():
    if sys.argv[1] == "reference":
        return reference_side(sys.argv[3], sys.argv[2])
    suite, rank, world, store, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)

    from repro_torch.launch.mesh import compat_mesh, start_fake_group

    if suite in FAKE_SUITES:
        start_fake_group(world)
        mesh = compat_mesh((2, 2), ("data", "model"))
    elif suite in ANY_SUITES:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=ANY_TIMEOUT_S))
        mesh = compat_mesh((world,), ("workers",), devices="cpu")
    else:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        mesh = compat_mesh((2, 2), ("data", "model"), devices="cpu")
    res = {"moe": suite_moe, "steps": suite_steps, "trace": suite_trace,
           "anytime": suite_anytime, "one_rank": suite_one_rank,
           "flip": suite_flip, "flip_dryrun": suite_flip_dryrun}[suite](mesh)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
