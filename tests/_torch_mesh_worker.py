"""One rank of the port's multi-rank CPU checks: run as

    python tests/_torch_mesh_worker.py SUITE RANK WORLD STORE OUT

with a gloo group over a `FileStore` (no TCP port), or, for the `trace`
suite, alone over a fake 4-rank group. Rank 0 writes the suite's results
to OUT as JSON. The test files (`test_torch_mesh_*.py`) start the ranks
and read the results; the reference's side runs in its own subprocess
there (`reference_side`).
"""

import json
import os
import sys
import warnings

import numpy as np

warnings.filterwarnings("ignore")

STEP_ARCHS = ["llama3-8b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
              "minicpm3-4b", "rwkv6-3b", "jamba-v0.1-52b",
              "whisper-large-v3", "qwen2-vl-2b"]
# (arch, layout): tp for every family, ep for olmoe, sp for llama3-8b,
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
                 ("minicpm3-4b/h3", "tp"), ("deepseek-v2-lite-16b/h3", "tp")])
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


def reference_side(out_path, part):
    """The reference's side, in a process of its own with 4 forced host
    devices on a 2 x 2 (data, model) mesh: its MoE (`moe_ffn` under each
    rule set, and `_moe_local` unsharded) on the twin's inputs, and the
    collectives of each smoke config's compiled train-mode forward at
    (2, 16) tokens under TP rules, with the scanned layer body's
    collectives marked (XLA lists a while body once)."""
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

    if suite == "trace":
        start_fake_group(world)
        mesh = compat_mesh((2, 2), ("data", "model"))
    else:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        mesh = compat_mesh((2, 2), ("data", "model"), devices="cpu")
    res = {"moe": suite_moe, "steps": suite_steps,
           "trace": suite_trace}[suite](mesh)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
