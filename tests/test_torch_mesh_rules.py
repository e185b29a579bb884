"""The port's rule tables and sanitizer (`repro_torch.models.common`,
`repro_torch.launch.sharding`) against the reference's, on stub meshes
(a `shape` dict and `axis_names`), so no 256 devices are needed: the
tables themselves, `sanitize_pspec` over a grid of shapes and meshes
(tuple axes and the reference's own five cases included), and for every
arch x layout x {single, multi}-pod mesh x shape, `make_rules`,
`make_ctx` and the sanitized parameter and cache specs, the port's
per-layer leaves against the reference's stacked ones less their
`layers` entry (whose rule is None)."""

import itertools

import pytest

from repro import configs as rconfigs
from repro.configs.base import SHAPES as RSHAPES
from repro.launch import sharding as rsh
from repro.models import common as rcommon
from repro.models import transformer as rtransformer
from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import sharding as sh
from repro_torch.models import common, transformer

LAYOUTS = ("tp", "fsdp", "mixer_dp", "ep", "zero3")


class StubMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


SINGLE = StubMesh(data=16, model=16)
MULTI = StubMesh(pod=2, data=16, model=16)


def _t(ps):
    return tuple(ps)


def test_rule_tables_are_the_reference_s():
    assert common.TP_RULES == rcommon.TP_RULES
    assert common.FSDP_RULES == rcommon.FSDP_RULES
    assert common.EP_RULES == rcommon.EP_RULES


def test_sanitize_reference_cases():
    fm = StubMesh(model=16, data=4)
    P = common.P
    assert common.sanitize_pspec((40, 64), P("model", None), fm) == (None,
                                                                      None)
    assert common.sanitize_pspec((64, 32), P("model", None), fm) == (
        "model", None)
    assert common.sanitize_pspec((64, 64), P("model", "model"), fm) == (
        "model", None)
    assert common.sanitize_pspec((64,), P(("data", "model")), fm) == (
        ("data", "model"),)
    assert common.sanitize_pspec((40,), P(("data", "model")), fm) == (None,)


def test_sanitize_grid_matches_reference():
    from jax.sharding import PartitionSpec as RP

    meshes = [StubMesh(data=2, model=2), StubMesh(data=16, model=16),
              StubMesh(pod=2, data=16, model=16), StubMesh(model=3, data=4)]
    entries = [None, "model", "data", ("data", "model"), ("pod", "data")]
    dims = [1, 2, 3, 4, 6, 8, 12, 16, 40, 64, 96, 512]
    n = 0
    for mesh in meshes:
        ok = [e for e in entries
              if e is None or all(a in mesh.shape for a in (
                  e if isinstance(e, tuple) else (e,)))]
        for shape in itertools.product(dims[::3], dims[1::4]):
            for spec in itertools.product(ok, repeat=2):
                want = rcommon.sanitize_pspec(shape, RP(*spec), mesh)
                got = common.sanitize_pspec(shape, common.P(*spec), mesh)
                assert got == tuple(want), (shape, spec, mesh.shape)
                n += 1
    assert n > 500


def test_placements_shard_tuple_axes_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    class M:
        mesh_dim_names = ("pod", "data", "model")
    pl = common.placements(M(), common.P(("pod", "data"), None, "model"))
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert common.placements(M(), common.P()) == (Replicate(),) * 3


def test_tree_shapes_are_meta():
    spec = transformer.model_spec(configs.get_smoke("llama3-8b"))
    shapes = common.tree_shapes(spec)
    t = shapes["layers"]["0"]["mixer"]["wq"]["w"]
    assert t.device.type == "meta"
    assert tuple(t.shape) == spec["layers"]["0"]["mixer"]["wq"]["w"].shape


def _ref_layer(cfg, ref_tree, i):
    """The reference's subtree of decoder layer i, and whether its leaves
    carry the stacked `layers` entry first."""
    prefix, period, _ = cfg.layer_groups()
    if i < len(prefix):
        return ref_tree["prefix"][str(i)], False
    return ref_tree["period"][str((i - len(prefix)) % len(period))], True


def _pairs(port, ref, stacked, path=""):
    for k, v in port.items():
        if isinstance(v, dict):
            yield from _pairs(v, ref[k], stacked, f"{path}{k}.")
        else:
            r = tuple(ref[k])
            yield f"{path}{k}", _t(v), (r[1:] if stacked else r)


def _check_tree(cfg, port_tree, ref_tree):
    n = 0
    for k in ("emb", "ln_f", "pos_emb"):
        if k in port_tree:
            for path, a, b in _pairs({k: port_tree[k]}, {k: ref_tree[k]},
                                     False):
                assert a == b, path
                n += 1
    for i in range(cfg.n_layers):
        ref, stacked = _ref_layer(cfg, ref_tree, i)
        for path, a, b in _pairs(port_tree["layers"][str(i)], ref, stacked):
            assert a == b, (i, path)
            n += 1
    if "enc" in port_tree:
        for i in range(cfg.encoder_layers):
            for path, a, b in _pairs(port_tree["enc"]["layers"][str(i)],
                                     ref_tree["enc"]["blk"], True):
                assert a == b, ("enc", i, path)
                n += 1
    return n


def _check_caches(cfg, port_list, ref_tree):
    n = 0
    for i, layer in enumerate(port_list):
        ref, stacked = _ref_layer(cfg, ref_tree, i)
        for path, a, b in _pairs(layer, ref, stacked):
            assert a == b, (i, path)
            n += 1
    return n


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", configs.list_archs())
def test_rules_and_specs_match_reference(arch, mesh_name):
    mesh = SINGLE if mesh_name == "single" else MULTI
    cfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
    n = 0
    for layout in LAYOUTS:
        for shape in [None, *SHAPES]:
            s, rs = ((SHAPES[shape], RSHAPES[shape]) if shape
                     else (None, None))
            rules = sh.make_rules(mesh, cfg, s, layout=layout)
            rrules = rsh.make_rules(mesh, rcfg, rs, layout=layout)
            assert rules == rrules, (layout, shape)
            if shape is None:
                continue
            ps = common.sanitized_pspecs(transformer.model_spec(cfg), rules,
                                         mesh)
            rps = rcommon.sanitized_pspecs(rtransformer.model_spec(rcfg),
                                           rrules, mesh)
            n += _check_tree(cfg, ps, rps)
            b, sl = s.global_batch, s.seq_len
            cps = [common.sanitized_pspecs(c, rules, mesh)
                   for c in transformer.cache_spec(cfg, b, sl)]
            rcps = rcommon.sanitized_pspecs(
                rtransformer.cache_spec(rcfg, b, sl), rrules, mesh)
            n += _check_caches(cfg, cps, rcps)
    for layout in ("tp", "sp", "ep", "zero3"):
        ctx = sh.make_ctx(mesh, cfg, None, layout=layout)
        rctx = rsh.make_ctx(mesh, rcfg, None, layout=layout)
        assert ctx.rules == rctx.rules
        assert (ctx.dp, ctx.tp, ctx.sp_residual) == (rctx.dp, rctx.tp,
                                                     rctx.sp_residual)
        assert (None if ctx.residual_spec is None
                else _t(ctx.residual_spec)) == (
            None if rctx.residual_spec is None else _t(rctx.residual_spec))
    assert n > 100


def test_step_shardings_follow_the_rules():
    """`param_shardings`, `batch_shardings` and `cache_shardings` hold the
    sanitized specs; `logits_pspec` drops vocab where the batch takes the
    model axis (zero3)."""
    from repro_torch.models import steps

    cfg = configs.get_config("llama3-8b")
    rules = sh.make_rules(SINGLE, cfg, SHAPES["decode_32k"])
    psh = sh.param_shardings(SINGLE, cfg, rules)
    assert _t(psh["emb"].spec) == ("model", None)
    assert _t(psh["layers"]["0"]["mixer"]["wk"]["w"].spec) == (None, "model")
    csh = sh.cache_shardings(SINGLE, cfg, 128, 32768, rules)
    # 8 KV heads do not divide 16: the head dim takes the model axis
    assert _t(csh[0]["k"].spec) == ("data", None, None, "model")
    bsh = sh.batch_shardings(SINGLE, cfg, SHAPES["decode_32k"], rules,
                             {"tokens": 0, "cache_len": 0})
    assert _t(bsh["tokens"].spec) == ("data", None)
    assert _t(bsh["cache_len"].spec) == ()
    ctx = sh.make_ctx(SINGLE, cfg, None, layout="zero3")
    assert _t(steps.logits_pspec(ctx))[2] is None
    assert _t(steps.logits_pspec(sh.make_ctx(SINGLE, cfg)))[2] == "model"
