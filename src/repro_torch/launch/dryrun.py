"""Multi-pod dry-run: trace EVERY (arch x shape x mesh) cell's step once
over a fake process group — port of `repro.launch.dryrun`.

The reference lowers and compiles each step over 512 placeholder CPU
devices and reads XLA's memory and cost analyses. Here a fake group of
256 or 512 ranks lives in this process (rank 0; its collectives move
nothing), the parameters, optimizer state, batch and cache are `meta`
DTensors laid out by `launch.sharding`, and the step runs once, eagerly,
under one dispatch mode that sees what rank 0 computes on its shards
(ROADMAP.md §C (25)):

  flops     the FLOPs of each op on LOCAL shards (torch's FLOP formulas;
            the flash kernel's from `flash_flops`: during the trace the
            flash function is a shapes-only stand-in, `_MetaFlash`, whose
            backward is the port's plain backward), not DTensor's global
            count
  bytes     the sum of each op's local input and output bytes: an
            unfused upper bound (XLA's "bytes accessed" has no torch
            counterpart)
  wire      each functional collective as a `roofline.Collective` (kind,
            result bytes, group size) with the reference's ring formula;
            no HLO is parsed
  memory    arguments and outputs from the local shards, temporaries as
            the peak of bytes allocated during the step and alive at once
            (storages tracked until freed, autograd's saved ones too)

Eager torch counts every layer, so there are no per-layer sub-programs:
the one trace is split by region into `per_layer` (one entry per layer
kind, its per-layer cost and `repeat`) and `head` (embedding, final norm,
output head, loss, optimizer), with the reference's record keys. The
roofline terms use `RooflineTerms` at the H100's rates.

Per cell this writes artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json.
The fake group is started in `run_cell`, never at import.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--single-pod-only] [--force]
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.base import SHAPES, input_specs
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_production_mesh, start_fake_group
from repro_torch.launch.roofline import Collective, RooflineTerms
from repro_torch.models import steps, transformer
from repro_torch.optim import adamw
from repro_torch.utils import flops as flops_util

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")

TRAIN_MICROBATCHES = 8

# the functional collectives, by the reference's HLO names
_KINDS = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all"}


def _mesh_tag(multi_pod):
    return "multi" if multi_pod else "single"


def microbatches_for(layout: str) -> int:
    # weight-gathering layouts re-gather per microbatch
    return {"fsdp": 2, "zero3": 1}.get(layout, TRAIN_MICROBATCHES)


# ---------------------------------------------------------------------------
# the tally


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


class Tally(TorchDispatchMode):
    """FLOPs, bytes, collectives and live memory of what this rank runs,
    each cost charged to the current region (`region`), a backward op to
    the region whose forward made its autograd node (forward nodes are
    numbered in order, so each region's first number marks its span)."""

    def __init__(self):
        super().__init__()
        self.region = "head"
        self.costs: dict = {}
        self.marks: list = []          # (first autograd seq nr, region)
        self.live = 0
        self.peak = 0
        self._held: set = set()

    def _bucket(self) -> dict:
        name = self.region
        node = torch._C._current_autograd_node()
        if node is not None and self.marks:
            i = bisect.bisect_right(self.marks, (node._sequence_nr(), "~")) - 1
            name = self.marks[max(i, 0)][1]
        return self.costs.setdefault(name, {"flops": 0.0, "bytes": 0.0,
                                            "collectives": []})

    def charge(self, flops: float, nbytes: float) -> None:
        b = self._bucket()
        b["flops"] += flops
        b["bytes"] += nbytes

    def _alloc(self, t) -> None:
        st = _local(t).untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._held.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace if hasattr(func, "namespace") else ""
        name = func._overloadpacket.__name__
        b = self._bucket()
        if ns == "_c10d_functional" and name in _KINDS:
            from torch.distributed.distributed_c10d import (
                _resolve_process_group)

            group = _resolve_process_group(args[-1]).size()
            res = sum(_nbytes(t) for t in _tensors(out))
            b["collectives"].append(Collective(_KINDS[name], res, group))
        elif ns != "_c10d_functional":
            pk = func._overloadpacket
            dist = any(hasattr(t, "to_local") for t in _tensors(args))
            if pk in flop_registry and not dist:
                b["flops"] += float(flop_registry[pk](*args, **kwargs,
                                                      out_val=out))
            b["bytes"] += (sum(_nbytes(t) for t in _tensors(args))
                           + sum(_nbytes(t) for t in _tensors(out)))
        for t in _tensors(out):
            self._alloc(t)
        return out

    def enter(self, region: str) -> str:
        """Switch to `region`, marking the next autograd node number
        (read off a throwaway node; the mode sits below autograd)."""
        prev, self.region = self.region, region
        with torch.enable_grad():
            probe = torch.zeros((), device="meta", requires_grad=True) * 1
        self.marks.append((probe.grad_fn._sequence_nr(), region))
        return prev


def flash_flops(b: int, h: int, sq: int, sk: int, d: int,
                causal: bool) -> float:
    """The flash kernel's arithmetic: QK^T and PV, 2 FLOPs a
    multiply-add, over the (query, key) pairs the mask keeps."""
    pairs = sq * (sq + 1) / 2 if causal and sq == sk else sq * sk
    return 4.0 * b * h * pairs * d


class _MetaFlash(torch.autograd.Function):
    """The flash kernel over meta tensors: its output's shape, its FLOPs
    and bytes (q, k, v read, o written) charged to the tally; the
    backward is `_FlashFunction`'s, the plain one, traced op by op."""

    tally = None

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        b, h, s, d = q.shape
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
        _MetaFlash.tally.charge(flash_flops(b, h, s, k.shape[2], d, causal),
                                nbytes)
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import flash_attn

        q, k, v = ctx.saved_tensors
        return (*flash_attn.flash_attention_backward_plain(
            q, k, v, dout.contiguous(), ctx.causal), None)


def _meta_flash(q, k, v, *, bq=128, bk=128, causal=True):
    return _MetaFlash.apply(q, k, v, causal)


# ---------------------------------------------------------------------------
# the step


def _meta_batch(cfg, shape):
    """The step's inputs as meta tensors (a decode's `cache_len` as the
    last slot, a host integer)."""
    out = {}
    for k, (shp, dt) in input_specs(cfg, shape).items():
        out[k] = (shape.seq_len - 1 if k == "cache_len"
                  else torch.empty(shp, dtype=dt, device="meta"))
    return out


def build_full_step(cfg, shape, mesh, layout="tp"):
    """(step callable of no arguments, argument tensors, ctx) for one
    cell, every tensor a meta DTensor."""
    ctx = sh.make_ctx(mesh, cfg, shape, layout=layout)
    rules = ctx.rules
    model = transformer.Transformer(cfg, device="meta")
    sh.distribute_params(model, mesh, cfg, rules)
    batch = steps.shard_batch(cfg, ctx, _meta_batch(cfg, shape))
    if shape.kind == "train":
        state = adamw.init_state(model)
        step = steps.make_train_step(cfg, ctx, adamw.AdamWConfig(),
                                     microbatches=microbatches_for(layout))
        return (lambda: step(model, state, batch)), (model, state, batch), ctx
    if shape.kind == "prefill":
        step = steps.make_prefill_step(cfg, ctx)
        return (lambda: step(model, batch)), (model, batch), ctx
    cache = transformer.init_cache(cfg, model, shape.global_batch,
                                   shape.seq_len, ctx=ctx)
    step = steps.make_decode_step(cfg, ctx)
    return (lambda: step(model, cache, batch)), (model, cache, batch), ctx


@contextlib.contextmanager
def traced(tally: Tally, model=None):
    """`tally` active, each layer's costs charged to its region (the
    model's layers, and whisper's encoder layers, named by index), and
    the flash function a shapes-only stand-in (`_MetaFlash`)."""
    from repro_torch.kernels import flash_attn

    layer_of = {}
    if model is not None:
        layer_of = {id(layer): i for i, layer in enumerate(model["layers"])}
        enc = getattr(model, "enc", None)
        if enc is not None:
            layer_of.update({id(layer): f"enc{i}"
                             for i, layer in enumerate(enc.layers)})
    orig_apply, orig_flash = transformer.apply_layer, flash_attn.flash_attention

    def apply_layer(cfg_, ls, p, x, **kw):
        prev = tally.enter(f"layer:{layer_of.get(id(p))}")
        try:
            return orig_apply(cfg_, ls, p, x, **kw)
        finally:
            tally.enter(prev)

    transformer.apply_layer = apply_layer
    flash_attn.flash_attention = _meta_flash
    _MetaFlash.tally = tally
    try:
        with tally:
            yield tally
    finally:
        transformer.apply_layer = orig_apply
        flash_attn.flash_attention = orig_flash
        _MetaFlash.tally = None


def _layer_name(cfg, i):
    ls = cfg.layer_kind(i)
    return f"{ls.mixer}/{ls.ffn}" + ("+cross" if ls.cross else "")


def trace_step(cfg, shape, mesh, layout="tp"):
    """Trace one step: (tally, argument bytes, output bytes, alias bytes,
    seconds to build, seconds to trace)."""
    t0 = time.time()
    run, args, ctx = build_full_step(cfg, shape, mesh, layout)
    t_build = time.time() - t0
    arg_ids = {_local(t).untyped_storage()._cdata for t in _tensors(
        [list(args[0].parameters())] + list(args[1:]))}
    arg_bytes = sum(_nbytes(t) for t in _tensors(
        [list(args[0].parameters())] + list(args[1:])))
    tally = Tally()
    t0 = time.time()
    with traced(tally, args[0]):
        out = run()
    t_trace = time.time() - t0
    outs = list(_tensors(out))
    alias = sum(_nbytes(t) for t in outs
                if _local(t).untyped_storage()._cdata in arg_ids)
    out_bytes = sum(_nbytes(t) for t in outs)
    return tally, arg_bytes, out_bytes, alias, t_build, t_trace, ctx


def _split(cfg, tally) -> tuple[list, dict]:
    """(per_layer, head) from the tally's regions: one per_layer entry a
    layer kind (its mean cost per layer and `repeat`), the rest in head."""
    kinds: dict = {}
    head = {"flops": 0.0, "bytes": 0.0, "wire_bytes": 0.0,
            "collectives": 0}
    for region, c in tally.costs.items():
        wire = sum(x.wire_bytes for x in c["collectives"])
        if region.startswith("layer:"):
            i = region.split(":", 1)[1]
            name = ("enc:attn_bidir/gelu" if i.startswith("enc")
                    else _layer_name(cfg, int(i)))
            k = kinds.setdefault(name, {"name": name, "flops": 0.0,
                                        "bytes": 0.0, "wire_bytes": 0.0,
                                        "repeat": 0})
            k["flops"] += c["flops"]
            k["bytes"] += c["bytes"]
            k["wire_bytes"] += wire
            k["repeat"] += 1
        else:
            head["flops"] += c["flops"]
            head["bytes"] += c["bytes"]
            head["wire_bytes"] += wire
            head["collectives"] += len(c["collectives"])
    per_layer = []
    for k in kinds.values():
        r = k["repeat"]
        per_layer.append(dict(k, flops=k["flops"] / r, bytes=k["bytes"] / r,
                              wire_bytes=k["wire_bytes"] / r))
    return per_layer, head


# ---------------------------------------------------------------------------
# cell driver


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: str,
             *, layout: str = "tp", force: bool = False,
             skip_layers: bool = False, cfg=None, mesh=None) -> dict:
    """One cell's record. `cfg` and `mesh` stand in for the arch's config
    and the production mesh (a smoke config on a small fake mesh, in
    tests); without `mesh` the fake group of 256 or 512 ranks starts
    here."""
    os.makedirs(outdir, exist_ok=True)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    tag = f"{arch}__{shape_name}__{_mesh_tag(multi_pod)}"
    if layout != "tp":
        tag += f"__{layout}"
    path = os.path.join(outdir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            prev = json.load(f)
        if prev.get("ok") or prev.get("skipped"):
            return prev           # resume: only redo failed cells

    cfg = configs.get_config(arch) if cfg is None else cfg
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": _mesh_tag(multi_pod), "layout": layout}
    if shape_name in cfg.skip_shapes:
        rec["skipped"] = True
        rec["reason"] = ("full quadratic attention cannot run 500k-token "
                         "decode" if shape_name == "long_500k"
                         else "shape inapplicable")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    if mesh is None:
        start_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    try:
        tally, arg_b, out_b, alias_b, t_build, t_trace, ctx = trace_step(
            cfg, shape, mesh, layout)
        gb = 2 ** 30
        rec["memory"] = {"argument_gb": arg_b / gb, "output_gb": out_b / gb,
                         "temp_gb": tally.peak / gb, "code_gb": 0.0,
                         "alias_gb": alias_b / gb}
        colls = [c for v in tally.costs.values() for c in v["collectives"]]
        kinds: dict = {}
        for c in colls:
            kinds[c.kind] = kinds.get(c.kind, 0) + 1
        total = {"flops": sum(v["flops"] for v in tally.costs.values()),
                 "bytes": sum(v["bytes"] for v in tally.costs.values())}
        rec["cost_raw"] = total
        rec["collectives_raw"] = {
            "counts": kinds,
            "wire_bytes_static": sum(c.wire_bytes for c in colls)}
        rec["timings"] = {"lower_s": t_build, "compile_s": t_trace}
        per_layer, hd = _split(cfg, tally)
        if skip_layers:
            per_layer, hd = [], {"flops": 0.0, "bytes": 0.0,
                                 "wire_bytes": 0.0}
        rec["per_layer"] = per_layer
        rec["head"] = hd
        recon = {
            "flops_per_chip": total["flops"],
            "bytes_per_chip": total["bytes"],
            "wire_bytes_per_chip": rec["collectives_raw"][
                "wire_bytes_static"],
        }
        rec["reconstructed"] = recon
        mf = flops_util.model_flops(cfg, shape)
        rec["model_flops"] = mf
        terms = RooflineTerms(
            flops_per_chip=recon["flops_per_chip"],
            bytes_per_chip=recon["bytes_per_chip"],
            wire_bytes_per_chip=recon["wire_bytes_per_chip"],
            model_flops_total=mf["total"],
            n_chips=n_chips)
        rec["roofline"] = terms.to_dict()
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]

    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--layout", default="tp")
    ap.add_argument("--skip-layers", action="store_true",
                    help="totals only (no per-layer split)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    outdir = args.out or os.path.abspath(ARTIFACTS)

    archs = [args.arch] if args.arch else configs.list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    if args.all:
        archs = configs.list_archs()
        shapes = list(SHAPES)
    meshes = [False, True]
    if args.multi_pod:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only:
        meshes = [True]

    t00 = time.time()
    n_ok = n_skip = n_fail = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                t0 = time.time()
                rec = run_cell(arch, shape, mp, outdir, layout=args.layout,
                               force=args.force,
                               skip_layers=args.skip_layers)
                status = ("SKIP" if rec.get("skipped")
                          else "ok" if rec.get("ok") else "FAIL")
                if rec.get("skipped"):
                    n_skip += 1
                elif rec.get("ok"):
                    n_ok += 1
                else:
                    n_fail += 1
                print(f"[{time.time()-t00:7.1f}s] {arch:22s} {shape:12s} "
                      f"{_mesh_tag(mp):6s} {status:4s} ({time.time()-t0:5.1f}s)"
                      + (f"  {rec.get('error','')[:90]}" if status == "FAIL"
                         else ""), flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
