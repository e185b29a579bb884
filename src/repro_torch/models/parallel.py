"""Tensor parallelism by hand inside `local_map` — the port's counterpart of
GSPMD's propagation and the reference's `shard_map` (ROADMAP.md §C (25)).

A step with a `ShardCtx` keeps its parameters, caches and activations as
DTensors whose placements come from the rule tables
(`launch.sharding`). Each layer (and the embedding, the head and the
loss) runs as ONE `local_map`: the parameters enter in their compute
placements (`compute_placements`: a leaf keeps its model-axis shard
where the block's local code can use it, and is redistributed to
replicated elsewhere — the per-use weight gather of the fsdp and zero3
layouts, and MLA's moved weights), the block computes on local shards
with the ctx=None code, and `Local` applies Megatron's collectives over
the model dim's group:

  enter  identity forward, all-reduce of the gradient backward (f); with
         a sequence-parallel residual, an all-gather over the sequence
  exit   all-reduce of the partial output forward, identity backward (g);
         with a sequence-parallel residual, a reduce-scatter

so a dense TP layer issues one all-reduce after the attention's output
projection and one after the FFN's, and no weight all-gather. Replicated
leaves of a sharded block pass through `enter` too (`local_param`): each
rank's gradient of them is a partial sum, and the all-reduce makes it
whole, so every gradient leaves `local_map` in its parameter's placement
on the model dim, and as a partial sum on the dims that shard the batch.
Where a column shard cuts a head (heads that the model dim does not
divide), a rank fetches the columns of the heads it computes from the
ranks that hold them (`Local.exchange`, one all-to-all of activations).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.distributed._functional_collectives as fc

# ---------------------------------------------------------------------------
# collectives with the gradients of Megatron's operators


def _wait(x):
    return fc.wait_tensor(x) if isinstance(x, torch.Tensor) else x


def _all_reduce(x, group, op="sum"):
    return _wait(fc.all_reduce(x.contiguous(), op, group))


def _all_gather(x, dim, group):
    x = x.movedim(dim, 0).contiguous()
    return _wait(fc.all_gather_tensor(x, 0, group)).movedim(0, dim)


def _reduce_scatter(x, dim, group):
    x = x.movedim(dim, 0).contiguous()
    return _wait(fc.reduce_scatter_tensor(x, "sum", 0, group)).movedim(0, dim)


class _Copy(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce forward; backward identity (`both`: all-reduce too, for
    a sum that partial computations read on)."""

    @staticmethod
    def forward(ctx, x, group, both):
        ctx.group, ctx.both = group, both
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.group) if ctx.both else g), None, None


class _Gather(torch.autograd.Function):
    """All-gather along `dim` forward. Backward: a reduce-scatter where
    partial computations read the gathered tensor (`partial`), else the
    rank's own slice of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group, partial):
        ctx.dim, ctx.group, ctx.partial = dim, group, partial
        ctx.n = x.shape[dim]
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        rank = ctx.group[0].get_local_rank(ctx.group[1])
        return (g.narrow(ctx.dim, rank * ctx.n, ctx.n), None, None, None)


class _Scatter(torch.autograd.Function):
    """Reduce-scatter of a partial sum along `dim`; all-gather backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


@functools.lru_cache(maxsize=256)
def _exchange_plan(src, dst, rank: int):
    """For `_Exchange` (src and dst tuples of tuples): where each of this
    rank's wanted columns comes from. Returns (local: (out index, t
    index) pairs, send: per receiver the t indices this rank sends, recv:
    per sender the out indices it fills, in the order sent)."""
    n = len(src)
    pos = [{c: i for i, c in enumerate(s)} for s in src]

    def owner(c):
        return next(q for q in range(n) if c in pos[q])

    local, recv = [], [[] for _ in range(n)]
    for i, c in enumerate(dst[rank]):
        if c in pos[rank]:
            local.append((i, pos[rank][c]))
        else:
            recv[owner(c)].append(i)
    send = [[] for _ in range(n)]
    for r in range(n):
        if r == rank:
            continue
        for c in dst[r]:
            if c not in pos[r] and owner(c) == rank:
                send[r].append(pos[rank][c])
    return tuple(local), tuple(map(tuple, send)), tuple(map(tuple, recv))


def _a2a(x, send_sizes, recv_sizes, group):
    return _wait(fc.all_to_all_single(x.contiguous(), recv_sizes, send_sizes,
                                      group))


class _Exchange(torch.autograd.Function):
    """Columns (the last dim) from the ranks that hold them: rank q holds
    the global columns src[q], in t's order; rank r receives dst[r], in
    that order. A column the rank holds is taken locally; any other comes
    from the first rank holding it, all in one all-to-all. Backward: the
    gradients go back the same way and are summed into t."""

    @staticmethod
    def forward(ctx, t, src, dst, rank, group):
        local, send, recv = _exchange_plan(
            tuple(map(tuple, src)), tuple(map(tuple, dst)), rank)
        dev = t.device
        x = t.movedim(-1, 0)
        out = x.new_empty((len(dst[rank]), *x.shape[1:]))
        li = torch.tensor([i for i, _ in local], dtype=torch.long, device=dev)
        lp = torch.tensor([j for _, j in local], dtype=torch.long, device=dev)
        out.index_copy_(0, li, x.index_select(0, lp))
        si = torch.tensor([j for part in send for j in part], dtype=torch.long,
                          device=dev)
        ri = torch.tensor([i for part in recv for i in part], dtype=torch.long,
                          device=dev)
        ss, rs = [len(part) for part in send], [len(part) for part in recv]
        got = _a2a(x.index_select(0, si), ss, rs, group)
        out.index_copy_(0, ri, got)
        ctx.save_for_backward(li, lp, si, ri)
        ctx.sizes, ctx.group, ctx.n = (ss, rs), group, x.shape[0]
        return out.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        li, lp, si, ri = ctx.saved_tensors
        ss, rs = ctx.sizes
        g = g.movedim(-1, 0)
        gx = g.new_zeros((ctx.n, *g.shape[1:]))
        gx.index_add_(0, lp, g.index_select(0, li))
        back = _a2a(g.index_select(0, ri), rs, ss, ctx.group)
        gx.index_add_(0, si, back)
        return gx.movedim(0, -1), None, None, None, None


class _Mean(torch.autograd.Function):
    """Mean over the given groups forward; the gradient over their size
    backward (the value is replicated, each rank's input one term)."""

    @staticmethod
    def forward(ctx, x, groups):
        n = 1
        for grp in groups:
            x = _all_reduce(x, grp, "avg")
            n *= grp[0].size(grp[1])
        ctx.n = n
        return x

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


# ---------------------------------------------------------------------------
# the local view


@dataclasses.dataclass(frozen=True)
class Local:
    """What a block sees of the mesh inside `local_map`: the model dim's
    group, its size and this rank's coordinate on it, the mesh dims that
    shard the batch, whether the residual is sharded on the sequence over
    the model dim (`seq`), whether the block at hand computes sharded
    (`sharded`), each cache leaf's dim sharded over the model dim, and
    whether an MoE block splits its expert bank (`ep`)."""
    mesh: Any
    tp_dim: int | None
    batch_dims: tuple[int, ...] = ()
    seq: bool = False
    sharded: bool = False
    cache_dims: Any = None
    ep: bool = False

    @property
    def group(self):
        return (self.mesh, self.tp_dim)

    @property
    def tp(self) -> int:
        return 1 if self.tp_dim is None else self.mesh.size(self.tp_dim)

    @property
    def rank(self) -> int:
        return (0 if self.tp_dim is None
                else self.mesh.get_local_rank(self.tp_dim))

    def block(self, sharded: bool) -> "Local":
        return dataclasses.replace(self, sharded=sharded)

    # -- Megatron's operators -------------------------------------------

    def enter(self, h):
        """A sharded block's input: f, or the all-gather of a sequence
        shard."""
        if self.seq:
            return _Gather.apply(h, 1, self.group, True)
        if self.sharded:
            return _Copy.apply(h, self.group)
        return h

    def exit(self, y):
        """A sharded block's partial output, summed (or reduce-scattered
        onto the sequence shard)."""
        if self.seq:
            if self.sharded:
                return _Scatter.apply(y, 1, self.group)
            return self.take(y, 1)
        if self.sharded:
            return _Reduce.apply(y, self.group, False)
        return y

    def local_param(self, w):
        """A replicated leaf read inside a sharded block (or, with a
        sequence-parallel residual, a norm's weight)."""
        return _Copy.apply(w, self.group) if self.tp_dim is not None else w

    def reduce(self, y, *, both: bool = False):
        return _Reduce.apply(y, self.group, both)

    def gather(self, x, dim, *, partial: bool = True):
        return _Gather.apply(x, dim, self.group, partial)

    def exchange(self, x, src, dst):
        """The columns dst[rank] of x's last dim, rank q holding src[q]
        (`_Exchange`)."""
        return _Exchange.apply(x, src, dst, self.rank, self.group)

    def scatter(self, x, dim):
        return _Scatter.apply(x, dim, self.group)

    def grad_scale(self, x, s: float):
        return _GradScale.apply(x, s)

    def batch_mean(self, x):
        """The mean of a per-shard scalar over the dims sharding the
        batch (the reference's `pmean` over its batch axes)."""
        if not self.batch_dims:
            return x
        return _Mean.apply(x, [(self.mesh, d) for d in self.batch_dims])

    def take(self, x, dim: int):
        """This rank's slice of a replicated tensor along `dim`."""
        n = x.shape[dim] // self.tp
        return x.narrow(dim, self.rank * n, n)


# ---------------------------------------------------------------------------
# placements


def _mesh_dim(mesh, axis) -> int:
    return list(mesh.mesh_dim_names).index(axis)


def batch_dims(ctx) -> tuple[int, ...]:
    """Mesh dims that shard the batch, in mesh order."""
    b = (ctx.rules or {}).get("batch", ctx.dp)
    names = () if b is None else (b if isinstance(b, tuple) else (b,))
    return tuple(sorted(_mesh_dim(ctx.mesh, a) for a in names if a))


def tp_dim(ctx) -> int | None:
    """The model dim's index, None where it shards the batch (zero3)."""
    if ctx.tp not in ctx.mesh.mesh_dim_names:
        return None
    d = _mesh_dim(ctx.mesh, ctx.tp)
    return None if d in batch_dims(ctx) else d


def local_view(ctx, *, seq: bool = False, cache_dims=None) -> Local:
    return Local(mesh=ctx.mesh, tp_dim=tp_dim(ctx), batch_dims=batch_dims(ctx),
                 seq=seq, cache_dims=cache_dims)


def activation_placements(ctx, *, batch_dim: int = 0, seq_dim=None) -> tuple:
    """An activation's placements: its batch dim over the batch's mesh
    dims, its sequence dim (where given) over the model dim."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {d: batch_dim for d in batch_dims(ctx)}
    if seq_dim is not None and tp_dim(ctx) is not None:
        dims[tp_dim(ctx)] = seq_dim
    return tuple(Shard(dims[i]) if i in dims else Replicate()
                 for i in range(ctx.mesh.ndim))


def compute_placements(ctx, stored: tuple, keep) -> tuple:
    """A leaf's placements inside a block: its shard on the model dim
    where that is tensor dim `keep`, replicated on every other mesh dim.
    `keep` = (dim, True) moves a model-dim shard stored on another dim
    onto `dim` (an all-to-all: MLA's up-projections, stored split on the
    latent r, computed on heads)."""
    from torch.distributed.tensor import Replicate, Shard

    t = tp_dim(ctx)
    move = isinstance(keep, tuple)
    keep = keep[0] if move else keep
    out = []
    for i, pl in enumerate(stored):
        if (i == t and keep is not None and isinstance(pl, Shard)
                and (pl.dim == keep or move)):
            out.append(Shard(keep))
        else:
            out.append(Replicate())
    return tuple(out)


def grad_placements(ctx, computed: tuple) -> tuple:
    """A leaf's gradient inside a block: as computed on the model dim (the
    `enter` of replicated leaves made it whole), a partial sum on the dims
    that shard the batch."""
    from torch.distributed.tensor import Partial, Replicate

    bd = batch_dims(ctx)
    return tuple(Partial() if (i in bd and isinstance(pl, Replicate)) else pl
                 for i, pl in enumerate(computed))


def is_sharded(ctx, pls) -> bool:
    from torch.distributed.tensor import Shard

    t = tp_dim(ctx)
    return t is not None and isinstance(pls[t], Shard)


# ---------------------------------------------------------------------------
# local_map over a parameter tree


def _flat(tree, prefix=""):
    """(dotted path, leaf) pairs of a dict or `ParamTree`, in order."""
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = list(tree._parameters.items()) + list(tree._modules.items())
    for key, val in items:
        path = f"{prefix}{key}"
        if isinstance(val, torch.Tensor):
            yield path, val
        elif val is not None:
            yield from _flat(val, path + ".")


def prepare_params(ctx, params, tp_dims: dict):
    """(paths, leaves in their compute placements, in-placements,
    gradient placements, replicated-on-the-model-dim flags) of a
    parameter tree of DTensors; a leaf whose stored placements differ
    from its compute placements is redistributed here (a gather)."""
    paths, leaves, pin, pgrad, rep = [], [], [], [], []
    for path, leaf in _flat(params):
        comp = compute_placements(ctx, leaf.placements, tp_dims.get(path))
        if comp != tuple(leaf.placements):
            leaf = leaf.redistribute(placements=comp)
        paths.append(path)
        leaves.append(leaf)
        pin.append(comp)
        pgrad.append(grad_placements(ctx, comp))
        rep.append(not is_sharded(ctx, comp))
    return paths, leaves, pin, pgrad, rep


def nest(paths, leaves) -> dict:
    out: dict = {}
    for path, val in zip(paths, leaves):
        *head, last = path.split(".")
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[last] = val
    return out


def placements_of(x):
    from torch.distributed.tensor import DTensor

    return tuple(x.placements) if isinstance(x, DTensor) else None


def run_block(ctx, fn, params, tp_dims: dict, *acts):
    """`fn(lc, local params, *local acts)` -> (out like acts[0], aux
    scalar) under `local_map`: parameters in their compute placements,
    replicated leaves of a sharded block entered (`Local.local_param`),
    the output in acts[0]'s placements and the scalar replicated."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    paths, leaves, pin, pgrad, rep = prepare_params(ctx, params, tp_dims)
    sharded = not all(rep)
    lc = local_view(ctx).block(sharded)
    n = len(leaves)

    def body(*flat):
        ps = [lc.local_param(t) if (r and sharded) else t
              for t, r in zip(flat[:n], rep)]
        return fn(lc, nest(paths, ps), *flat[n:])

    act_pl = [placements_of(a) for a in acts]
    rep_all = tuple(Replicate() for _ in range(ctx.mesh.ndim))
    return local_map(body, out_placements=(act_pl[0], rep_all),
                     in_placements=tuple(pin) + tuple(act_pl),
                     in_grad_placements=tuple(pgrad) + tuple(act_pl),
                     device_mesh=ctx.mesh)(*leaves, *acts)
