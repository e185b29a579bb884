"""Mesh builders — port of `repro.launch.mesh` on `torch.distributed`.

A mesh is a `DeviceMesh` with `mesh_dim_names`, over the default process
group, which must hold exactly as many ranks as the mesh: a mismatch
raises, it never builds a smaller mesh. Where no group is up yet,
`compat_mesh` starts one from the environment `torchrun` sets (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT), NCCL on the card and gloo on the
CPU, or else a one-rank group (an in-process store, no port). The
dry-run starts a fake group of 256 or 512 ranks in one process
(`start_fake_group`) before it builds its meshes; tests start gloo
groups with a `FileStore`. Nothing here runs at import.

`devices` names the device type: None is the card (or the CPU under a
gloo or fake group), "cpu" and "meta" ask for the host (a meta tensor
lives on a CPU mesh). The reference's JAX-version branches have no
counterpart.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist


def _device_type(devices) -> str:
    if devices is not None:
        kind = torch.device(devices).type
        return "cpu" if kind == "meta" else kind
    if dist.is_initialized() and dist.get_backend() != "nccl":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh on the card needs CUDA; pass "
                           "devices='cpu' to build one on the host")
    return "cuda"


def init_group(world_size: int, device_type: str) -> None:
    """The default process group: from torchrun's environment where it is
    set, else one rank in this process. Raises when a group is up with
    another size."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise ValueError(f"the default group holds "
                             f"{dist.get_world_size()} ranks, the mesh "
                             f"{world_size}")
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    elif world_size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        raise ValueError(f"a mesh of {world_size} ranks needs a group of "
                         "that size: run under torchrun or start one")
    if dist.get_world_size() != world_size:
        raise ValueError(f"the group holds {dist.get_world_size()} ranks, "
                         f"the mesh {world_size}")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)


def start_fake_group(world_size: int) -> None:
    """A fake group of `world_size` ranks in this process (rank 0): its
    collectives move nothing, for tracing a step over meta tensors."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def compat_mesh(shape, axes, devices=None):
    """A `DeviceMesh` of `shape` named `axes` over the default group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ")
    kind = _device_type(devices)
    init_group(math.prod(shape), kind)
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_mesh(shape, axes)


def make_worker_mesh(n: int | None = None, axis: str = "workers"):
    """1-D mesh over the group's ranks (all of them by default, one where
    no group is up)."""
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    return compat_mesh((n,), (axis,))


def dp_axes(mesh) -> tuple[str, ...]:
    names = tuple(getattr(mesh, "mesh_dim_names", None)
                  or getattr(mesh, "axis_names", ()) or mesh.shape)
    return tuple(a for a in ("pod", "data") if a in names)
