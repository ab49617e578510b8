"""Process groups and device meshes for the dist backend, on
``torch.distributed``.

One process per rank.  A mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` with named dimensions, ``("data", "model")`` or ``("pod",
"data", "model")``: the chains are split over the data dimensions, the
graph's columns over ``"model"`` (``runtime/dist_gibbs.py``).  Building a
mesh makes the process groups this rank belongs to, which only their
members take part in, so a rank a mesh leaves out need not build it.

The JAX package's ``compat_shard_map`` and ``auto_axis_types`` exist only
to cope with JAX versions; they have no counterpart here.  Nothing in this
module touches a device or a process group when it is imported.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["MP_AXIS", "init_distributed", "make_auto_mesh",
           "make_device_mesh", "make_production_mesh", "dp_axes",
           "mesh_coords", "mesh_group"]

MP_AXIS = "model"


def init_distributed(device=None) -> torch.device:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this rank's device.

    ``device`` is the card unless the caller names another one; on the card
    the rank's device is ``LOCAL_RANK`` modulo the cards present (so ranks
    beyond the card count share cards).  The device picks the backend:
    NCCL on the card, gloo on the CPU.  A process that has joined already
    keeps its group."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return dev


def make_device_mesh(shape: Sequence[int], axes: Tuple[str, ...],
                     ranks: Sequence[int], device_type: str = "cuda"):
    """A mesh of ``shape`` over the first ``prod(shape)`` of ``ranks``, or
    None on a rank it leaves out.  The elastic-restart path builds one over
    the surviving ranks, maybe several times: each group of the mesh is
    made by its members alone, once per set of ranks, so the ranks a mesh
    leaves out need not call this at all."""
    from torch.distributed.device_mesh import DeviceMesh
    need = int(np.prod(shape))
    if len(ranks) < need:
        raise ValueError(f"mesh shape {tuple(shape)} needs {need} devices, "
                         f"got {len(ranks)}")
    grid = torch.tensor(list(ranks[:need]), dtype=torch.int64).reshape(
        tuple(shape))
    here = (grid == dist.get_rank()).nonzero()
    if len(here) == 0:
        return None
    coord = here[0].tolist()
    groups = []
    for k in range(grid.ndim):        # this rank's line along each dimension
        line = list(coord)
        line[k] = slice(None)
        groups.append(_group(grid[tuple(line)].tolist()))
    return DeviceMesh.from_group(groups, device_type, mesh=grid,
                                 mesh_dim_names=tuple(axes))


# the groups made so far over a set of ranks, for the world they were made in
_GROUPS = {"world": None, "by_ranks": {}}


def _group(ranks: Sequence[int]):
    """The process group over ``ranks``: the world's when they are all of
    it, else one that only its members make (the first time they ask for
    it in this world; later meshes over the same ranks reuse it)."""
    world = dist.group.WORLD
    if _GROUPS["world"] is not world:     # a new world: forget the old one's
        _GROUPS.update(world=world, by_ranks={})
    key = tuple(sorted(int(r) for r in ranks))
    if len(key) == dist.get_world_size():
        return world
    if key not in _GROUPS["by_ranks"]:
        _GROUPS["by_ranks"][key] = dist.new_group(
            list(key), use_local_synchronization=True)
    return _GROUPS["by_ranks"][key]


def make_auto_mesh(shape: Sequence[int], axes: Tuple[str, ...],
                   device_type: str = "cuda"):
    """A mesh of ``shape`` over every rank of the world (its size must be
    the product of ``shape``)."""
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover the "
                         f"world of {world} ranks")
    return make_device_mesh(shape, axes, range(world), device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production layout, (16, 16) over ("data", "model") or (2, 16,
    16) over ("pod", "data", "model"); the world must hold that many
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_auto_mesh(shape, axes, device_type)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel dimensions of a mesh: ("pod", "data") or
    ("data",)."""
    return tuple(a for a in mesh.mesh_dim_names if a != MP_AXIS)


def mesh_coords(mesh) -> Tuple[int, int, int, int]:
    """This rank's place in ``mesh``: ``(dp_index, dp, mp_index, mp)``,
    the data-parallel dimensions flattened row-major.  Raises on a rank
    the mesh does not hold."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh.mesh.tolist()}")
    names = mesh.mesh_dim_names
    dp_index, dp = 0, 1
    for a in dp_axes(mesh):
        k = names.index(a)
        dp_index = dp_index * mesh.shape[k] + coord[k]
        dp *= mesh.shape[k]
    k = names.index(MP_AXIS)
    return dp_index, dp, coord[k], mesh.shape[k]


def mesh_group(mesh):
    """The process group over every rank of ``mesh``: the world's when the
    mesh covers it, else one its ranks alone make."""
    return _group(mesh.mesh.flatten().tolist())
