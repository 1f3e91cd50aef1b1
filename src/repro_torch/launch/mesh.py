"""Mesh construction over the ``torch.distributed`` world (counterpart of
``repro/launch/mesh.py``).

A mesh's ranks are the world's, the last axis varying fastest, as
``jax.make_mesh`` orders devices: rank ``r`` of a (data, model) mesh sits at
``(r // model, r % model)``. Every rank must call the same function with the
same shape (each new process group is made by all ranks, in one order).
"""

from __future__ import annotations

import itertools
import math

import torch.distributed as dist

from ..distributed.sharding import Mesh

__all__ = ["make_host_mesh", "make_production_mesh"]


def _world_mesh(shape: dict) -> Mesh:
    """A :class:`Mesh` of ``shape`` over the whole world, with the process
    groups of the model axis and of the data-parallel axes (every axis but
    ``model``); a world of one needs no process group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape.values()) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape.values())} ranks, the world has "
                         f"{world}")
    mesh = Mesh(dict(shape), dist.get_rank() if dist.is_initialized() else 0)
    names = tuple(shape)
    groups = {}
    for axes in (("model",), tuple(a for a in names if a != "model")):
        if mesh.axis_size(axes) == 1:
            continue
        rest = [a for a in names if a not in axes]
        for fixed in itertools.product(*(range(shape[a]) for a in rest)):
            at = dict(zip(rest, fixed))
            ranks = []
            for along in itertools.product(*(range(shape[a]) for a in axes)):
                at.update(zip(axes, along))
                r = 0
                for a in names:
                    r = r * shape[a] + at[a]
                ranks.append(r)
            group = dist.new_group(ranks)
            if mesh.rank in ranks:
                groups[axes] = group
    return Mesh(mesh.shape, mesh.rank, groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 ranks (data, model); 2×16×16 = 512 multi-pod (pod, data,
    model). Raises unless the world has that many ranks."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    return _world_mesh(shape)


def make_host_mesh(data: int = 4, model: int = 2) -> Mesh:
    """A (data, model) mesh over the world's ``data · model`` ranks: gloo on
    the CPU or for ranks that share one card, NCCL with one rank a card."""
    return _world_mesh({"data": data, "model": model})
