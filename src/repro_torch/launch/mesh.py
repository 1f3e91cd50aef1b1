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
import os

import torch
import torch.distributed as dist

from ..distributed.sharding import Mesh

__all__ = ["cli_mesh", "make_host_mesh", "make_production_mesh", "world_mesh"]


def world_mesh(shape: dict) -> Mesh:
    """A :class:`Mesh` of ``shape`` over the whole world, with the process
    groups of the model axis and of the data-parallel axes (every axis but
    ``model``), and where those are more than one (``pod``, ``data``) of
    each alone: FSDP gathers over ``data``, and its gradients are summed
    over ``pod``. A world of one needs no process group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape.values()) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape.values())} ranks, the world has "
                         f"{world}")
    mesh = Mesh(dict(shape), dist.get_rank() if dist.is_initialized() else 0)
    names = tuple(shape)
    dp = tuple(a for a in names if a != "model")
    groups = {}
    for axes in (("model",), dp) + (tuple((a,) for a in dp) if len(dp) > 1 else ()):
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
    return world_mesh(shape)


def make_host_mesh(data: int = 4, model: int = 2) -> Mesh:
    """A (data, model) mesh over the world's ``data · model`` ranks: gloo on
    the CPU or for ranks that share one card, NCCL with one rank a card."""
    return world_mesh({"data": data, "model": model})


def cli_mesh(spec: str, dev: torch.device, batch: int) -> Mesh:
    """The (data, model) mesh of a CLI's ``--mesh d x m`` (``""``: the world
    by 1) over the default process group: one made from the environment
    when ``torchrun`` started more than one rank (NCCL on the card, one rank
    a card; gloo on the CPU), else the one the caller made (gloo ranks
    sharing one card), else a world of one. Raises unless ``d · m`` is the
    world and ``batch`` splits over the data axis."""
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    world = dist.get_world_size() if dist.is_initialized() else 1
    d, m = (int(x) for x in (spec or f"{world}x1").split("x"))
    if d * m != world:
        raise ValueError(f"--mesh {spec}: data axis {d} x model axis {m} != the process "
                         f"group's {world} ranks (one process runs only 1x1)")
    if batch % d:
        raise ValueError(f"--batch {batch} does not split over data axis {d}")
    return make_host_mesh(d, m)
