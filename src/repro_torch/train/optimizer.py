"""AdamW with cosine schedule, global-norm clipping, dtype policy
(counterpart of ``repro/train/optimizer.py``).

Hand-rolled, as the reference (no ``torch.optim``), so the arithmetic is
the reference's line for line: moments in ``moments_dtype`` (fp32 by
default), the update in fp32, written back in the parameter's dtype;
``master=True`` keeps an fp32 master copy that the update reads and writes.

A tree here is a dict of tensors by name (``named_parameters()`` of a
:class:`~repro_torch.models.Transformer`, or any dict, as the tests'); a
module passed as ``params`` stands for its named parameters. Where the
reference returns new trees, :func:`adamw_update` writes the new
parameters into the parameter tensors and the moments into their tensors,
in place, so a step at full width holds one copy of each.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["OptimizerConfig", "adamw_update", "global_norm", "init_opt_state", "lr_at",
           "named_tensors"]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    master: bool = False
    # "bfloat16" halves optimizer memory (moments computed in fp32, stored bf16)
    moments_dtype: str = "float32"


def named_tensors(params) -> dict:
    """``{name: tensor}`` of a module's parameters, or the dict itself."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else params


def lr_at(step, oc: OptimizerConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), fp32: linear warmup,
    then a cosine down to ``min_lr_ratio · lr``."""
    step = step.float() if torch.is_tensor(step) else torch.tensor(float(step))
    warm = step / max(1.0, oc.warmup_steps)
    t = (step - oc.warmup_steps) / max(1.0, oc.total_steps - oc.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = oc.min_lr_ratio + (1 - oc.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return oc.lr * torch.where(step < oc.warmup_steps, warm, cos)


def init_opt_state(params, oc: OptimizerConfig) -> dict:
    """``{"m", "v": zeros by name in moments_dtype, "step": int32 0}``, plus
    ``"master"`` (fp32 copies) with ``oc.master``."""
    params = named_tensors(params)
    mdt = getattr(torch, oc.moments_dtype)
    dev = next(iter(params.values())).device
    st = {
        "m": {k: torch.zeros(p.shape, dtype=mdt, device=p.device) for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=mdt, device=p.device) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if oc.master:
        st["master"] = {k: p.detach().float().clone() for k, p in params.items()}
    return st


def global_norm(tree, *, group=None, sharded=frozenset(), fsdp_group=None,
                fsdp_sharded=frozenset()) -> torch.Tensor:
    """``√Σ‖leaf‖²`` in fp32 over a dict of tensors. With a tensor-parallel
    ``group``, the leaves named in ``sharded`` are this rank's blocks: their
    squares are summed over the group, the replicated leaves' counted once;
    with an ``fsdp_group``, those named in ``fsdp_sharded`` are blocks over
    it too, their squares summed over it as well."""
    tree = named_tensors(tree)
    if group is None and fsdp_group is None:
        return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tree.values()))
    dev = next(iter(tree.values())).device
    # replicated; model-axis blocks; FSDP blocks; blocks over both
    part = [torch.zeros((), dtype=torch.float32, device=dev) for _ in range(4)]
    for k, t in tree.items():
        i = (group is not None and k in sharded) + 2 * (fsdp_group is not None
                                                        and k in fsdp_sharded)
        part[i] = part[i] + torch.sum(t.float() ** 2)
    for g, (a, b) in ((group, (1, 3)), (fsdp_group, (2, 3))):
        if g is not None:
            v = torch.stack([part[a], part[b]])
            dist.all_reduce(v, group=g)
            part[a], part[b] = v[0], v[1]
    return torch.sqrt(part[0] + part[1] + part[2] + part[3])


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params, oc: OptimizerConfig, *,
                 norm_group=None, sharded=frozenset(), fsdp_group=None,
                 fsdp_sharded=frozenset()):
    """One AdamW step: ``(params, opt_state, {"grad_norm", "lr"})``. The
    parameters (and the master copy) and the moments are updated in place
    and returned; ``opt_state["step"]`` is a new tensor. Under tensor
    parallelism the clip reads the whole model's norm (:func:`global_norm`
    over ``norm_group`` with the ``sharded`` leaves)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, group=norm_group, sharded=sharded, fsdp_group=fsdp_group,
                        fsdp_sharded=fsdp_sharded)
    scale = None
    if oc.clip_norm is not None:
        # fp32 like the reference's (a bf16 gradient times an fp32 array promotes)
        scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = oc.b1, oc.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    lr = lr_at(step, oc)
    mdt = getattr(torch, oc.moments_dtype)
    p_by_name = named_tensors(params)
    master = opt_state.get("master") if oc.master else None

    for k, g in grads.items():
        p, m, v = p_by_name[k], opt_state["m"][k], opt_state["v"][k]
        g32 = g.float() * scale if scale is not None else g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        mhat = m32 / bc1
        vhat = v32 / bc2
        base = (master[k] if master is not None else p).float()
        new = base - lr * (mhat / (torch.sqrt(vhat) + oc.eps) + oc.weight_decay * base)
        m.copy_(m32.to(mdt))
        v.copy_(v32.to(mdt))
        p.copy_(new.to(p.dtype))
        if master is not None:
            master[k].copy_(new)

    new_state = {**opt_state, "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
