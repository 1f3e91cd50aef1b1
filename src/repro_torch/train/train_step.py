"""Train-step builders: the plain step and the GMR-compressed-gradient step
(counterpart of ``repro/train/train_step.py``).

* :func:`make_train_step` — value and gradients by autograd (with the
  reference's remat policies and microbatch accumulation), AdamW.
* :func:`make_compressed_train_step` — the paper's Algorithm 1 in place of
  the dense data-parallel all-reduce (:mod:`.grad_compress`). The
  reference's ``shard_map`` manual over the DP axes becomes one process per
  rank on a ``torch.distributed`` group, each rank holding its shard of the
  batch and its own EF state; tensor parallelism (the reference's ``model``
  axis) is not ported (``ROADMAP.md`` §1).

A train state is ``{"params": Transformer, "opt": {...}}`` (and ``"err"``
for the compressed step). A step updates the model's parameters and the
moments in place (:func:`~.optimizer.adamw_update`) and returns the state
with them; its metrics are 0-d tensors, read by the caller.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..convert import stacked_leaves
from ..models import init_params, train_logits
from ..models.config import ModelConfig
from .grad_compress import (CompressionConfig, _mean, compressed_mean_grads, group_leaves,
                            init_error_state)
from .optimizer import OptimizerConfig, adamw_update, init_opt_state

__all__ = ["cross_entropy", "init_train_state", "make_compressed_train_step", "make_loss_fn",
           "make_train_step"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL; logits (B, S, V) fp32, labels (B, S) ints. The gold
    logit is a masked sum over V, as the reference's (which keeps a
    vocab-sharded V local), not a gather."""
    logz = torch.logsumexp(logits, dim=-1)
    V = logits.shape[-1]
    onehot = labels[..., None] == torch.arange(V, device=logits.device)
    gold = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    return torch.mean(logz - gold)


def make_loss_fn(cfg: ModelConfig, *, remat: Optional[str] = None, dense_moe: bool = False):
    """``loss_fn(params, batch) → (loss, {"ce", "aux"})``: next-token cross
    entropy (on ``batch["labels"]`` when given) plus
    ``router_aux_weight · aux``."""

    def loss_fn(params, batch):
        logits, aux = train_logits(params, cfg, batch["tokens"], batch.get("vision"),
                                   dense_moe=dense_moe, remat=remat)
        labels = batch["labels"] if "labels" in batch else batch["tokens"]
        ce = cross_entropy(logits[:, :-1], labels[:, 1:])
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """``(loss, metrics, grads by name)`` of ``loss_fn(params, batch)``."""
    named = dict(params.named_parameters())
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(named, grads))


def _grads_microbatched(loss_fn, params, batch: dict, n_micro: int):
    """Gradient accumulation over ``n_micro`` leading-batch splits, in fp32:
    the mean loss, the last split's metrics, the mean gradients."""
    if n_micro <= 1:
        return _value_and_grad(loss_fn, params, batch)
    micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:]) for k, v in batch.items()}
    acc, loss_sum, metrics = None, 0.0, None
    for i in range(n_micro):
        loss, metrics, g = _value_and_grad(loss_fn, params, {k: v[i] for k, v in micro.items()})
        if acc is None:
            acc = {k: t.float() for k, t in g.items()}
        else:
            for k, t in g.items():
                acc[k] += t
        loss_sum = loss_sum + loss
    return loss_sum / n_micro, metrics, {k: a / n_micro for k, a in acc.items()}


def init_train_state(gen: Optional[torch.Generator], cfg: ModelConfig, oc: OptimizerConfig, *,
                     device=None) -> dict:
    params = init_params(gen, cfg, device=device)
    return {"params": params, "opt": init_opt_state(params, oc)}


def make_train_step(cfg: ModelConfig, oc: OptimizerConfig, *, remat: Optional[str] = "dots",
                    microbatch: int = 1, dense_moe: bool = False):
    """The plain step on one process: ``(state, batch) → (state, metrics)``
    (the reference's partitioner-managed data parallelism is not ported;
    ``ROADMAP.md`` §1)."""
    loss_fn = make_loss_fn(cfg, remat=remat, dense_moe=dense_moe)

    def train_step(state, batch):
        loss, metrics, grads = _grads_microbatched(loss_fn, state["params"], batch, microbatch)
        params, opt, opt_metrics = adamw_update(grads, state["opt"], state["params"], oc)
        return {**state, "params": params, "opt": opt}, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_compressed_train_step(cfg: ModelConfig, oc: OptimizerConfig, ccfg: CompressionConfig,
                               group=None, *, remat: Optional[str] = "dots",
                               dense_moe: bool = False):
    """The GMR-compressed DP step over ``group`` (``None``: a world of one).
    The state gains ``err``, this rank's EF residuals (``init_err(params)``);
    ``step_seed`` (an int shared by the ranks) drives the step's sketches.

    Returns ``(train_step, init_err)`` with ``train_step(state, batch,
    step_seed) → (state, metrics)``; every metric is the mean over the ranks,
    the ``comp/*`` ones included."""
    loss_fn = make_loss_fn(cfg, remat=remat, dense_moe=dense_moe)
    world = dist.get_world_size(group) if group is not None else 1

    def train_step(state, batch, step_seed: int):
        params = state["params"]
        groups = stacked_leaves(params, cfg)
        loss, metrics, grads = _value_and_grad(loss_fn, params, batch)
        stacked = group_leaves(grads, groups)
        del grads
        gbar, new_err, cstats = compressed_mean_grads(stacked, state["err"], step_seed, ccfg, group,
                                                      with_stats=True)
        del stacked
        grads = {n: gbar[path][i] if len(names) > 1 else gbar[path]
                 for path, names in groups for i, n in enumerate(names)}
        params, opt, opt_metrics = adamw_update(grads, state["opt"], params, oc)
        local = {"loss": loss, **metrics, **cstats}
        vec = _mean(torch.stack([v.float() for v in local.values()]), group, world)
        metrics = {k: vec[i] for i, k in enumerate(local)}
        return ({**state, "params": params, "opt": opt, "err": new_err},
                {**metrics, **opt_metrics})

    def init_err(params):
        return init_error_state(params, ccfg)

    return train_step, init_err
