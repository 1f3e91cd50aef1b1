"""Train-step builders: the plain step and the GMR-compressed-gradient step
(counterpart of ``repro/train/train_step.py``).

* :func:`make_train_step` — value and gradients by autograd (with the
  reference's remat policies and microbatch accumulation), AdamW.
* :func:`make_compressed_train_step` — the paper's Algorithm 1 in place of
  the dense data-parallel all-reduce (:mod:`.grad_compress`).

Both run on one process per rank of a
:class:`~repro_torch.distributed.Mesh` (``mesh=``; none is a world of one).
The reference's partitioner-managed layout becomes explicit collectives:
over the data axes every gradient takes the mean (``all_reduce(SUM) / d``;
the shards of the batch are equal, so this is the global batch's mean) or,
compressed, every (C, R, M) triple. The plain step computes over the global
batch as the reference's ``jit`` does (the MoE dispatch and the aux loss's
top-1 counts read every data rank's routing, so the mean of the ranks'
gradients is the global one); the compressed step computes each rank's
loss, dispatch and aux on its own rows, as the reference's ``shard_map``
over the data axes does (``activation_sharding(per_shard=True)``); over the model axis the forward and the
backward run under :func:`~repro_torch.distributed.activation_sharding`
(each rank its block of every weight, :func:`cross_entropy` vocab-parallel),
the gradient norm sums the blocks' squares, and compression works on each
rank's block (:func:`~.grad_compress.compressed_mean_grads`'s ``cuts``).
Every rank issues the same collectives in the same order.

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
from ..distributed.sharding import (Mesh, ParallelismRules, activation_sharding, fsdp_names,
                                    is_whole, reduce_from_tp, tp_cuts, tp_group, tp_index,
                                    tp_names)
from ..models import init_params, train_logits
from ..models.config import ModelConfig
from .grad_compress import (CompressionConfig, _mean, compressed_mean_grads, group_leaves,
                            init_error_state)
from .optimizer import OptimizerConfig, adamw_update, init_opt_state

__all__ = ["cross_entropy", "init_train_state", "make_compressed_train_step", "make_loss_fn",
           "make_train_step"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """Mean token NLL; logits (B, S, V) fp32, labels (B, S) ints. The gold
    logit is a masked sum over V, as the reference's (which keeps a
    vocab-sharded V local), not a gather.

    Under tensor parallelism the logits are this rank's vocab shard: the
    max is all-reduced (no gradient), then the sum of exponentials, and the
    masked sum runs over the shard's range of token ids, summed over the
    model axis; the whole vocab's logits, where the run time keeps it whole
    (``sharding.is_whole("tok", cfg)``), take the one-rank route."""
    index, parts = tp_index()
    V = logits.shape[-1]
    if parts == 1 or cfg is not None and is_whole("tok", cfg):
        logz = torch.logsumexp(logits, dim=-1)
        onehot = labels[..., None] == torch.arange(V, device=logits.device)
        gold = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
        return torch.mean(logz - gold)
    mx = logits.detach().amax(dim=-1)
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=tp_group())
    logz = torch.log(reduce_from_tp(torch.sum(torch.exp(logits - mx[..., None]), dim=-1))) + mx
    onehot = labels[..., None] == torch.arange(index * V, (index + 1) * V, device=logits.device)
    gold = reduce_from_tp(torch.sum(torch.where(onehot, logits, 0.0), dim=-1))
    return torch.mean(logz - gold)


class _Parallel:
    """A mesh as a step uses it: the data-parallel group and size, the model
    axis's group, the FSDP axes' group (``rules.fsdp``) and the axes left
    over them (``pod`` on the multi-pod mesh), the context of the forward
    and backward, and the blocks of a model's leaves. No mesh is a world of
    one."""

    def __init__(self, mesh: Optional[Mesh], rules: Optional[ParallelismRules] = None):
        self.mesh = mesh if mesh is not None else Mesh({"data": 1, "model": 1})
        self.rules = (rules or ParallelismRules()).with_mesh(self.mesh)
        self.dp_group = self.mesh.group(self.rules.dp_axes)
        self.dp_world = self.mesh.axis_size(self.rules.dp_axes)
        self.tp_group = self.mesh.group(self.rules.tp_axis)
        fsdp = self.rules.fsdp and self.mesh.axis_size(self.rules.fsdp_axes) > 1
        self.fsdp_group = self.mesh.group(self.rules.fsdp_axes) if fsdp else None
        rest = tuple(a for a in self.rules.dp_axes if a not in self.rules.fsdp_axes)
        self.rest_group = self.mesh.group(rest) if fsdp and rest else None

    def context(self, per_shard: bool = False):
        return activation_sharding(self.mesh, self.rules, per_shard=per_shard)

    def cuts(self, params) -> dict:
        return tp_cuts(params, self.rules, self.mesh)

    def blocks(self, params) -> frozenset:
        return tp_names(params, self.rules, self.mesh)

    def fsdp_blocks(self, params) -> frozenset:
        return fsdp_names(params) if self.fsdp_group is not None else frozenset()

    def mean_grads(self, grads: dict, fsdp: frozenset) -> None:
        """The data-parallel mean of every gradient, in place: an FSDP
        block's arrives summed over the FSDP axes (the reduce-scatter of its
        gather), so it is all-reduced over the other data axes alone."""
        for name, g in grads.items():
            if name not in fsdp:
                _mean(g, self.dp_group, self.dp_world)
                continue
            if self.rest_group is not None:
                dist.all_reduce(g, group=self.rest_group)
            g.div_(self.dp_world)


def make_loss_fn(cfg: ModelConfig, *, remat: Optional[str] = None, dense_moe: bool = False):
    """``loss_fn(params, batch) → (loss, {"ce", "aux"})``: next-token cross
    entropy (on ``batch["labels"]`` when given) plus
    ``router_aux_weight · aux``."""

    def loss_fn(params, batch):
        logits, aux = train_logits(params, cfg, batch["tokens"], batch.get("vision"),
                                   dense_moe=dense_moe, remat=remat)
        labels = batch["labels"] if "labels" in batch else batch["tokens"]
        ce = cross_entropy(logits[:, :-1], labels[:, 1:], cfg)
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


def _global_microbatches(batch: dict, n_micro: int, par: "_Parallel") -> dict:
    """This data rank's share of each of the global batch's ``n_micro``
    microbatches, in microbatch order: the reference's
    ``_grads_microbatched`` splits the global batch (microbatch i its rows
    ``[i·B/n, (i+1)·B/n)``), which the ``d`` data ranks then share as they
    share a batch. Each entry is gathered over the data axes (an all-reduce
    of each rank's rows placed in zeros, exact) and re-cut."""
    d, at = par.dp_world, par.mesh.index(par.rules.dp_axes)
    out = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"a global batch of {b * d} rows does not split into {n_micro} "
                             f"microbatches of {d} equal data shares")
        whole = x.new_zeros((d * b, *x.shape[1:]))
        whole[at * b:(at + 1) * b] = x
        dist.all_reduce(whole, group=par.dp_group)
        out[k] = whole.reshape(n_micro, d, b // n_micro, *x.shape[1:])[:, at].reshape(x.shape)
    return out


def init_train_state(gen: Optional[torch.Generator], cfg: ModelConfig, oc: OptimizerConfig, *,
                     device=None) -> dict:
    params = init_params(gen, cfg, device=device)
    return {"params": params, "opt": init_opt_state(params, oc)}


def make_train_step(cfg: ModelConfig, oc: OptimizerConfig, *, remat: Optional[str] = "dots",
                    microbatch: int = 1, dense_moe: bool = False, mesh: Optional[Mesh] = None,
                    rules: Optional[ParallelismRules] = None):
    """The plain step: ``(state, batch) → (state, metrics)``. On a ``mesh``
    each rank holds its block of the weights and its data-parallel share of
    the batch; the gradients and the loss metrics take the mean over the
    data axes. With ``microbatch`` n > 1 each microbatch is the global
    batch's, as the reference's: a data rank runs its share of each
    (:func:`_global_microbatches`), and the metrics are the last global
    microbatch's. ``rules`` with ``fsdp`` holds each leaf's block over the
    data axis too (:func:`~repro_torch.distributed.fsdp_gathered`); AdamW
    then updates the rank's blocks."""
    loss_fn = make_loss_fn(cfg, remat=remat, dense_moe=dense_moe)
    par = _Parallel(mesh, rules)

    def train_step(state, batch):
        params = state["params"]
        if microbatch > 1 and par.dp_group is not None:
            batch = _global_microbatches(batch, microbatch, par)
        with par.context():
            loss, metrics, grads = _grads_microbatched(loss_fn, params, batch, microbatch)
        if par.dp_group is not None:
            par.mean_grads(grads, par.fsdp_blocks(params))
            local = {"loss": loss, **metrics}
            vec = _mean(torch.stack([v.float() for v in local.values()]), par.dp_group,
                        par.dp_world)
            loss, metrics = vec[0], {k: vec[i + 1] for i, k in enumerate(metrics)}
        params, opt, opt_metrics = adamw_update(grads, state["opt"], params, oc,
                                                norm_group=par.tp_group,
                                                sharded=par.blocks(params),
                                                fsdp_group=par.fsdp_group,
                                                fsdp_sharded=par.fsdp_blocks(params))
        return {**state, "params": params, "opt": opt}, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_compressed_train_step(cfg: ModelConfig, oc: OptimizerConfig, ccfg: CompressionConfig,
                               *, mesh: Optional[Mesh] = None, remat: Optional[str] = "dots",
                               dense_moe: bool = False,
                               rules: Optional[ParallelismRules] = None):
    """The GMR-compressed DP step on ``mesh`` (none is a world of one): the
    triples are averaged over its data axes, and its model axis holds each
    rank's block of the weights. The state gains ``err``, this
    rank's EF residuals (``init_err(params)``); ``step_seed`` (an int shared
    by the ranks) drives the step's sketches, or ``sketches`` (the logical
    leaves' four sketches by leaf index) hands them in.

    Returns ``(train_step, init_err)`` with ``train_step(state, batch,
    step_seed, sketches=None) → (state, metrics)``; every metric is the mean
    over the data-parallel ranks, the ``comp/*`` ones included. Raises
    ``ValueError`` under FSDP rules, as the reference's does."""
    if rules is not None and rules.fsdp:
        raise ValueError(
            "gradient compression replaces the DP all-reduce; with FSDP the DP "
            "reduction is a reduce-scatter of sharded weights — unsupported combination")
    loss_fn = make_loss_fn(cfg, remat=remat, dense_moe=dense_moe)
    par = _Parallel(mesh, rules)

    def train_step(state, batch, step_seed: int, sketches: Optional[dict] = None):
        params = state["params"]
        groups = stacked_leaves(params, cfg)
        with par.context(per_shard=True):  # the reference's shard_map over the data axes
            loss, metrics, grads = _value_and_grad(loss_fn, params, batch)
        stacked = group_leaves(grads, groups)
        del grads
        gbar, new_err, cstats = compressed_mean_grads(
            stacked, state["err"], step_seed, ccfg, par.dp_group, with_stats=True,
            sketches=sketches, cuts=par.cuts(params), tp_group=par.tp_group)
        del stacked
        grads = {n: gbar[path][i] if len(names) > 1 else gbar[path]
                 for path, names in groups for i, n in enumerate(names)}
        params, opt, opt_metrics = adamw_update(grads, state["opt"], params, oc,
                                                norm_group=par.tp_group,
                                                sharded=par.blocks(params))
        local = {"loss": loss, **metrics, **cstats}
        vec = _mean(torch.stack([v.float() for v in local.values()]), par.dp_group, par.dp_world)
        metrics = {k: vec[i] for i, k in enumerate(local)}
        return ({**state, "params": params, "opt": opt, "err": new_err},
                {**metrics, **opt_metrics})

    def init_err(params):
        return init_error_state(params, ccfg, par.cuts(params))

    return train_step, init_err
