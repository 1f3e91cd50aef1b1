"""Mixture-of-Experts FFN (counterpart of ``repro/models/moe.py``): kimi-k2's
384 experts top-8 (+1 shared), deepseek-v2-lite's 64 top-6 (+2 shared).

Routing: an fp32 router, softmax, top-k (ties to the lower expert index, as
``jax.lax.top_k``), gates renormalised over the k. Both forward paths
return the output and the :class:`Routing`; the Switch load-balance aux
loss is formed from it (:meth:`Routing.aux_loss`) only where a caller
returns it, the training forward (the reference returns it from every call
and its compiler drops it where unused, in prefill and decode). Two paths,
as the reference:

* :func:`moe_ffn` — the capacity-bounded dispatch. Tokens go in
  ``P = moe_dispatch_shards`` groups (one group when ``T % P``); each
  assignment's rank among its group's assignments to the same expert, in
  token-major then top-k order, decides its slot, and ranks at or past the
  capacity land in a spill slot that is never read (those assignments are
  dropped). Expert products run over ``(group, expert)`` buffers of
  ``capacity + 1`` slots.
* :func:`moe_ffn_dense` — the dropless loop over experts, every token
  through every expert weighted by its gate (0 off its top-k).

The scatter into the buffers is plain index assignment (each kept
(group, expert, slot) is written once), so no float atomics run; the expert
products are batched matmuls, as the reference computes them in XLA. The
shared experts are a dense FFN over every token, added on top.

**On a data axis** (:func:`~repro_torch.distributed.activation_sharding`,
the reference's SPMD program over the global batch) every assignment gets
the slot and keep bit the global batch's run gives it
(:func:`dispatch_plan`): where the data ranks split ``P`` the rank holds
its ``P/d`` groups of ``T_global/P`` tokens and no collective runs; else
the ``(T, k)`` expert ids are gathered over the data axes and ranked whole.
The aux loss sums the top-1 counts over the data axes. Per shard (the
compressed train step, the reference's ``shard_map``) both read the rank's
rows alone.

**Expert parallelism** on the model axis (the reference's own account:
activations replicated over ``model``, experts split over it, the output
sum the only added communication): every model rank computes the same
routing and slots over all ``E`` experts, runs its ``E/m`` experts on
their assignments, zeroes the others, and one ``reduce_from_tp`` sums the
routed partial with the shared experts' partial (their ``w_down`` rows).
The experts' input and the gates pass through ``copy_to_tp`` (the gates'
gradient is partial on every rank); the router's input does not (every
rank computes the whole routing).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import (copy_to_tp, dp_index, global_batch_group, reduce_from_tp,
                                    tp_index)
from .config import MOE, ModelConfig
from .layers import FFN, ffn, init_scale, param

__all__ = ["MoE", "Routing", "decode_gathers", "dispatch_groups", "dispatch_plan",
           "dispatch_slots", "forced_experts", "moe_capacity", "moe_ffn", "moe_ffn_dense",
           "route"]


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a group of ``n_tokens`` tokens (at least 8)."""
    cap = int(math.ceil(n_tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, cap)


class MoE(nn.Module):
    """``router`` (D, E) fp32; ``w_gate``, ``w_up`` (E, D, Fe) and ``w_down``
    (E, Fe, D) in the param dtype; ``shared``, an :class:`FFN` of width
    ``n_shared_experts · Fe``, when the config has shared experts."""

    # the reference's path prefix for the expert stacks' layout (its
    # _MOE_LAYOUTS), read by sharding.cut_at_init as a rank draws its experts
    expert_layout = "ffn"

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        D, E, Fe, dt = cfg.d_model, cfg.n_experts, cfg.d_ff_expert, cfg.param_dtype
        self.router = param(gen, (D, E), torch.float32, device, init_scale(D))
        self.w_gate = param(gen, (E, D, Fe), dt, device, init_scale(D))
        self.w_up = param(gen, (E, D, Fe), dt, device, init_scale(D))
        self.w_down = param(gen, (E, Fe, D), dt, device, init_scale(Fe))
        if cfg.n_shared_experts:
            self.shared = FFN(gen, D, cfg.n_shared_experts * Fe, dt, cfg.activation, device)


class Routing(NamedTuple):
    """The router's choice over T tokens: ``gates`` (T, k) fp32, renormalised
    over the k; ``experts`` (T, k) int64; ``probs`` (T, E) fp32."""

    gates: torch.Tensor
    experts: torch.Tensor
    probs: torch.Tensor

    def aux_loss(self) -> torch.Tensor:
        """The Switch load-balance loss E · Σ_e f_e · p̄_e, f_e the top-1 share
        of expert e (integer counts, so no float atomics and no read-back,
        unlike a one-hot mean). Formed only where a caller returns it.

        On a data axis over the global batch the top-1 counts are summed
        over the data ranks (integers: no autograd), so ``f_e`` is the
        global batch's and ``p̄_e`` the rank's: the data-axis mean of this
        loss, and of its gradient, is the reference's global one."""
        T, E = self.probs.shape
        top1 = torch.zeros(E, dtype=torch.int64, device=self.probs.device)
        top1.scatter_add_(0, self.experts[:, 0], torch.ones_like(self.experts[:, 0]))
        group = global_batch_group()
        if group is not None:
            dist.all_reduce(top1, group=group)
            T = T * dp_index()[1]
        return E * torch.sum(top1.float() / T * self.probs.mean(dim=0))


_FORCED: list = []  # the test hook's active (choices, flip counts), innermost last


@contextlib.contextmanager
def forced_experts(choices):
    """Test hook: each :func:`route` call inside takes the next ``(T, k)``
    expert ids of the iterable ``choices`` in place of its own top-k (its
    gates are its own probabilities at those experts, renormalised). Yields
    a list that receives, for each call, a 0-d count of the assignments
    whose own choice differed."""
    flips = []
    _FORCED.append((iter(choices), flips))
    try:
        yield flips
    finally:
        _FORCED.pop()


def route(p: MoE, xt: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The router over tokens ``xt`` (T, D). Top-k by a stable descending
    sort, so equal probabilities go to the lower expert index first, as
    ``jax.lax.top_k``."""
    k = cfg.moe_top_k
    probs = torch.softmax(xt.float() @ p.router, dim=-1)  # (T, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :k], idx[:, :k]
    if _FORCED:
        choices, flips = _FORCED[-1]
        forced = next(choices).to(device=experts.device, dtype=experts.dtype)
        flips.append(torch.sum(forced != experts))
        experts, gates = forced, torch.gather(probs, 1, forced)
    return Routing(gates / gates.sum(dim=-1, keepdim=True), experts, probs)


def dispatch_groups(n_tokens: int, cfg: ModelConfig) -> Tuple[int, int]:
    """``(P, capacity)``: ``moe_dispatch_shards`` token groups (one when it
    does not divide ``n_tokens``) and the slots per expert in each."""
    P = max(1, cfg.moe_dispatch_shards)
    if n_tokens % P:
        P = 1
    return P, moe_capacity(n_tokens // P, cfg)


def _expert_mlp(p: MoE, xb: torch.Tensor, activation: str) -> torch.Tensor:
    """Every expert over its own rows: xb (E, N, D) → (E, N, D)."""
    if activation == "silu":
        h = F.silu(torch.bmm(xb, p.w_gate)) * torch.bmm(xb, p.w_up)
    else:
        h = F.gelu(torch.bmm(xb, p.w_up), approximate="tanh")
    return torch.bmm(h, p.w_down)


def dispatch_slots(experts: torch.Tensor, P: int, cap: int, E: int):
    """``(slot, keep)`` of each assignment, both (P, Tl·k): its rank among its
    group's assignments to the same expert, in token-major then top-k order
    (the reference's one-hot cumsum), and whether that rank is below ``cap``;
    ranks at or past ``cap`` get the spill slot ``cap``."""
    flat = experts.reshape(P, -1)  # (P, Tl·k)
    n = flat.shape[1]
    key = (flat + E * torch.arange(P, device=flat.device)[:, None]).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)  # a stable sort keeps the flat order
    # rank in its (group, expert) run: its sorted place less where the run
    # starts (found by search, not counted, so nothing is read back)
    rank_sorted = (torch.arange(P * n, device=flat.device)
                   - torch.searchsorted(sorted_key, sorted_key))
    pos = torch.empty_like(rank_sorted)
    pos[order] = rank_sorted
    pos = pos.reshape(P, n)
    keep = pos < cap
    return torch.where(keep, pos, cap), keep


def dispatch_plan(experts: torch.Tensor, cfg: ModelConfig):
    """Where each of this rank's assignments goes in the dispatch buffer:
    ``(group, slot, keep, P, capacity)``, the first three (T·k,) in
    token-major then top-k order, ``P`` the buffer's token groups.

    One rank, or per shard: :func:`dispatch_groups` over the rank's ``T``
    tokens. On ``d`` data ranks over the global batch
    (:func:`~repro_torch.distributed.global_batch_group`) the groups and
    the capacity are the global ``d·T`` tokens' and every assignment gets
    the global run's slot: where ``d`` divides ``P`` the rank's tokens are
    groups ``[i·P/d, (i+1)·P/d)`` and are ranked alone; else the expert ids
    are gathered over the data axes (an integer all-reduce of each rank's
    rows placed in zeros), ranked whole, and this rank's rows kept, its
    buffer spanning the groups its tokens touch."""
    T, k = experts.shape
    E, dev = cfg.n_experts, experts.device
    group = global_batch_group()
    di, d = dp_index() if group is not None else (0, 1)
    P, cap = dispatch_groups(T * d, cfg)
    if P % d == 0:
        Pl = P // d
        slot, keep = dispatch_slots(experts, Pl, cap, E)
        grp = torch.arange(Pl, device=dev).repeat_interleave(T // Pl * k)
        return grp, slot.reshape(-1), keep.reshape(-1), Pl, cap
    whole = experts.new_zeros((d * T, k))
    whole[di * T:(di + 1) * T] = experts
    dist.all_reduce(whole, group=group)
    slot, keep = dispatch_slots(whole, P, cap, E)
    mine = slice(di * T * k, (di + 1) * T * k)
    per_group = d * T // P
    first = di * T // per_group
    grp = torch.arange(di * T, (di + 1) * T, device=dev).repeat_interleave(k) // per_group - first
    n_groups = ((di + 1) * T - 1) // per_group - first + 1
    return grp, slot.reshape(-1)[mine], keep.reshape(-1)[mine], n_groups, cap


def decode_gathers(cfg: ModelConfig, dense_moe: bool, n_tokens: int) -> bool:
    """Whether a forward over ``n_tokens`` of this rank's tokens gathers
    expert ids over the data axes (the capacity dispatch on a data axis
    whose groups do not line up with the ranks, :func:`dispatch_plan`): a
    collective no CUDA graph can capture."""
    if dense_moe or global_batch_group() is None or all(s.ffn != MOE for s in cfg.pattern):
        return False
    d = dp_index()[1]
    return dispatch_groups(n_tokens * d, cfg)[0] % d != 0


def _local_experts(p: MoE, cfg: ModelConfig) -> Tuple[int, int]:
    # this model rank's experts: (first, count); all of them at model axis 1
    index, parts = tp_index()
    n = cfg.n_experts // parts
    if p.w_gate.shape[0] != n:
        raise ValueError(f"the MoE layer holds {p.w_gate.shape[0]} experts; model axis {parts} "
                         f"gives this rank {n} (shard the weights first)")
    return index * n, n


def _shared_partial(p: MoE, x: torch.Tensor, cfg: ModelConfig, out: torch.Tensor) -> torch.Tensor:
    # the routed partial plus the shared experts' (their rows of w_down), summed
    # over the model axis once
    if cfg.n_shared_experts:
        out = out + ffn(p.shared, x, cfg.activation, reduce=False)
    return reduce_from_tp(out)


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Routing]:
    """The capacity-bounded dispatch; x (B, S, D) → (out, routing)."""
    B, S, D = x.shape
    T = B * S
    k = cfg.moe_top_k
    xt = x.reshape(T, D)
    r = route(p, xt, cfg)
    grp, slot, keep, P, cap = dispatch_plan(r.experts, cfg)
    lo, n = _local_experts(p, cfg)
    e = r.experts.reshape(-1)
    kept = keep & (e >= lo) & (e < lo + n)
    el = torch.where(kept, e - lo, 0)  # another rank's assignments: this rank's spill slot
    slot = torch.where(kept, slot, cap)
    tok = torch.arange(T * k, device=x.device) // k  # each assignment's token

    # scatter into (E/m, P, cap + 1, D): kept slots are unique; the spill slot
    # (several writes, any one of which lands) is computed but never read
    buf = torch.zeros((n, P, cap + 1, D), dtype=x.dtype, device=x.device)
    buf[el, grp, slot] = copy_to_tp(xt)[tok]
    out_buf = _expert_mlp(p, buf.reshape(n, P * (cap + 1), D), cfg.activation)
    out_buf = out_buf.reshape(n, P, cap + 1, D)

    # gather back and combine with the gates (dropped and other ranks'
    # assignments give 0)
    gathered = out_buf[el, grp, slot]  # (T·k, D)
    gathered = torch.where(kept[:, None], gathered, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))
    gates = copy_to_tp(r.gates)
    combined = torch.sum(gathered.reshape(T, k, D) * gates[..., None].to(x.dtype), dim=1)
    return _shared_partial(p, x, cfg, combined.reshape(B, S, D)), r


def moe_ffn_dense(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Routing]:
    """The dropless path: a loop over this rank's experts, each over every
    token, weighted by ``w_te`` (the token's gate for that expert, else 0)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    r = route(p, xt, cfg)
    gates, experts = copy_to_tp(r.gates), r.experts
    w_te = torch.zeros((T, cfg.n_experts), dtype=torch.float32, device=x.device)
    w_te[torch.arange(T, device=x.device)[:, None], experts] = gates  # top-k experts are distinct
    lo, n = _local_experts(p, cfg)
    xe = copy_to_tp(xt)
    acc = torch.zeros_like(xt)
    for j in range(n):
        if cfg.activation == "silu":
            h = F.silu(xe @ p.w_gate[j]) * (xe @ p.w_up[j])
        else:
            h = F.gelu(xe @ p.w_up[j], approximate="tanh")
        acc = acc + (h @ p.w_down[j]) * w_te[:, lo + j, None].to(x.dtype)
    return _shared_partial(p, x, cfg, acc.reshape(B, S, D)), r
