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
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import FFN, ffn, init_scale, param

__all__ = ["MoE", "Routing", "dispatch_groups", "dispatch_slots", "moe_capacity", "moe_ffn",
           "moe_ffn_dense", "route"]


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a group of ``n_tokens`` tokens (at least 8)."""
    cap = int(math.ceil(n_tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, cap)


class MoE(nn.Module):
    """``router`` (D, E) fp32; ``w_gate``, ``w_up`` (E, D, Fe) and ``w_down``
    (E, Fe, D) in the param dtype; ``shared``, an :class:`FFN` of width
    ``n_shared_experts · Fe``, when the config has shared experts."""

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
        unlike a one-hot mean). Formed only where a caller returns it."""
        T, E = self.probs.shape
        top1 = torch.zeros(E, dtype=torch.int64, device=self.probs.device)
        top1.scatter_add_(0, self.experts[:, 0], torch.ones_like(self.experts[:, 0]))
        return E * torch.sum(top1.float() / T * self.probs.mean(dim=0))


def route(p: MoE, xt: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The router over tokens ``xt`` (T, D). Top-k by a stable descending
    sort, so equal probabilities go to the lower expert index first, as
    ``jax.lax.top_k``."""
    k = cfg.moe_top_k
    probs = torch.softmax(xt.float() @ p.router, dim=-1)  # (T, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :k]
    return Routing(gates / gates.sum(dim=-1, keepdim=True), idx[:, :k], probs)


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


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Routing]:
    """The capacity-bounded dispatch; x (B, S, D) → (out, routing)."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.moe_top_k
    xt = x.reshape(T, D)
    r = route(p, xt, cfg)
    gates, experts = r.gates, r.experts
    P, cap = dispatch_groups(T, cfg)
    Tl = T // P
    slot, keep = dispatch_slots(experts, P, cap, E)
    flat_e = experts.reshape(P, Tl * k)
    grp = torch.arange(P, device=x.device)[:, None].expand(P, Tl * k)
    tok = torch.arange(Tl * k, device=x.device) // k  # each assignment's token in its group

    # scatter into (E, P, cap + 1, D): kept slots are unique; the spill slot
    # (several writes, any one of which lands) is computed but never read
    buf = torch.zeros((E, P, cap + 1, D), dtype=x.dtype, device=x.device)
    buf[flat_e, grp, slot] = xt.reshape(P, Tl, D)[grp, tok[None].expand(P, -1)]
    out_buf = _expert_mlp(p, buf.reshape(E, P * (cap + 1), D), cfg.activation)
    out_buf = out_buf.reshape(E, P, cap + 1, D)

    # gather back and combine with the gates (dropped assignments give 0)
    gathered = out_buf[flat_e, grp, slot]  # (P, Tl·k, D)
    gathered = torch.where(keep[..., None], gathered, torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))
    combined = torch.sum(gathered.reshape(T, k, D) * gates[..., None].to(x.dtype), dim=1)
    out = combined.reshape(B, S, D)
    if cfg.n_shared_experts:
        out = out + ffn(p.shared, x, cfg.activation)
    return out, r


def moe_ffn_dense(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Routing]:
    """The dropless path: a loop over experts, each over every token,
    weighted by ``w_te`` (the token's gate for that expert, else 0)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    r = route(p, xt, cfg)
    gates, experts = r.gates, r.experts
    w_te = torch.zeros((T, cfg.n_experts), dtype=torch.float32, device=x.device)
    w_te[torch.arange(T, device=x.device)[:, None], experts] = gates  # top-k experts are distinct
    acc = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        if cfg.activation == "silu":
            h = F.silu(xt @ p.w_gate[e]) * (xt @ p.w_up[e])
        else:
            h = F.gelu(xt @ p.w_up[e], approximate="tanh")
        acc = acc + (h @ p.w_down[e]) * w_te[:, e, None].to(x.dtype)
    out = acc.reshape(B, S, D)
    if cfg.n_shared_experts:
        out = out + ffn(p.shared, x, cfg.activation)
    return out, r
