"""Shared neural layers (counterpart of ``repro/models/layers.py``): RMSNorm,
RoPE, FFN (SwiGLU/GELU), embeddings, the LM head.

Norms compute in fp32 whatever the parameter dtype. Where the reference
asks its partitioner for a tensor-parallel layout (``shard_act``), the port
marks the model axis's collectives itself
(:mod:`repro_torch.distributed.sharding`): the FFN's column-sharded
``w_gate``/``w_up`` and row-sharded ``w_down`` are bracketed by
``copy_to_tp`` and ``reduce_from_tp``, the token table is looked up
vocab-parallel, and the logits come out as this rank's vocab shard, which
serving gathers whole (:func:`gather_vocab`) before it samples. Outside
``activation_sharding`` (a single rank) all of it is the identity.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import copy_to_tp, gather_tp, is_whole, reduce_from_tp, tp_index
from .config import ModelConfig


def truncated_normal_(t: torch.Tensor, gen: torch.Generator, scale: float) -> torch.Tensor:
    """Fill ``t`` with ``scale`` × a standard normal truncated to [−2, 2] (the
    reference's ``truncated_normal_init``; the same distribution, not the
    same bits), drawn in fp32 and cast to ``t``'s dtype. A stack (three or
    more dims, e.g. MoE experts (E, D, F)) is drawn one leading slice at a
    time, so the fp32 temporary is one slice, never the whole stack."""
    if t.dim() >= 3:
        for i in range(t.shape[0]):
            truncated_normal_(t[i], gen, scale)
        return t
    x = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.copy_(x * scale)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_frequencies_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # one copy per (width, theta, device), made at the first call: a decode
    # step captured in a CUDA graph may copy nothing from the host
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate pairs (non-interleaved / llama layout), angles in fp32.

    x: (..., S, H, D); positions: broadcastable to (..., S).
    """
    d = x.shape[-1]
    freqs = _rope_frequencies_on(d, theta, x.device)  # (d/2,)
    angles = positions[..., :, None].float() * freqs  # (..., S, d/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2 :].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def param(gen, shape, dtype, device, scale: float) -> nn.Parameter:
    """A trainable parameter of ``shape`` drawn by :func:`truncated_normal_`."""
    t = torch.empty(shape, dtype=dtype, device=device)
    return nn.Parameter(truncated_normal_(t, gen, scale))


class FFN(nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or the GELU MLP (no gate) of
    width ``d_ff`` (the reference's ``init_ffn``): ``cfg.d_ff`` for a dense
    layer, ``n_shared_experts · d_ff_expert`` for MoE's shared experts."""

    def __init__(self, gen, d_model: int, d_ff: int, dtype, activation: str, device):
        super().__init__()
        if activation == "silu":
            self.w_gate = param(gen, (d_model, d_ff), dtype, device, init_scale(d_model))
        self.w_up = param(gen, (d_model, d_ff), dtype, device, init_scale(d_model))
        self.w_down = param(gen, (d_ff, d_model), dtype, device, init_scale(d_ff))


def positions(B: int, S: int, device) -> torch.Tensor:
    """Token positions ``0 .. S − 1`` for each of B rows (B, S)."""
    return torch.arange(S, device=device)[None].expand(B, S)


def decode_positions(B: int, length: torch.Tensor) -> torch.Tensor:
    """The decoded token's position, the cache's ``length`` (a 0-d int on the
    device), for each of B rows (B, 1): read on the device, never the host."""
    return length.reshape(1, 1).expand(B, 1)


def ffn(p, x: torch.Tensor, activation: str = "silu", *, reduce: bool = True) -> torch.Tensor:
    """SwiGLU (``silu``) or the non-gated GELU MLP (tanh GELU, as
    ``jax.nn.gelu``); ``p`` holds ``w_up``, ``w_down`` and, for SwiGLU,
    ``w_gate``, each used as ``x @ w``; under tensor parallelism the local
    columns of ``w_gate``/``w_up`` and rows of ``w_down``, the partial
    outputs summed over the model axis (``reduce=False`` returns the
    partial, for a caller that sums it with another)."""
    x = copy_to_tp(x)
    up = x @ p.w_up
    if activation == "silu":
        h = F.silu(x @ p.w_gate) * up
    elif activation == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(activation)
    out = h @ p.w_down
    return reduce_from_tp(out) if reduce else out


def embed_tokens(tok: torch.Tensor, tokens: torch.Tensor,
                 cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """The rows of ``tok`` for ``tokens``. Under tensor parallelism ``tok`` is
    this rank's vocab block: a token outside it looks up zeros, and the sum
    over the model axis holds every token's row; a table the run time keeps
    whole (``sharding.is_whole("tok", cfg)``) is looked up as it is."""
    index, parts = tp_index()
    if parts == 1 or cfg is not None and is_whole("tok", cfg):
        return tok[tokens.long()]
    V = tok.shape[0]
    local = tokens.long() - index * V
    inside = (local >= 0) & (local < V)
    return reduce_from_tp(torch.where(inside[..., None], tok[local.clamp(0, V - 1)], 0))


def lm_logits(embed, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """fp32 logits through the tied head ``tokᵀ`` or ``lm_head``, with the
    optional ``logit_softcap``; under tensor parallelism this rank's vocab
    shard of them (the whole vocab's where the run time keeps it whole)."""
    name = "tok" if cfg.tie_embeddings else "lm_head"
    w = embed.tok.T if cfg.tie_embeddings else embed.lm_head
    logits = ((x if is_whole(name, cfg) else copy_to_tp(x)) @ w).float()
    if cfg.logit_softcap:
        cap = cfg.logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """The whole vocab's logits from this rank's shard of them
    (:func:`lm_logits` under tensor parallelism): the model axis's shards
    joined in shard order, so an argmax over them ties to the lower index as
    on one rank. The identity at model axis 1."""
    return gather_tp(logits, -1)


def init_scale(fan_in: int) -> float:
    return 1.0 / math.sqrt(fan_in)
