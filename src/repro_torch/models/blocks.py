"""Residual blocks (counterpart of ``repro/models/blocks.py``): pre-norm
mixer plus pre-norm FFN, with per-kind caches.

Mixers: GQA for ``ATTN`` and ``ATTN_LOCAL``; ``SHARED_ATTN``, GQA through
the model-level shared weights (``extras["shared"]``: the block holds its
norms and FFN, no mixer); MLA; Mamba-2 SSD; ``CROSS``, tanh-gated
attention over the projected modality embeddings (``extras["vision"]``).
FFNs: dense and MoE. Every block kind exposes, as the reference:

  init_block(gen, spec, cfg, device)                          → Block
  block_train(block, spec, cfg, x, extras, dense_moe)         → (x, aux_loss)
  block_prefill(block, spec, cfg, x, cache_len, extras, dense_moe) → (x, cache)
  block_decode(block, spec, cfg, x, cache, length, extras, dense_moe, phase) → x
  init_block_cache(spec, cfg, batch, cache_len, device)       → cache

and :func:`apply_ffn`, the FFN half alone (a spec with ``ffn=NONE`` runs
the mixer half alone). Only ``block_train`` forms MoE's aux loss; the
reference's ``block_prefill`` also returns it, and its compiler drops the
unused sum.

Cache layouts: ``attn`` and ``shared_attn`` K/V (B, cache_len, KV, hd),
the full history; ``attn_local`` K/V (B, window, KV, hd), a ring; ``mla``
the latent (B, cache_len, r + rope); ``mamba2`` the conv windows
(B, K − 1, C) and the fp32 state (B, H, N, P), O(1) in length (prefill
ignores ``cache_len``); ``cross`` K/V (B, n_patches, KV, hd), static after
prefill. Decode updates every cache in place (the reference returns an
updated copy): a new attention token is written at ``length``, a 0-d int
on the device that every index and mask reads there, and the Mamba-2
states are copied into their tensors, so no buffer is rebound and a
captured CUDA graph of the step stays valid. A cache that is not a dict is
a pluggable backend (:class:`repro_torch.serve.kv_cache.CompressedKV`)
that owns its append and attention through ``append_attend``, told the
step's ``phase`` (:data:`PLAIN`, :data:`FOLD` or :data:`REFRESH`, a
schedule the host knows); dense caches have one phase. ``dense_moe`` picks
the MoE FFN's dropless loop over its capacity-bounded dispatch.

Under tensor parallelism (:func:`repro_torch.distributed.activation_sharding`)
the GQA mixer runs this rank's heads in training, prefill and decode:
``w_q``, ``w_k``, ``w_v`` hold their columns, ``w_o`` their rows, the
partial outputs are summed over the model axis, and every K/V cache (the
full one, the ``ATTN_LOCAL`` ring, a pluggable backend) holds the rank's
``KV/m`` heads (``ATTN`` and ``ATTN_LOCAL``; the run time raises for the
other kinds).
"""

from __future__ import annotations

import torch
from torch import nn

from ..distributed.sharding import copy_to_tp, reduce_from_tp, tp_index
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .attention import (attention_train, cross_attention, cross_attention_plain, decode_attention,
                        flash_attention)
from .config import (ATTN, ATTN_LOCAL, CROSS, DENSE, MAMBA2, MLA, MOE, NONE, SHARED_ATTN,
                     BlockSpec, ModelConfig)
from .layers import FFN, apply_rope, decode_positions, ffn, init_scale, param, positions, rmsnorm

# the phases of a decode step for a cache backend: a plain append, a fold of
# the pending tokens, a fold followed by the refactorization
PLAIN, FOLD, REFRESH = "plain", "fold", "refresh"


def _ones(d, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones((d,), dtype=dtype, device=device))


class GQA(nn.Module):
    """Grouped-query attention projections, each applied as ``x @ w``."""

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        D, H, KV, hd, dt = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.param_dtype
        self.w_q = param(gen, (D, H * hd), dt, device, init_scale(D))
        self.w_k = param(gen, (D, KV * hd), dt, device, init_scale(D))
        self.w_v = param(gen, (D, KV * hd), dt, device, init_scale(D))
        self.w_o = param(gen, (H * hd, D), dt, device, init_scale(H * hd))


class Cross(GQA):
    """Cross-attention: :class:`GQA`'s projections and the fp32 scalar
    ``gate`` of its tanh-gated residual, 0 at init (the layer adds nothing
    until trained), as the reference's ``_init_cross``."""

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__(gen, cfg, device)
        self.gate = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device))


class Block(nn.Module):
    """One residual layer's parameters: ``norm1``, ``mixer`` (:class:`GQA`,
    :class:`Cross`, :class:`~repro_torch.models.mla.MLA` or
    :class:`~repro_torch.models.ssm.Mamba2`; none for ``SHARED_ATTN``),
    ``norm2``, ``ffn`` (:class:`FFN` or :class:`~repro_torch.models.moe.MoE`)."""

    def __init__(self, gen, spec: BlockSpec, cfg: ModelConfig, device):
        super().__init__()
        self.norm1 = _ones(cfg.d_model, cfg.param_dtype, device)
        if spec.mixer in (ATTN, ATTN_LOCAL):
            self.mixer = GQA(gen, cfg, device)
        elif spec.mixer == MLA:
            self.mixer = mla_mod.MLA(gen, cfg, device)
        elif spec.mixer == MAMBA2:
            self.mixer = ssm_mod.Mamba2(gen, cfg, device)
        elif spec.mixer == CROSS:
            self.mixer = Cross(gen, cfg, device)
        elif spec.mixer != SHARED_ATTN:  # its weights are the model's ``shared``
            raise ValueError(spec.mixer)
        if spec.ffn == NONE:
            return
        self.norm2 = _ones(cfg.d_model, cfg.param_dtype, device)
        if spec.ffn == DENSE:
            self.ffn = FFN(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype, cfg.activation, device)
        elif spec.ffn == MOE:
            self.ffn = moe_mod.MoE(gen, cfg, device)
        else:
            raise ValueError(spec.ffn)


def init_block(gen, spec: BlockSpec, cfg: ModelConfig, device) -> Block:
    return Block(gen, spec, cfg, device)


# ---------------------------------------------------------------------------
# GQA attention mixer
# ---------------------------------------------------------------------------


def _theta_for(spec_mixer: str, cfg: ModelConfig) -> float:
    if spec_mixer in (ATTN, SHARED_ATTN) and cfg.rope_theta_global:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _gqa_qkv(p: GQA, x, positions, cfg: ModelConfig, theta: float):
    # the heads the projections hold: all of them, or under tensor parallelism
    # this rank's contiguous block of H/m query and KV/m KV heads (each query
    # head stays with its KV head)
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p.w_q).reshape(B, S, -1, hd)
    k = (x @ p.w_k).reshape(B, S, -1, hd)
    v = (x @ p.w_v).reshape(B, S, -1, hd)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def _gqa_train(p: GQA, spec_mixer, cfg: ModelConfig, x):
    B, S, _ = x.shape
    x = copy_to_tp(x)
    q, k, v = _gqa_qkv(p, x, positions(B, S, x.device), cfg, _theta_for(spec_mixer, cfg))
    window = cfg.window if spec_mixer == ATTN_LOCAL else None
    o = attention_train(q, k, v, window=window, chunk=cfg.attn_chunk, impl=cfg.attn_impl)
    return reduce_from_tp(o.reshape(B, S, -1) @ p.w_o)


def _gqa_prefill(p: GQA, spec_mixer, cfg: ModelConfig, x, cache_len: int):
    B, S, _ = x.shape
    x = copy_to_tp(x)
    q, k, v = _gqa_qkv(p, x, positions(B, S, x.device), cfg, _theta_for(spec_mixer, cfg))
    window = cfg.window if spec_mixer == ATTN_LOCAL else None
    o = flash_attention(q, k, v, window=window, chunk=cfg.attn_chunk)
    if spec_mixer == ATTN_LOCAL:  # ring buffer: token t at slot t % window
        w = cfg.window
        keep = min(S, w)
        slots = torch.arange(S - keep, S, device=x.device) % w
        cache = init_block_cache(BlockSpec(ATTN_LOCAL), cfg, B, cache_len, x.device)
        cache["k"][:, slots] = k[:, S - keep :]
        cache["v"][:, slots] = v[:, S - keep :]
    else:
        cache = init_block_cache(BlockSpec(ATTN), cfg, B, cache_len, x.device)
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    return reduce_from_tp(o.reshape(B, S, -1) @ p.w_o), cache


def _write_slot(cache: dict, slot: torch.Tensor, k, v) -> None:
    # the token's K/V into slot ``slot`` (a 0-d int on the device) in place
    idx = slot.reshape(1).long()
    cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))


def _gqa_decode(p: GQA, spec_mixer, cfg: ModelConfig, x, cache, length: torch.Tensor,
                phase: str):
    B = x.shape[0]
    x = copy_to_tp(x)
    q, k, v = _gqa_qkv(p, x, decode_positions(B, length), cfg, _theta_for(spec_mixer, cfg))
    if not isinstance(cache, dict):
        # pluggable cache backend: owns its append and attention
        o = cache.append_attend(q, k, v, length, phase)
    elif spec_mixer == ATTN_LOCAL:
        # ring: slots below min(length + 1, window) are valid, all within the window
        w = cfg.window
        _write_slot(cache, length % w, k, v)
        o = decode_attention(q, cache["k"], cache["v"], torch.clamp(length + 1, max=w))
    else:
        _write_slot(cache, length, k, v)
        o = decode_attention(q, cache["k"], cache["v"], length + 1)
    return reduce_from_tp(o.reshape(B, 1, -1) @ p.w_o)


# ---------------------------------------------------------------------------
# Cross-attention mixer (VLM)
# ---------------------------------------------------------------------------


def _cross_kv(p: Cross, vis, cfg: ModelConfig):
    B, P, _ = vis.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return (vis @ p.w_k).reshape(B, P, KV, hd), (vis @ p.w_v).reshape(B, P, KV, hd)


def _cross_attend(p: Cross, cfg: ModelConfig, x, k, v, core=cross_attention):
    # no mask, no RoPE; the gate's fp32 tanh promotes the product, as the
    # reference's 0-d fp32 array does, before the cast back to x's dtype
    B, S, _ = x.shape
    q = (x @ p.w_q).reshape(B, S, cfg.n_heads, cfg.head_dim)
    o = core(q, k, v).reshape(B, S, -1)
    return (torch.tanh(p.gate) * (o @ p.w_o).float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Block-level dispatch
# ---------------------------------------------------------------------------


def apply_ffn(block: Block, spec: BlockSpec, cfg: ModelConfig, x, dense_moe: bool = False):
    """The block's FFN half on the mixer's residual ``x``: ``(x, routing)``,
    the MoE layer's :class:`~repro_torch.models.moe.Routing` or ``None``."""
    if spec.ffn == NONE:
        return x, None
    h = rmsnorm(block.norm2, x, cfg.norm_eps)
    if spec.ffn == MOE:
        out, r = (moe_mod.moe_ffn_dense if dense_moe else moe_mod.moe_ffn)(block.ffn, h, cfg)
        return x + out, r
    return x + ffn(block.ffn, h, cfg.activation), None


def _gqa_params(block: Block, mixer: str, extras):
    return extras["shared"] if mixer == SHARED_ATTN else block.mixer


def block_train(block: Block, spec: BlockSpec, cfg: ModelConfig, x, extras=None, *,
                dense_moe: bool = False):
    h = rmsnorm(block.norm1, x, cfg.norm_eps)
    mixer = spec.mixer
    if mixer in (ATTN, ATTN_LOCAL, SHARED_ATTN):
        x = x + _gqa_train(_gqa_params(block, mixer, extras), mixer, cfg, h)
    elif mixer == MLA:
        x = x + mla_mod.mla_train(block.mixer, h, cfg)
    elif mixer == MAMBA2:
        x = x + ssm_mod.mamba2_forward(block.mixer, h, cfg)[0]
    elif mixer == CROSS:
        k, v = _cross_kv(block.mixer, extras["vision"], cfg)
        x = x + _cross_attend(block.mixer, cfg, h, k, v)
    x, r = apply_ffn(block, spec, cfg, x, dense_moe)
    aux = r.aux_loss() if r is not None else torch.zeros((), dtype=torch.float32,
                                                           device=x.device)
    return x, aux


def block_prefill(block: Block, spec: BlockSpec, cfg: ModelConfig, x, cache_len: int,
                  extras=None, *, dense_moe: bool = False):
    h = rmsnorm(block.norm1, x, cfg.norm_eps)
    mixer = spec.mixer
    if mixer in (ATTN, ATTN_LOCAL, SHARED_ATTN):
        y, cache = _gqa_prefill(_gqa_params(block, mixer, extras), mixer, cfg, h, cache_len)
    elif mixer == MLA:
        y, latent = mla_mod.mla_prefill(block.mixer, h, cfg, cache_len)
        cache = {"latent": latent}
    elif mixer == MAMBA2:
        y, (conv_x, conv_bc, state) = ssm_mod.mamba2_forward(block.mixer, h, cfg)
        cache = {"conv_x": conv_x, "conv_bc": conv_bc, "ssm": state}
    elif mixer == CROSS:
        k, v = _cross_kv(block.mixer, extras["vision"], cfg)
        cache = {"k": k, "v": v}
        y = _cross_attend(block.mixer, cfg, h, k, v)
    x, _ = apply_ffn(block, spec, cfg, x + y, dense_moe)
    return x, cache


def block_decode(block: Block, spec: BlockSpec, cfg: ModelConfig, x, cache, length: torch.Tensor,
                 extras=None, *, dense_moe: bool = False, phase: str = PLAIN):
    """One token through the block; ``cache`` is updated in place."""
    h = rmsnorm(block.norm1, x, cfg.norm_eps)
    mixer = spec.mixer
    if mixer in (ATTN, ATTN_LOCAL, SHARED_ATTN):
        y = _gqa_decode(_gqa_params(block, mixer, extras), mixer, cfg, h, cache, length, phase)
    elif mixer == MLA:
        y = mla_mod.mla_decode(block.mixer, h, cfg, cache["latent"], length)
    elif mixer == MAMBA2:
        y, states = ssm_mod.mamba2_decode(block.mixer, h, cfg, cache["conv_x"], cache["conv_bc"],
                                          cache["ssm"])
        for name, new in zip(("conv_x", "conv_bc", "ssm"), states):
            cache[name].copy_(new)
    elif mixer == CROSS:
        # one query: the einsums on the card too, as self-attention's decode
        # (cuDNN's SDPA kernel for it is not bitwise reproducible from run
        # to run inside the model)
        y = _cross_attend(block.mixer, cfg, h, cache["k"], cache["v"], cross_attention_plain)
    x, _ = apply_ffn(block, spec, cfg, x + y, dense_moe)
    return x


def init_block_cache(spec: BlockSpec, cfg: ModelConfig, batch: int, cache_len: int, device):
    # K/V caches hold this rank's KV heads under tensor parallelism (the run
    # time takes only the dense stack there: ATTN and ATTN_LOCAL)
    KV, hd, dt = cfg.n_kv_heads // tp_index()[1], cfg.head_dim, cfg.param_dtype
    mixer = spec.mixer
    if mixer == MLA:
        return {"latent": torch.zeros((batch, cache_len, cfg.kv_lora_rank + cfg.rope_head_dim),
                                      dtype=dt, device=device)}
    if mixer == MAMBA2:
        conv_x, conv_bc, state = ssm_mod.init_mamba2_state(cfg, batch, device)
        return {"conv_x": conv_x, "conv_bc": conv_bc, "ssm": state}
    if mixer == ATTN_LOCAL:
        shape = (batch, cfg.window, KV, hd)
    elif mixer in (ATTN, SHARED_ATTN):
        shape = (batch, cache_len, KV, hd)
    elif mixer == CROSS:
        shape = (batch, cfg.n_patches, KV, hd)
    else:
        raise ValueError(mixer)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
