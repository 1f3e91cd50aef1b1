"""Residual blocks (counterpart of ``repro/models/blocks.py``): pre-norm
mixer plus pre-norm FFN, with per-kind caches.

The port has the GQA mixer for ``ATTN`` and ``ATTN_LOCAL``, the MLA mixer,
the dense FFN and the MoE FFN. Every block kind exposes, as the reference:

  init_block(gen, spec, cfg, device)                          → Block
  block_train(block, spec, cfg, x, extras, dense_moe)         → (x, aux_loss)
  block_prefill(block, spec, cfg, x, cache_len, extras, dense_moe) → (x, cache)
  block_decode(block, spec, cfg, x, cache, length, extras, dense_moe) → (x, cache)
  init_block_cache(spec, cfg, batch, cache_len, device)       → cache

and :func:`apply_ffn`, the FFN half alone (a spec with ``ffn=NONE`` runs
the mixer half alone). Only ``block_train`` forms MoE's aux loss; the
reference's ``block_prefill`` also returns it, and its compiler drops the
unused sum.

Cache layouts: ``attn`` K/V (B, cache_len, KV, hd), the full history;
``attn_local`` K/V (B, window, KV, hd), a ring; ``mla`` the latent
(B, cache_len, r + rope). Decode writes the new token into the cache in
place (the reference returns an updated copy); ``length`` is a host int.
A cache that is not a dict is a pluggable backend
(:class:`repro_torch.serve.kv_cache.CompressedKV`) that owns its append and
attention through ``append_attend``. ``dense_moe`` picks the MoE FFN's
dropless loop over its capacity-bounded dispatch.
"""

from __future__ import annotations

import torch
from torch import nn

from . import mla as mla_mod
from . import moe as moe_mod
from .attention import decode_attention, flash_attention
from .config import (ATTN, ATTN_LOCAL, CROSS, DENSE, MAMBA2, MLA, MOE, NONE, SHARED_ATTN,
                     BlockSpec, ModelConfig)
from .layers import FFN, apply_rope, ffn, init_scale, param, positions, rmsnorm

# mixers the port does not have yet, and the ROADMAP.md §1 item that ports them
UNPORTED = {
    MAMBA2: "5.2 (Mamba-2 SSD and shared attention)",
    SHARED_ATTN: "5.2 (Mamba-2 SSD and shared attention)",
    CROSS: "5.3 (cross-attention and the modality stubs)",
}


def _unported(kind: str):
    return NotImplementedError(
        f"{kind!r} blocks are not ported yet: ROADMAP.md §1 item {UNPORTED[kind]}")


def _ones(d, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones((d,), dtype=dtype, device=device), requires_grad=False)


class GQA(nn.Module):
    """Grouped-query attention projections, each applied as ``x @ w``."""

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        D, H, KV, hd, dt = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.param_dtype
        self.w_q = param(gen, (D, H * hd), dt, device, init_scale(D))
        self.w_k = param(gen, (D, KV * hd), dt, device, init_scale(D))
        self.w_v = param(gen, (D, KV * hd), dt, device, init_scale(D))
        self.w_o = param(gen, (H * hd, D), dt, device, init_scale(H * hd))


class Block(nn.Module):
    """One residual layer's parameters: ``norm1``, ``mixer`` (:class:`GQA` or
    :class:`~repro_torch.models.mla.MLA`), ``norm2``, ``ffn`` (:class:`FFN` or
    :class:`~repro_torch.models.moe.MoE`)."""

    def __init__(self, gen, spec: BlockSpec, cfg: ModelConfig, device):
        super().__init__()
        if spec.mixer not in (ATTN, ATTN_LOCAL, MLA):
            raise _unported(spec.mixer)
        self.norm1 = _ones(cfg.d_model, cfg.param_dtype, device)
        if spec.mixer == MLA:
            self.mixer = mla_mod.MLA(gen, cfg, device)
        else:
            self.mixer = GQA(gen, cfg, device)
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
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p.w_q).reshape(B, S, H, hd)
    k = (x @ p.w_k).reshape(B, S, KV, hd)
    v = (x @ p.w_v).reshape(B, S, KV, hd)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def _gqa_train(p: GQA, spec_mixer, cfg: ModelConfig, x):
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(p, x, positions(B, S, x.device), cfg, _theta_for(spec_mixer, cfg))
    window = cfg.window if spec_mixer == ATTN_LOCAL else None
    o = flash_attention(q, k, v, window=window, chunk=cfg.attn_chunk)
    return o.reshape(B, S, -1) @ p.w_o


def _gqa_prefill(p: GQA, spec_mixer, cfg: ModelConfig, x, cache_len: int):
    B, S, _ = x.shape
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
    return o.reshape(B, S, -1) @ p.w_o, cache


def _gqa_decode(p: GQA, spec_mixer, cfg: ModelConfig, x, cache, length: int):
    B = x.shape[0]
    q, k, v = _gqa_qkv(p, x, positions(B, 1, x.device, length), cfg,
                       _theta_for(spec_mixer, cfg))
    if not isinstance(cache, dict):
        # pluggable cache backend: owns its append and attention
        o, cache = cache.append_attend(q, k, v, length)
        return o.reshape(B, 1, -1) @ p.w_o, cache
    if spec_mixer == ATTN_LOCAL:
        # ring: slots below min(length + 1, window) are valid, all within the window
        w = cfg.window
        cache["k"][:, length % w] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, length % w] = v[:, 0].to(cache["v"].dtype)
        o = decode_attention(q, cache["k"], cache["v"], min(length + 1, w))
    else:
        cache["k"][:, length] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, length] = v[:, 0].to(cache["v"].dtype)
        o = decode_attention(q, cache["k"], cache["v"], length + 1)
    return o.reshape(B, 1, -1) @ p.w_o, cache


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


def block_train(block: Block, spec: BlockSpec, cfg: ModelConfig, x, extras=None, *,
                dense_moe: bool = False):
    h = rmsnorm(block.norm1, x, cfg.norm_eps)
    if spec.mixer == MLA:
        x = x + mla_mod.mla_train(block.mixer, h, cfg)
    else:
        x = x + _gqa_train(block.mixer, spec.mixer, cfg, h)
    x, r = apply_ffn(block, spec, cfg, x, dense_moe)
    aux = r.aux_loss() if r is not None else torch.zeros((), dtype=torch.float32,
                                                           device=x.device)
    return x, aux


def block_prefill(block: Block, spec: BlockSpec, cfg: ModelConfig, x, cache_len: int,
                  extras=None, *, dense_moe: bool = False):
    h = rmsnorm(block.norm1, x, cfg.norm_eps)
    if spec.mixer == MLA:
        y, latent = mla_mod.mla_prefill(block.mixer, h, cfg, cache_len)
        cache = {"latent": latent}
    else:
        y, cache = _gqa_prefill(block.mixer, spec.mixer, cfg, h, cache_len)
    x, _ = apply_ffn(block, spec, cfg, x + y, dense_moe)
    return x, cache


def block_decode(block: Block, spec: BlockSpec, cfg: ModelConfig, x, cache, length: int,
                 extras=None, *, dense_moe: bool = False):
    h = rmsnorm(block.norm1, x, cfg.norm_eps)
    if spec.mixer == MLA:
        y, latent = mla_mod.mla_decode(block.mixer, h, cfg, cache["latent"], length)
        cache = {"latent": latent}
    else:
        y, cache = _gqa_decode(block.mixer, spec.mixer, cfg, h, cache, length)
    x, _ = apply_ffn(block, spec, cfg, x + y, dense_moe)
    return x, cache


def init_block_cache(spec: BlockSpec, cfg: ModelConfig, batch: int, cache_len: int, device):
    KV, hd, dt = cfg.n_kv_heads, cfg.head_dim, cfg.param_dtype
    if spec.mixer == MLA:
        return {"latent": torch.zeros((batch, cache_len, cfg.kv_lora_rank + cfg.rope_head_dim),
                                      dtype=dt, device=device)}
    if spec.mixer == ATTN_LOCAL:
        shape = (batch, cfg.window, KV, hd)
    elif spec.mixer == ATTN:
        shape = (batch, cache_len, KV, hd)
    else:
        raise _unported(spec.mixer)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
