"""Residual blocks (counterpart of ``repro/models/blocks.py``): pre-norm
mixer plus pre-norm FFN, with per-kind caches.

The port has the GQA mixer for ``ATTN`` and ``ATTN_LOCAL`` and the dense
FFN. Every block kind exposes, as the reference:

  init_block(gen, spec, cfg, device)                          → Block
  block_train(block, spec, cfg, x, extras)                    → (x, aux_loss)
  block_prefill(block, spec, cfg, x, cache_len, extras)       → (x, aux, cache)
  block_decode(block, spec, cfg, x, cache, length, extras)    → (x, cache)
  init_block_cache(spec, cfg, batch, cache_len, device)       → cache

Cache layouts: ``attn`` K/V (B, cache_len, KV, hd), the full history;
``attn_local`` K/V (B, window, KV, hd), a ring. Decode writes the new
token into the cache in place (the reference returns an updated copy);
``length`` is a host int. A cache that is not a dict is a pluggable
backend (:class:`repro_torch.serve.kv_cache.CompressedKV`) that owns its
append and attention through ``append_attend``.
"""

from __future__ import annotations

import torch
from torch import nn

from .attention import decode_attention, flash_attention
from .config import (ATTN, ATTN_LOCAL, CROSS, DENSE, MAMBA2, MLA, MOE, NONE, SHARED_ATTN,
                     BlockSpec, ModelConfig)
from .layers import apply_rope, ffn, init_scale, rmsnorm, truncated_normal_

# mixers and FFNs the port does not have yet, and the ROADMAP.md §1 item that ports them
UNPORTED = {
    MLA: "5.1 (MoE and MLA)",
    MOE: "5.1 (MoE and MLA)",
    MAMBA2: "5.2 (Mamba-2 SSD and shared attention)",
    SHARED_ATTN: "5.2 (Mamba-2 SSD and shared attention)",
    CROSS: "5.3 (cross-attention and the modality stubs)",
}


def _unported(kind: str):
    return NotImplementedError(
        f"{kind!r} blocks are not ported yet: ROADMAP.md §1 item {UNPORTED[kind]}")


def _param(gen, shape, dtype, device, scale) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    return nn.Parameter(truncated_normal_(t, gen, scale), requires_grad=False)


def _ones(d, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones((d,), dtype=dtype, device=device), requires_grad=False)


class GQA(nn.Module):
    """Grouped-query attention projections, each applied as ``x @ w``."""

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        D, H, KV, hd, dt = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.param_dtype
        self.w_q = _param(gen, (D, H * hd), dt, device, init_scale(D))
        self.w_k = _param(gen, (D, KV * hd), dt, device, init_scale(D))
        self.w_v = _param(gen, (D, KV * hd), dt, device, init_scale(D))
        self.w_o = _param(gen, (H * hd, D), dt, device, init_scale(H * hd))


class FFN(nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or the GELU MLP (no gate)."""

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        D, F, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
        if cfg.activation == "silu":
            self.w_gate = _param(gen, (D, F), dt, device, init_scale(D))
        self.w_up = _param(gen, (D, F), dt, device, init_scale(D))
        self.w_down = _param(gen, (F, D), dt, device, init_scale(F))


class Block(nn.Module):
    """One residual layer's parameters: ``norm1``, ``mixer``, ``norm2``, ``ffn``."""

    def __init__(self, gen, spec: BlockSpec, cfg: ModelConfig, device):
        super().__init__()
        if spec.mixer not in (ATTN, ATTN_LOCAL):
            raise _unported(spec.mixer)
        if spec.ffn not in (DENSE, NONE):
            raise _unported(spec.ffn)
        self.norm1 = _ones(cfg.d_model, cfg.param_dtype, device)
        self.mixer = GQA(gen, cfg, device)
        if spec.ffn == DENSE:
            self.norm2 = _ones(cfg.d_model, cfg.param_dtype, device)
            self.ffn = FFN(gen, cfg, device)


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


def _positions(B: int, S: int, device, start: int = 0):
    return torch.arange(start, start + S, device=device)[None].expand(B, S)


def _gqa_train(p: GQA, spec_mixer, cfg: ModelConfig, x):
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(p, x, _positions(B, S, x.device), cfg, _theta_for(spec_mixer, cfg))
    window = cfg.window if spec_mixer == ATTN_LOCAL else None
    o = flash_attention(q, k, v, window=window, chunk=cfg.attn_chunk)
    return o.reshape(B, S, -1) @ p.w_o


def _gqa_prefill(p: GQA, spec_mixer, cfg: ModelConfig, x, cache_len: int):
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(p, x, _positions(B, S, x.device), cfg, _theta_for(spec_mixer, cfg))
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
    q, k, v = _gqa_qkv(p, x, _positions(B, 1, x.device, length), cfg,
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


def _apply_ffn(block: Block, spec: BlockSpec, cfg: ModelConfig, x):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == NONE:
        return x, aux
    h = rmsnorm(block.norm2, x, cfg.norm_eps)
    return x + ffn(block.ffn, h, cfg.activation), aux


def block_train(block: Block, spec: BlockSpec, cfg: ModelConfig, x, extras=None):
    h = rmsnorm(block.norm1, x, cfg.norm_eps)
    x = x + _gqa_train(block.mixer, spec.mixer, cfg, h)
    return _apply_ffn(block, spec, cfg, x)


def block_prefill(block: Block, spec: BlockSpec, cfg: ModelConfig, x, cache_len: int,
                  extras=None):
    h = rmsnorm(block.norm1, x, cfg.norm_eps)
    y, cache = _gqa_prefill(block.mixer, spec.mixer, cfg, h, cache_len)
    x, aux = _apply_ffn(block, spec, cfg, x + y)
    return x, aux, cache


def block_decode(block: Block, spec: BlockSpec, cfg: ModelConfig, x, cache, length: int,
                 extras=None):
    h = rmsnorm(block.norm1, x, cfg.norm_eps)
    y, cache = _gqa_decode(block.mixer, spec.mixer, cfg, h, cache, length)
    x, _ = _apply_ffn(block, spec, cfg, x + y)
    return x, cache


def init_block_cache(spec: BlockSpec, cfg: ModelConfig, batch: int, cache_len: int, device):
    KV, hd, dt = cfg.n_kv_heads, cfg.head_dim, cfg.param_dtype
    if spec.mixer == ATTN_LOCAL:
        shape = (batch, cfg.window, KV, hd)
    elif spec.mixer == ATTN:
        shape = (batch, cache_len, KV, hd)
    else:
        raise _unported(spec.mixer)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
