"""Multi-head Latent Attention (DeepSeek-V2; counterpart of
``repro/models/mla.py``), deepseek-v2-lite's mixer.

K and V come from a shared latent ``c_kv`` of ``kv_lora_rank`` plus one
decoupled RoPE key of ``rope_head_dim`` per token; the decode cache holds
only ``kv_lora_rank + rope_head_dim`` values per token, the latent and the
already-roped key side by side. Prefill and decode decompress the latent
into per-head K (nope + rope) and V and attend, as the reference (the
absorbed-matmul form is a later performance lever). Q and K are
``nope + rope`` wide and V ``v_head_dim``, so the softmax scale is
``1/√(nope + rope)``, the reference's and SDPA's default alike.

Decode writes the new latent entry into the cache in place at ``length``
(a 0-d int on the device, read there), as the GQA decode does.

Under tensor parallelism (:func:`repro_torch.distributed.activation_sharding`)
a rank holds its ``H/m`` heads: the columns of ``w_q``, ``w_uk`` and
``w_uv`` and the rows of ``w_o``, the output summed over the model axis.
``w_dkv`` stays whole, so the latent cache is whole on every model rank;
its output ``c_kv`` and ``k_rope`` pass through ``copy_to_tp`` before the
rank's heads read them (their gradient is partial on each rank), while
``q``'s input passes through it as a column-sharded product's does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..distributed.sharding import copy_to_tp, reduce_from_tp
from .attention import attention_train, decode_attention, flash_attention
from .config import ModelConfig
from .layers import apply_rope, decode_positions, init_scale, param, positions

__all__ = ["MLA", "mla_decode", "mla_prefill", "mla_train"]


class MLA(nn.Module):
    """``w_q`` (D, H·(nope+rope)), ``w_dkv`` (D, r+rope), ``w_uk`` (r, H·nope),
    ``w_uv`` (r, H·v), ``w_o`` (H·v, D), each applied as ``x @ w``."""

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        D, H, dt, r = cfg.d_model, cfg.n_heads, cfg.param_dtype, cfg.kv_lora_rank
        nope, rope_d, v_d = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
        self.w_q = param(gen, (D, H * (nope + rope_d)), dt, device, init_scale(D))
        self.w_dkv = param(gen, (D, r + rope_d), dt, device, init_scale(D))
        self.w_uk = param(gen, (r, H * nope), dt, device, init_scale(r))
        self.w_uv = param(gen, (r, H * v_d), dt, device, init_scale(r))
        self.w_o = param(gen, (H * v_d, D), dt, device, init_scale(H * v_d))


def _project(p: MLA, x, pos, cfg: ModelConfig):
    """q (B, S, H, nope+rope) with RoPE on its rope part (this rank's heads
    under tensor parallelism), the latent c_kv (B, S, r), and one shared
    roped key k_rope (B, S, 1, rope)."""
    B, S, _ = x.shape
    nope, rope_d = cfg.nope_head_dim, cfg.rope_head_dim
    q = (copy_to_tp(x) @ p.w_q).reshape(B, S, -1, nope + rope_d)
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], pos, cfg.rope_theta)], dim=-1)
    dkv = x @ p.w_dkv  # (B, S, r + rope), whole on every rank
    c_kv, k_rope = dkv[..., : cfg.kv_lora_rank], dkv[..., cfg.kv_lora_rank :]
    return q, c_kv, apply_rope(k_rope[:, :, None, :], pos, cfg.rope_theta)


def _decompress(p: MLA, c_kv, k_rope, cfg: ModelConfig):
    """Latent → per-head K (nope, then the broadcast rope key) and V, for
    the heads this rank holds."""
    B, S, _ = c_kv.shape
    nope = cfg.nope_head_dim
    c_kv, k_rope = copy_to_tp(c_kv), copy_to_tp(k_rope)
    k_nope = (c_kv @ p.w_uk).reshape(B, S, -1, nope)
    H = k_nope.shape[2]
    v = (c_kv @ p.w_uv).reshape(B, S, H, cfg.v_head_dim)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, cfg.rope_head_dim)], dim=-1)
    return k, v


def mla_train(p: MLA, x, cfg: ModelConfig):
    """The training forward, through :func:`~repro_torch.models.attention.attention_train`."""
    B, S, _ = x.shape
    q, c_kv, k_rope = _project(p, x, positions(B, S, x.device), cfg)
    k, v = _decompress(p, c_kv, k_rope, cfg)
    o = attention_train(q, k, v, chunk=cfg.attn_chunk, impl=cfg.attn_impl)
    return reduce_from_tp(o.reshape(B, S, -1) @ p.w_o)


def mla_prefill(p: MLA, x, cfg: ModelConfig, cache_len: int):
    """Output and the latent cache (B, cache_len, r + rope): ``c_kv`` and the
    roped ``k_rope`` of the prompt's tokens, zeros past them."""
    B, S, _ = x.shape
    q, c_kv, k_rope = _project(p, x, positions(B, S, x.device), cfg)
    k, v = _decompress(p, c_kv, k_rope, cfg)
    o = flash_attention(q, k, v, chunk=cfg.attn_chunk)
    cache = torch.zeros((B, cache_len, cfg.kv_lora_rank + cfg.rope_head_dim), dtype=x.dtype,
                        device=x.device)
    cache[:, :S, : cfg.kv_lora_rank] = c_kv
    cache[:, :S, cfg.kv_lora_rank :] = k_rope[:, :, 0]
    return reduce_from_tp(o.reshape(B, S, -1) @ p.w_o), cache


def mla_decode(p: MLA, x, cfg: ModelConfig, cache: torch.Tensor, length: torch.Tensor):
    """x (B, 1, D); cache (B, Smax, r + rope), its entry at ``length`` (a 0-d
    int on the device) written in place; attends over the decompressed
    cache. Returns the output."""
    B = x.shape[0]
    q, c_kv, k_rope = _project(p, x, decode_positions(B, length), cfg)
    r = cfg.kv_lora_rank
    entry = torch.cat([c_kv, k_rope[:, :, 0]], dim=-1).to(cache.dtype)  # (B, 1, r + rope)
    cache.index_copy_(1, length.reshape(1).long(), entry)
    k, v = _decompress(p, cache[..., :r], cache[..., None, r:], cfg)
    o = decode_attention(q, k, v, length + 1)
    return reduce_from_tp(o.reshape(B, 1, -1) @ p.w_o)
