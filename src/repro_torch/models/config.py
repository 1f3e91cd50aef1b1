"""Unified model configuration (counterpart of ``repro/models/config.py``).

A model is a *pattern* of residual blocks. Each block has a mixer
(attention variant / Mamba-2 SSD / cross-attention) and an optional FFN
(dense SwiGLU/GELU or MoE). The reference compiles the pattern into repeated
*segments* for ``lax.scan``; the port runs a plain loop over layers, but
keeps the segments: parameter conversion, cache layouts and the KV
compressor's per-segment head batches follow them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

# Mixer kinds
ATTN = "attn"            # GQA + RoPE, full causal
ATTN_LOCAL = "attn_local"  # GQA + RoPE, sliding window
MLA = "mla"              # DeepSeek-V2 multi-head latent attention
MAMBA2 = "mamba2"        # Mamba-2 SSD
CROSS = "cross"          # cross-attention over modality embeddings
SHARED_ATTN = "shared_attn"  # Zamba2-style block with weights shared across occurrences

# FFN kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One residual layer: (mixer, ffn)."""

    mixer: str
    ffn: str = DENSE

    @property
    def signature(self) -> Tuple[str, str]:
        return (self.mixer, self.ffn)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Every field of the reference's ``ModelConfig``, with the same defaults."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[BlockSpec, ...]

    head_dim: int = 128
    # Attention
    rope_theta: float = 1e4
    rope_theta_global: Optional[float] = None  # per-layer override for global layers
    window: Optional[int] = None  # sliding window for ATTN_LOCAL
    attn_chunk: int = 512  # online-softmax block size
    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # Mamba-2 SSD
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dispatch_shards: int = 1
    # Modality (vlm/audio stubs)
    d_vision: int = 0
    n_patches: int = 0
    # Numerics
    dtype: str = "bfloat16"
    activation: str = "silu"  # silu (SwiGLU) | gelu
    # attention autodiff implementation (the training slice reads it)
    attn_impl: str = "custom_vjp"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    logit_softcap: Optional[float] = None

    # ---- derived ----
    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def param_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    def __post_init__(self):
        if len(self.pattern) != self.n_layers:
            raise ValueError(
                f"{self.name}: pattern has {len(self.pattern)} blocks, n_layers={self.n_layers}"
            )

    def validate_tpu_alignment(self):
        """The reference's warn-level checks that its TP-sharded dims are
        128-multiples (kept so the two configs answer alike)."""
        issues = []
        if self.n_heads and (self.n_heads * self.head_dim) % 128:
            issues.append(f"attn width {self.n_heads * self.head_dim} not 128-aligned")
        if self.d_ff % 128:
            issues.append(f"d_ff {self.d_ff} not 128-aligned")
        return issues


@dataclasses.dataclass(frozen=True)
class Segment:
    """A run of layers expressed as (unit pattern) × n_repeat."""

    unit: Tuple[BlockSpec, ...]
    n_repeat: int


def compile_pattern(pattern: Sequence[BlockSpec], max_unit: int = 8) -> Tuple[Segment, ...]:
    """Factor a layer pattern into segments, as the reference does.

    Finds the smallest unit length u ≤ max_unit such that a maximal suffix
    of the pattern is a whole number of u-sized repeats of one unit; any
    non-conforming prefix becomes its own (unit, 1) segments.
    """
    n = len(pattern)
    best = None  # (cost, prefix_len, unit_len), cost = prefix_len + unit_len
    for u in range(1, max_unit + 1):
        for prefix in range(0, n):
            if (n - prefix) % u:
                continue
            unit = tuple(pattern[prefix : prefix + u])
            reps = (n - prefix) // u
            if all(
                pattern[prefix + i * u + j].signature == unit[j].signature
                for i in range(reps)
                for j in range(u)
            ):
                cost = prefix + u
                if best is None or cost < best[0]:
                    best = (cost, prefix, u)
                break  # smallest prefix for this u
    if best is None:
        raise ValueError("empty pattern")
    _, prefix, u = best
    segments = [Segment(unit=(pattern[i],), n_repeat=1) for i in range(prefix)]
    reps = (n - prefix) // u
    if reps:
        segments.append(Segment(unit=tuple(pattern[prefix : prefix + u]), n_repeat=reps))
    return tuple(segments)
