"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global attention, 128k context.

head_dim 256; local layers: 1024-token sliding window, rope θ=10k;
global layers: full attention, rope θ=1M. Local layers keep a ring-buffer
KV cache of window size → the 500k decode cell is dominated by the 8
global layers only, so we run long_500k for this arch (hybrid-attention;
see DESIGN.md §Arch-applicability).
"""

from ..models.config import ATTN, ATTN_LOCAL, DENSE, BlockSpec, ModelConfig
from .base import ALL_SHAPES

ARCH_ID = "gemma3-12b"
SUPPORTED_SHAPES = ALL_SHAPES


def _pattern(n_units: int):
    unit = [BlockSpec(ATTN_LOCAL, DENSE)] * 5 + [BlockSpec(ATTN, DENSE)]
    return tuple(unit * n_units)


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262144,
        pattern=_pattern(8),
        window=1024,
        rope_theta=1e4,
        rope_theta_global=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=_pattern(1),
        window=32,
        rope_theta=1e4,
        rope_theta_global=1e6,
        dtype="float32",
    )
