"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 (arXiv:2412.08905). RoPE + SwiGLU + GQA, head_dim 128.
"""

from ..models.config import ATTN, DENSE, ModelConfig
from .base import FULL_ATTN_SHAPES, uniform_pattern

ARCH_ID = "phi4-mini-3.8b"
SUPPORTED_SHAPES = FULL_ATTN_SHAPES


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=200064,
        pattern=uniform_pattern(32, ATTN),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=3,
        d_model=48,
        n_heads=6,
        n_kv_heads=2,
        head_dim=8,
        d_ff=96,
        vocab_size=256,
        pattern=uniform_pattern(3, ATTN),
        dtype="float32",
    )
