"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 (hf:meta-llama/Llama-3.2-1B). head_dim 64, tied embeddings,
rope_theta 500k.
"""

from ..models.config import ATTN, DENSE, ModelConfig
from .base import FULL_ATTN_SHAPES, uniform_pattern

ARCH_ID = "llama3.2-1b"
SUPPORTED_SHAPES = FULL_ATTN_SHAPES


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=128256,
        pattern=uniform_pattern(16, ATTN),
        rope_theta=5e5,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=uniform_pattern(3, ATTN),
        tie_embeddings=True,
        dtype="float32",
    )
