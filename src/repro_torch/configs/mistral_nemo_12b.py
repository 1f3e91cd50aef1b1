"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx (hf:mistralai/Mistral-Nemo-Base-2407). head_dim 128,
rope θ=1M.
"""

from ..models.config import ATTN, DENSE, ModelConfig
from .base import FULL_ATTN_SHAPES, uniform_pattern

ARCH_ID = "mistral-nemo-12b"
SUPPORTED_SHAPES = FULL_ATTN_SHAPES


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        pattern=uniform_pattern(40, ATTN),
        rope_theta=1e6,
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
        dtype="float32",
    )
