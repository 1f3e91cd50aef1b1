"""mamba2-1.3b [ssm] — 48L d_model=2048 (attn-free) vocab=50280, ssm_state=128.

SSD (state-space duality), arXiv:2405.21060. d_inner = 2·d_model = 4096,
64 heads of dim 64, 1 B/C group, chunk 256 (the reference Mamba-2 1.3b
hyper-parameters).
"""

from ..models.config import MAMBA2, NONE, ModelConfig
from .base import ALL_SHAPES, uniform_pattern

ARCH_ID = "mamba2-1.3b"
SUPPORTED_SHAPES = ALL_SHAPES  # SSM decode is O(1)-state → long_500k runs


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        pattern=uniform_pattern(48, MAMBA2, NONE),
        ssm_state=128,
        ssm_heads=64,
        ssm_head_dim=64,
        ssm_groups=1,
        ssm_expand=2,
        ssm_chunk=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=256,
        pattern=uniform_pattern(4, MAMBA2, NONE),
        ssm_state=16,
        ssm_heads=4,
        ssm_head_dim=32,
        ssm_groups=1,
        ssm_expand=2,
        ssm_chunk=16,
        dtype="float32",
    )
