"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64. Mamba2 backbone + *shared* attention blocks
(arXiv:2411.15242): one attention+FFN block whose weights are reused at
every attention position — the Zamba signature.

Pattern: 2 mamba prefix + 6 × [5 mamba + 1 shared-attn] (shared positions
7, 13, 19, 25, 31, 37).
"""

from ..models.config import DENSE, MAMBA2, NONE, SHARED_ATTN, BlockSpec, ModelConfig
from .base import ALL_SHAPES

ARCH_ID = "zamba2-1.2b"
SUPPORTED_SHAPES = ALL_SHAPES  # hybrid → long_500k runs


def _pattern(n_mamba_prefix: int, n_units: int, unit_mamba: int):
    pat = [BlockSpec(MAMBA2, NONE)] * n_mamba_prefix
    for _ in range(n_units):
        pat += [BlockSpec(MAMBA2, NONE)] * unit_mamba + [BlockSpec(SHARED_ATTN, DENSE)]
    return tuple(pat)


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        pattern=_pattern(2, 6, 5),
        ssm_state=64,
        ssm_heads=64,
        ssm_head_dim=64,
        ssm_groups=1,
        ssm_expand=2,
        ssm_chunk=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=_pattern(2, 2, 2),
        ssm_state=16,
        ssm_heads=4,
        ssm_head_dim=32,
        ssm_groups=1,
        ssm_expand=2,
        ssm_chunk=16,
        dtype="float32",
    )
