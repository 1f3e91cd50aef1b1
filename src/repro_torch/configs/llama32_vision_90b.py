"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attn image layers (hf:meta-llama/Llama-3.2-11B-Vision
family scaled to 90B).

100 layers = 20 × [4 self-attn + 1 cross-attn]. The ViT tower is a STUB:
``input_specs`` provide precomputed patch embeddings (B, n_patches=2048,
d_vision=1280) which a learned projector lifts to d_model; cross layers
are tanh-gated (gate init 0) as in the reference model.
"""

from ..models.config import ATTN, CROSS, DENSE, BlockSpec, ModelConfig
from .base import FULL_ATTN_SHAPES

ARCH_ID = "llama-3.2-vision-90b"
SUPPORTED_SHAPES = FULL_ATTN_SHAPES


def _pattern(n_units: int, self_per_unit: int = 4):
    unit = [BlockSpec(ATTN, DENSE)] * self_per_unit + [BlockSpec(CROSS, DENSE)]
    return tuple(unit * n_units)


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        pattern=_pattern(20),
        rope_theta=5e5,
        d_vision=1280,
        n_patches=2048,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=_pattern(1),
        d_vision=32,
        n_patches=16,
        dtype="float32",
    )
