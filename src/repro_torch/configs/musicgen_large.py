"""musicgen-large [audio] — 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048, decoder-only over EnCodec tokens (arXiv:2306.05284).

Backbone only per the assignment: the EnCodec codec is a STUB; inputs are
codec token ids over the 2048-entry vocabulary
(the reference's models/modality.py, synth_audio_tokens). head_dim 64, GELU FFN (the
MusicGen transformer uses non-gated GELU MLPs).
"""

from ..models.config import ATTN, DENSE, ModelConfig
from .base import FULL_ATTN_SHAPES, uniform_pattern

ARCH_ID = "musicgen-large"
SUPPORTED_SHAPES = FULL_ATTN_SHAPES


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        pattern=uniform_pattern(48, ATTN),
        activation="gelu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="audio",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=64,
        pattern=uniform_pattern(3, ATTN),
        activation="gelu",
        dtype="float32",
    )
