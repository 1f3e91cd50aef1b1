"""Decoder stack of the port (counterpart of ``repro/models``): the dense
GQA blocks on a plain loop over layers. MLA, MoE, Mamba-2, cross-attention
and shared attention raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that ports them."""

from .config import (
    ATTN,
    ATTN_LOCAL,
    CROSS,
    DENSE,
    MAMBA2,
    MLA,
    MOE,
    NONE,
    SHARED_ATTN,
    BlockSpec,
    ModelConfig,
    Segment,
    compile_pattern,
)
from .transformer import (
    Transformer,
    decode_step,
    forward_hidden,
    init_cache,
    init_params,
    layer_specs,
    param_count,
    prefill,
    segments,
    train_logits,
)

__all__ = [
    "ATTN", "ATTN_LOCAL", "CROSS", "DENSE", "MAMBA2", "MLA", "MOE", "NONE", "SHARED_ATTN",
    "BlockSpec", "ModelConfig", "Segment", "compile_pattern",
    "Transformer", "decode_step", "forward_hidden", "init_cache", "init_params",
    "layer_specs", "param_count", "prefill", "segments", "train_logits",
]
