"""Decoder stack of the port (counterpart of ``repro/models``): GQA and MLA
mixers, dense and MoE FFNs, on a plain loop over layers. Mamba-2,
cross-attention and shared attention raise ``NotImplementedError`` naming
the ``ROADMAP.md`` item that ports them."""

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
from .mla import MLA, mla_decode, mla_prefill, mla_train
from .moe import MoE, Routing, moe_capacity, moe_ffn, moe_ffn_dense
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
    "MLA", "mla_decode", "mla_prefill", "mla_train",
    "MoE", "Routing", "moe_capacity", "moe_ffn", "moe_ffn_dense",
    "Transformer", "decode_step", "forward_hidden", "init_cache", "init_params",
    "layer_specs", "param_count", "prefill", "segments", "train_logits",
]
