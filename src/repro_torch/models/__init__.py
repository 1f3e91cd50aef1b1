"""Decoder stack of the port (counterpart of ``repro/models``): GQA (also
shared across blocks), MLA, Mamba-2 SSD and cross-attention mixers, dense
and MoE FFNs, on a plain loop over layers; the modality stubs in
:mod:`repro_torch.models.modality`."""

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
from .ssm import Mamba2, init_mamba2_state, mamba2_decode, mamba2_forward, ssd_chunked
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
    "Mamba2", "init_mamba2_state", "mamba2_decode", "mamba2_forward", "ssd_chunked",
    "Transformer", "decode_step", "forward_hidden", "init_cache", "init_params",
    "layer_specs", "param_count", "prefill", "segments", "train_logits",
]
