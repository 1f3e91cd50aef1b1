"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408(expert)
vocab=102400, MoE 64e top-6 + 2 shared experts, MLA kv_lora=512
(arXiv:2405.04434).

MLA head dims: nope 128 + decoupled rope 64, v 128. Layer 0 dense
(d_ff 10944), layers 1–26 MoE. (The assignment note "160 routed" conflicts
with its own header "MoE 64e"; we follow the header, which matches the
HF deepseek-v2-lite card.)
"""

from ..models.config import DENSE, MLA, MOE, BlockSpec, ModelConfig
from .base import FULL_ATTN_SHAPES

ARCH_ID = "deepseek-v2-lite-16b"
SUPPORTED_SHAPES = FULL_ATTN_SHAPES  # MLA is full attention → long_500k skipped


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=192,  # nope 128 + rope 64
        d_ff=10944,  # dense first layer
        vocab_size=102400,
        pattern=(BlockSpec(MLA, DENSE),) + tuple(BlockSpec(MLA, MOE) for _ in range(26)),
        kv_lora_rank=512,
        nope_head_dim=128,
        rope_head_dim=64,
        v_head_dim=128,
        n_experts=64,
        n_shared_experts=2,
        moe_top_k=6,
        d_ff_expert=1408,
        moe_dispatch_shards=16,  # §Perf B5
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=24,
        d_ff=128,
        vocab_size=256,
        pattern=(BlockSpec(MLA, DENSE),) + tuple(BlockSpec(MLA, MOE) for _ in range(2)),
        kv_lora_rank=32,
        nope_head_dim=16,
        rope_head_dim=8,
        v_head_dim=16,
        n_experts=8,
        n_shared_experts=2,
        moe_top_k=2,
        d_ff_expert=32,
        dtype="float32",
    )
