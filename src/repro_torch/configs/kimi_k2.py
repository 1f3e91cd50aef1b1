"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384 experts top-8 (+1 shared) — trillion-param MoE.

Layer 0 is dense (d_ff 18432, the DeepSeek-V3-lineage warmup layer);
layers 1–60 are MoE. head_dim=128 → 8192 attention width.
"""

from ..models.config import ATTN, DENSE, MOE, BlockSpec, ModelConfig
from .base import FULL_ATTN_SHAPES

ARCH_ID = "kimi-k2-1t-a32b"
SUPPORTED_SHAPES = FULL_ATTN_SHAPES  # pure full attention → long_500k skipped


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=18432,  # dense warmup layer
        vocab_size=163840,
        pattern=(BlockSpec(ATTN, DENSE),) + tuple(BlockSpec(ATTN, MOE) for _ in range(60)),
        n_experts=384,
        n_shared_experts=1,
        moe_top_k=8,
        d_ff_expert=2048,
        rope_theta=5e4,
        moe_dispatch_shards=16,  # §Perf B5: dispatch local per data rank
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        pattern=(BlockSpec(ATTN, DENSE),) + tuple(BlockSpec(ATTN, MOE) for _ in range(2)),
        n_experts=8,
        n_shared_experts=1,
        moe_top_k=2,
        d_ff_expert=32,
        dtype="float32",
    )
