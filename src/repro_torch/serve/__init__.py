"""Serving of the port (counterpart of ``repro.serve``): the generation
loop and the streaming-SVD KV-cache compression on the stacked Algorithm-3
engine. :mod:`~repro_torch.serve.kv_compress` compresses a finished
history per head batch, :mod:`~repro_torch.serve.kv_cache` keeps the
compression live during decode, :mod:`~repro_torch.serve.decode` drives
prefill and decode."""

from .decode import generate, sample_token
from .kv_cache import (CompressedKV, cache_nbytes, compress_prefill_cache, decode_schedule,
                       init_compressed_kv)
from .kv_compress import (
    KVCompressionConfig,
    LowRankKV,
    compress_head_batch,
    compress_history,
    compression_error,
    lowrank_decode_attention,
)

__all__ = [
    "CompressedKV", "KVCompressionConfig", "LowRankKV",
    "cache_nbytes", "compress_head_batch", "compress_history",
    "compress_prefill_cache", "compression_error", "decode_schedule", "generate",
    "init_compressed_kv", "lowrank_decode_attention", "sample_token",
]
