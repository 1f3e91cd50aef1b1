"""Serving driver: batched generation over prefill + decode_step
(counterpart of ``repro/serve/decode.py``).

The reference runs one fused compiled program per token; the port runs an
eager loop of :func:`~repro_torch.models.decode_step` (a CUDA graph of the
step is later work, ``ROADMAP.md`` §1). With ``kv_compress=`` the prefilled
global-attention caches become decode-native compressed caches
(:mod:`repro_torch.serve.kv_cache`) before the loop, and every decode step
folds the generated tokens into the streaming factorization.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..models import decode_step, prefill
from ..models.config import ModelConfig
from .kv_cache import compress_prefill_cache
from .kv_compress import KVCompressionConfig

__all__ = ["generate", "sample_token"]


def sample_token(gen: Optional[torch.Generator], logits: torch.Tensor,
                 temperature: float = 0.0) -> torch.Tensor:
    """logits (B, 1, V) → (B, 1) int32: the argmax at temperature 0 (ties
    to the lower index, as the reference's), else a draw from
    ``softmax(logits / temperature)`` with ``gen``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits[:, 0].float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


class _Clock:
    """Phase times of one :func:`generate` call in ms: CUDA events on the
    card (read once, at the end), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def read(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for (_, t0), (name, t1) in zip(self.marks, self.marks[1:]):
            out[name] = t0.elapsed_time(t1) if self.cuda else (t1 - t0) * 1e3
        return out


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt: torch.Tensor, n_tokens: int, *,
             gen: Optional[torch.Generator] = None, temperature: float = 0.0, vision=None,
             dense_moe: bool = False, kv_compress: Optional[KVCompressionConfig] = None,
             registry=None, kv_sketches: Optional[dict] = None,
             timings: Optional[dict] = None) -> torch.Tensor:
    """Greedy or temperature generation; prompt (B, S) on the model's
    device. Returns (B, n_tokens) int32. ``vision``: a vlm config's patch
    embeddings (B, n_patches, d_vision), read once, at prefill.

    ``gen`` draws the sampled tokens and, with ``kv_compress``, the
    compressed caches' sketches (``kv_sketches`` hands pre-drawn ones to
    :func:`~repro_torch.serve.kv_cache.compress_prefill_cache`); ``None``
    seeds 0 on the prompt's device. ``registry`` forwards a metrics
    registry to the conversion. ``timings``, when given, receives the ms
    of ``prefill``, ``convert`` and ``decode`` (all ``n_tokens − 1``
    steps).
    """
    if gen is None:
        gen = torch.Generator(device=prompt.device)
        gen.manual_seed(0)
    clock = _Clock(prompt.device)
    clock.mark("start")
    logits, cache = prefill(params, cfg, prompt, prompt.shape[1] + n_tokens, vision=vision,
                            dense_moe=dense_moe)
    clock.mark("prefill")
    if kv_compress is not None:
        cache = compress_prefill_cache(gen, cfg, cache, kv_compress, registry=registry,
                                       sketches=kv_sketches)
    clock.mark("convert")
    toks = [sample_token(gen, logits, temperature)]
    for _ in range(n_tokens - 1):
        logits, cache = decode_step(params, cfg, cache, toks[-1], dense_moe=dense_moe)
        toks.append(sample_token(gen, logits, temperature))
    clock.mark("decode")
    if timings is not None:
        timings.update(clock.read())
    return torch.cat(toks, dim=1)
