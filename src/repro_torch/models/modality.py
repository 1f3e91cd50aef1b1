"""Modality frontend stubs for the [audio] and [vlm] architectures
(counterpart of ``repro/models/modality.py``).

The backbone is real and the frontend a stub: the arch configs' inputs
are precomputed frame or patch embeddings, and these helpers draw matching
synthetic inputs from an explicit ``torch.Generator`` on a chosen device
(``None`` means the card, as every entry point of the port).

* musicgen-large: the EnCodec codec is the stub; the backbone takes codec
  token ids over its 2048-entry vocabulary, ordinary LM tokens.
* llama-3.2-vision-90b: the ViT tower is the stub; the cross-attention
  layers take patch embeddings (B, n_patches, d_vision).
"""

from __future__ import annotations

import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig

__all__ = ["synth_audio_tokens", "synth_patch_embeddings"]


def synth_audio_tokens(gen: torch.Generator, cfg: ModelConfig, batch: int, seq: int,
                       device: DeviceLike = None) -> torch.Tensor:
    """Stand-in for EnCodec's output: uniform codec token ids (B, seq) int32."""
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=resolve_device(device), dtype=torch.int32)


def synth_patch_embeddings(gen: torch.Generator, cfg: ModelConfig, batch: int,
                           device: DeviceLike = None) -> torch.Tensor:
    """Stand-in for the ViT tower's output: (B, n_patches, d_vision) standard
    normals drawn in fp32 and cast to the parameter dtype."""
    x = torch.randn((batch, cfg.n_patches, cfg.d_vision), generator=gen,
                    device=resolve_device(device), dtype=torch.float32)
    return x.to(cfg.param_dtype)
