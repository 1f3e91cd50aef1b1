"""Architecture registry: ``--arch <id>`` → config module (the port's copy of
``repro/configs``: data only, the same ten architectures).

>>> from repro_torch.configs import get_arch, ARCH_IDS
>>> cfg = get_arch("llama3.2-1b").full_config()
"""

from __future__ import annotations

from . import (
    base,
    deepseek_v2_lite,
    gemma3_12b,
    kimi_k2,
    llama32_1b,
    llama32_vision_90b,
    mamba2_1p3b,
    mistral_nemo_12b,
    musicgen_large,
    phi4_mini,
    zamba2_1p2b,
)
from .base import ALL_SHAPES, FULL_ATTN_SHAPES, SHAPES, ShapeCell

_MODULES = (
    mamba2_1p3b,
    zamba2_1p2b,
    kimi_k2,
    deepseek_v2_lite,
    llama32_1b,
    phi4_mini,
    gemma3_12b,
    mistral_nemo_12b,
    musicgen_large,
    llama32_vision_90b,
)

ARCHS = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(ARCHS)


def get_arch(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return ARCHS[arch_id]


def supported_cells():
    """All (arch, shape) dry-run cells, including documented skips."""
    cells = []
    for arch_id, mod in ARCHS.items():
        for shape in ALL_SHAPES:
            cells.append((arch_id, shape, shape in mod.SUPPORTED_SHAPES))
    return cells
