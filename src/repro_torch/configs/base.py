"""Config substrate: assigned input shapes + registry helpers.

Each arch module defines ``full_config()`` (exact assignment numbers),
``smoke_config()`` (reduced same-family config for CPU tests), and
``SUPPORTED_SHAPES``. The four assigned LM shape cells:

  train_4k     seq=4096    global_batch=256   (train_step)
  prefill_32k  seq=32768   global_batch=32    (prefill)
  decode_32k   seq=32768   global_batch=128   (serve_step: 1 token vs cache)
  long_500k    seq=524288  global_batch=1     (serve_step; sub-quadratic only)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..models.config import (
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
)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

ALL_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# pure full-attention archs skip long_500k (assignment rule; see DESIGN.md §Arch-applicability)
FULL_ATTN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def uniform_pattern(n: int, mixer: str, ffn: str = DENSE) -> Tuple[BlockSpec, ...]:
    return tuple(BlockSpec(mixer, ffn) for _ in range(n))
