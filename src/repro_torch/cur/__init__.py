"""CUR decomposition of the port, symmetric CUR included (counterpart of ``repro.cur``)."""

from .selection import SELECTION_POLICIES, Selection, select_columns, select_rows
from .cur import (
    CURResult,
    cur_error_ratio,
    cur_reconstruct,
    cur_relative_error,
    cur_sketch_sizes,
    exact_cur,
    fast_cur,
)
from .streaming import (
    StreamingCURState,
    streaming_cur_finalize,
    streaming_cur_init,
    streaming_cur_update,
)
from .batched import batched_fast_cur, draw_shared_sketches
from .symmetric_cur import spsd_to_cur, symmetric_cur

_ADAPTIVE_EXPORTS = ("adaptive_cur_init", "adaptive_cur_finalize")


def __getattr__(name):  # PEP 562: adaptive CUR lives in repro_torch.stream, loaded on first use
    if name in _ADAPTIVE_EXPORTS:
        from ..stream import adaptive as _adaptive

        return getattr(_adaptive, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "SELECTION_POLICIES",
    "Selection",
    "select_columns",
    "select_rows",
    "CURResult",
    "cur_error_ratio",
    "cur_reconstruct",
    "cur_relative_error",
    "cur_sketch_sizes",
    "exact_cur",
    "fast_cur",
    "StreamingCURState",
    "streaming_cur_finalize",
    "streaming_cur_init",
    "streaming_cur_update",
    *_ADAPTIVE_EXPORTS,
    "batched_fast_cur",
    "draw_shared_sketches",
    "symmetric_cur",
    "spsd_to_cur",
]
