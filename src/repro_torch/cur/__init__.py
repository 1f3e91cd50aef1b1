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
from .streaming import streaming_cur_finalize, streaming_cur_init, streaming_cur_update
from .batched import batched_fast_cur, draw_shared_sketches
from .symmetric_cur import spsd_to_cur, symmetric_cur

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
    "streaming_cur_finalize",
    "streaming_cur_init",
    "streaming_cur_update",
    "batched_fast_cur",
    "draw_shared_sketches",
    "symmetric_cur",
    "spsd_to_cur",
]
