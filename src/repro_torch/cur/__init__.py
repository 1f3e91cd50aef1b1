"""CUR decomposition of the port (counterpart of ``repro.cur``)."""

from .cur import (
    CURResult,
    cur_error_ratio,
    cur_reconstruct,
    cur_relative_error,
    cur_sketch_sizes,
    exact_cur,
)
from .selection import select_columns, select_rows
from .streaming import streaming_cur_finalize, streaming_cur_init, streaming_cur_update

__all__ = [
    "CURResult",
    "cur_error_ratio",
    "cur_reconstruct",
    "cur_relative_error",
    "cur_sketch_sizes",
    "exact_cur",
    "select_columns",
    "select_rows",
    "streaming_cur_finalize",
    "streaming_cur_init",
    "streaming_cur_update",
]
