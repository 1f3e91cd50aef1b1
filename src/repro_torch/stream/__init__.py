"""Panel-streaming engine, in-process sharding and adaptive CUR of the port
(counterpart of ``repro.stream``)."""

from .adaptive import (
    ADAPTIVE_CUR_OPS,
    AdaptiveCURCtx,
    AdaptiveRowState,
    adaptive_cur_finalize,
    adaptive_cur_init,
    allocate_shared_budget,
)
from .distributed import merge_states, shard_panel_ranges, simulate_sharded_stream
from .engine import (
    PanelOps,
    PanelState,
    copy_selected_columns,
    fresh_state,
    padded_n,
    panel_update,
    stream_panels,
    truncated_R,
    with_quarantine,
    zero_nonfinite_panels,
)

__all__ = [
    "ADAPTIVE_CUR_OPS",
    "AdaptiveCURCtx",
    "AdaptiveRowState",
    "PanelOps",
    "PanelState",
    "adaptive_cur_finalize",
    "adaptive_cur_init",
    "allocate_shared_budget",
    "copy_selected_columns",
    "fresh_state",
    "merge_states",
    "padded_n",
    "panel_update",
    "shard_panel_ranges",
    "simulate_sharded_stream",
    "stream_panels",
    "truncated_R",
    "with_quarantine",
    "zero_nonfinite_panels",
]
