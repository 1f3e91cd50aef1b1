"""Panel-streaming engine, sharding, adaptive CUR and resilient ingestion of
the port (counterpart of ``repro.stream``)."""

from .adaptive import (
    ADAPTIVE_CUR_OPS,
    AdaptiveCURCtx,
    AdaptiveRowState,
    adaptive_cur_finalize,
    adaptive_cur_init,
    allocate_shared_budget,
)
from .distributed import (
    merge_states,
    mesh_sharded_stream,
    shard_panel_ranges,
    simulate_sharded_stream,
)
from .engine import (
    PanelOps,
    PanelState,
    copy_selected_columns,
    fresh_state,
    padded_n,
    panel_update,
    scan_panels,
    stream_panels,
    truncated_R,
    with_quarantine,
    zero_nonfinite_panels,
)

# resilient ingestion (and the checkpoint module it needs) load on first use
_RESILIENT_EXPORTS = (
    "ArrayPanelSource",
    "FaultInjector",
    "FaultPlan",
    "InjectedCrash",
    "PanelSource",
    "QuarantineAbort",
    "StreamReport",
    "TransientReadError",
    "restore_stream_state",
    "run_resilient_sharded_stream",
    "run_resilient_stream",
    "save_stream_state",
)


def __getattr__(name):  # PEP 562
    if name in _RESILIENT_EXPORTS:
        from . import resilient as _resilient

        return getattr(_resilient, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    "mesh_sharded_stream",
    "padded_n",
    "panel_update",
    "scan_panels",
    "shard_panel_ranges",
    "simulate_sharded_stream",
    "stream_panels",
    "truncated_R",
    "with_quarantine",
    "zero_nonfinite_panels",
    *_RESILIENT_EXPORTS,
]
