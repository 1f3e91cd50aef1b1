"""Panel-streaming engine and adaptive CUR of the port (counterpart of ``repro.stream``)."""

from .adaptive import ADAPTIVE_CUR_OPS, AdaptiveCURCtx, adaptive_cur_finalize, adaptive_cur_init
from .engine import (
    PanelOps,
    PanelState,
    copy_selected_columns,
    padded_n,
    panel_update,
    stream_panels,
    truncated_R,
    with_quarantine,
)

__all__ = [
    "ADAPTIVE_CUR_OPS",
    "AdaptiveCURCtx",
    "PanelOps",
    "PanelState",
    "adaptive_cur_finalize",
    "adaptive_cur_init",
    "copy_selected_columns",
    "padded_n",
    "panel_update",
    "stream_panels",
    "truncated_R",
    "with_quarantine",
]
