"""Panel-streaming engine and adaptive CUR of the port (counterpart of ``repro.stream``)."""

from .adaptive import ADAPTIVE_CUR_OPS, adaptive_cur_finalize, adaptive_cur_init
from .engine import PanelOps, PanelState, panel_update, stream_panels, truncated_R, with_quarantine

__all__ = [
    "ADAPTIVE_CUR_OPS",
    "PanelOps",
    "PanelState",
    "adaptive_cur_finalize",
    "adaptive_cur_init",
    "panel_update",
    "stream_panels",
    "truncated_R",
    "with_quarantine",
]
