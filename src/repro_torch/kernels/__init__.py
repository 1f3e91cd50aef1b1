"""Hand-written Hopper kernels of the port, their wrappers and plain versions."""

from .ops import (
    LAUNCHES,
    countsketch_apply,
    countsketch_fold,
    force_plain,
    kernel_route_enabled,
    panel_score,
    panel_update,
    reset_launches,
    twoside_sketch,
)
from .ref import countsketch_ref, panel_score_ref, panel_update_ref, twoside_sketch_ref

__all__ = [
    "LAUNCHES",
    "countsketch_apply",
    "countsketch_fold",
    "force_plain",
    "kernel_route_enabled",
    "panel_score",
    "panel_update",
    "reset_launches",
    "twoside_sketch",
    "countsketch_ref",
    "panel_score_ref",
    "panel_update_ref",
    "twoside_sketch_ref",
]
