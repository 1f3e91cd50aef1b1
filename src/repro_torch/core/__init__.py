"""Sketches, leverage scores and GMR solves of the port (counterpart of ``repro.core``)."""

from .gmr import error_ratio, exact_gmr, fast_gmr_core
from .leverage import approx_leverage_scores, leverage_scores
from .sketching import (
    ComposedSketch,
    CountSketch,
    GaussianSketch,
    OSNAPSketch,
    RowSampling,
    SRHTSketch,
    draw_sketch,
    fwht,
)

__all__ = [
    "ComposedSketch",
    "CountSketch",
    "GaussianSketch",
    "OSNAPSketch",
    "RowSampling",
    "SRHTSketch",
    "draw_sketch",
    "fwht",
    "approx_leverage_scores",
    "leverage_scores",
    "error_ratio",
    "exact_gmr",
    "fast_gmr_core",
]
