"""Sketches and GMR solves of the port (counterpart of ``repro.core``)."""

from .gmr import error_ratio, exact_gmr, fast_gmr_core
from .sketching import CountSketch, GaussianSketch, OSNAPSketch, draw_sketch

__all__ = [
    "CountSketch",
    "GaussianSketch",
    "OSNAPSketch",
    "draw_sketch",
    "error_ratio",
    "exact_gmr",
    "fast_gmr_core",
]
