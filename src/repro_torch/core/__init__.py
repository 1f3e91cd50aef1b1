"""Sketches, leverage scores, GMR solves, projections and single-pass SVD of
the port (counterpart of ``repro.core``). As in the reference, the CUR and
SPSD surfaces are re-exported here lazily (their modules import this
package's submodules at load time)."""

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
from .gmr import error_ratio, exact_gmr, fast_gmr_core
from .projections import psd_project, sym_project
from .leverage import approx_leverage_scores, leverage_scores
from .svd import (
    fast_sp_svd,
    practical_sp_svd,
    sp_svd_finalize,
    sp_svd_init,
    sp_svd_sizes,
    sp_svd_update,
    spsvd_engine_finalize,
    spsvd_engine_init,
    svd_error_ratio,
)

_CUR_EXPORTS = (
    "CURResult", "cur_error_ratio", "cur_reconstruct", "cur_relative_error",
    "cur_sketch_sizes", "exact_cur", "fast_cur", "select_columns", "select_rows",
    "streaming_cur_finalize", "streaming_cur_init", "streaming_cur_update",
    "batched_fast_cur", "symmetric_cur", "spsd_to_cur",
)
_SPSD_EXPORTS = (
    "SPSDResult", "faster_spsd", "fast_spsd_wang", "leverage_sampling_sketches",
    "matrix_oracle", "nystrom", "optimal_core", "rbf_kernel_oracle",
    "spsd_error_ratio",
    "streaming_spsd_init", "streaming_spsd_finalize",
    "adaptive_spsd_init", "adaptive_spsd_finalize",
)


def __getattr__(name):  # PEP 562: lazy re-exports, free of import cycles
    if name in _CUR_EXPORTS:
        from .. import cur as _cur

        return getattr(_cur, name)
    if name in _SPSD_EXPORTS:
        from .. import spsd as _spsd

        return getattr(_spsd, name)
    if name == "spsd":
        import importlib

        return importlib.import_module(".spsd", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ComposedSketch", "CountSketch", "GaussianSketch", "OSNAPSketch", "RowSampling",
    "SRHTSketch", "draw_sketch", "fwht",
    "exact_gmr", "fast_gmr_core", "error_ratio",
    "psd_project", "sym_project",
    "approx_leverage_scores", "leverage_scores",
    "fast_sp_svd", "practical_sp_svd", "sp_svd_finalize", "sp_svd_init", "sp_svd_sizes",
    "sp_svd_update", "spsvd_engine_finalize", "spsvd_engine_init", "svd_error_ratio",
    *_CUR_EXPORTS,
    *_SPSD_EXPORTS,
]
