"""SPSD / kernel-matrix approximation of the port (paper §4, Algorithm 2;
counterpart of ``repro.spsd``): the oracle-bound batch paths
(:mod:`.batch`) and the single-pass streaming paths on the engine's
symmetric mode (:mod:`.streaming`)."""

from .batch import (
    KernelOracle,
    SPSDResult,
    fast_spsd_wang,
    faster_spsd,
    leverage_sampling_sketches,
    matrix_oracle,
    nystrom,
    optimal_core,
    rbf_kernel_oracle,
    spsd_error_ratio,
)
from .streaming import (
    ADAPTIVE_SPSD_OPS,
    STREAMING_SPSD_OPS,
    SPSDStreamCtx,
    adaptive_spsd_finalize,
    adaptive_spsd_init,
    streaming_spsd_finalize,
    streaming_spsd_init,
)

__all__ = [
    "KernelOracle", "SPSDResult", "fast_spsd_wang", "faster_spsd",
    "leverage_sampling_sketches", "matrix_oracle", "nystrom", "optimal_core",
    "rbf_kernel_oracle", "spsd_error_ratio",
    "ADAPTIVE_SPSD_OPS", "STREAMING_SPSD_OPS", "SPSDStreamCtx",
    "adaptive_spsd_finalize", "adaptive_spsd_init",
    "streaming_spsd_finalize", "streaming_spsd_init",
]
