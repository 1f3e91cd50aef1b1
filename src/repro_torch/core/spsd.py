"""The §4 batch SPSD surface under its older path (counterpart of
``repro/core/spsd.py``): re-exports :mod:`repro_torch.spsd.batch`."""

from ..spsd.batch import (  # noqa: F401 — re-exports
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

__all__ = [
    "rbf_kernel_oracle",
    "matrix_oracle",
    "KernelOracle",
    "SPSDResult",
    "leverage_sampling_sketches",
    "nystrom",
    "optimal_core",
    "fast_spsd_wang",
    "faster_spsd",
    "spsd_error_ratio",
]
