"""Synthetic data of the port (counterpart of ``repro.data``)."""

from .synthetic import (
    DataConfig,
    SyntheticLM,
    drifting_spectrum_matrix,
    late_spike_matrix,
    lowrank_plus_noise,
    powerlaw_matrix,
    spiked_decay_matrix,
    sparse_matrix,
    spiked_rows_matrix,
)

__all__ = [
    "DataConfig",
    "SyntheticLM",
    "drifting_spectrum_matrix",
    "late_spike_matrix",
    "lowrank_plus_noise",
    "powerlaw_matrix",
    "spiked_decay_matrix",
    "sparse_matrix",
    "spiked_rows_matrix",
]
