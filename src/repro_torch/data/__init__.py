"""Synthetic data of the port (counterpart of ``repro.data``)."""

from .synthetic import (
    drifting_spectrum_matrix,
    late_spike_matrix,
    lowrank_plus_noise,
    powerlaw_matrix,
    spiked_decay_matrix,
    spiked_rows_matrix,
)

__all__ = [
    "drifting_spectrum_matrix",
    "late_spike_matrix",
    "lowrank_plus_noise",
    "powerlaw_matrix",
    "spiked_decay_matrix",
    "spiked_rows_matrix",
]
