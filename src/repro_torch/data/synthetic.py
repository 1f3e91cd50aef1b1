"""Synthetic test matrices (counterpart of ``repro/data/synthetic.py``).

Each generator draws from a ``torch.Generator`` seeded with ``seed`` on
``device`` (``None`` means CUDA, and raises without it), so a large matrix
is made on the card where it is used. The draws differ from the reference's
``jax.random`` ones; parity tests hand the reference's matrices across
instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import DeviceLike, generator, resolve_device

__all__ = [
    "powerlaw_matrix",
    "sparse_matrix",
    "lowrank_plus_noise",
    "spiked_decay_matrix",
    "late_spike_matrix",
    "spiked_rows_matrix",
    "drifting_spectrum_matrix",
]


def _gen(seed: int, device: DeviceLike):
    dev = resolve_device(device)
    return generator(seed, dev), dev


def _powerlaw(g, dev, m, n, decay, dtype):
    r = min(m, n)
    U, _ = torch.linalg.qr(torch.randn((m, r), generator=g, device=dev, dtype=dtype))
    V, _ = torch.linalg.qr(torch.randn((n, r), generator=g, device=dev, dtype=dtype))
    sv = torch.arange(1, r + 1, device=dev, dtype=dtype) ** (-decay)
    return (U * sv[None, :]) @ V.T


def _choice(g, dev, n, k):
    return torch.randperm(n, generator=g, device=dev)[:k]


def powerlaw_matrix(seed: int, m: int, n: int, decay: float = 1.0, dtype=torch.float32,
                    device: DeviceLike = None):
    """Dense matrix with σ_i ∝ i^-decay."""
    g, dev = _gen(seed, device)
    return _powerlaw(g, dev, m, n, decay, dtype)


def sparse_matrix(seed: int, m: int, n: int, density: float = 0.002, dtype=torch.float32,
                  device: DeviceLike = None):
    """Sparse-profile matrix (the rcv1/news20 substitution of the SP-SVD
    benchmark): a Bernoulli(``density``) mask times standard normals."""
    g, dev = _gen(seed, device)
    mask = torch.rand((m, n), generator=g, device=dev) < density
    vals = torch.randn((m, n), generator=g, device=dev, dtype=dtype)
    return vals.masked_fill_(~mask, 0.0)


def lowrank_plus_noise(seed: int, m: int, n: int, rank: int = 10, snr: float = 10.0,
                       dtype=torch.float32, device: DeviceLike = None):
    """Exactly rank-``rank`` signal plus white noise at signal-to-noise ``snr``."""
    g, dev = _gen(seed, device)
    L = torch.randn((m, rank), generator=g, device=dev, dtype=dtype)
    Rf = torch.randn((rank, n), generator=g, device=dev, dtype=dtype)
    signal = (L @ Rf) / math.sqrt(rank)
    noise = torch.randn((m, n), generator=g, device=dev, dtype=dtype)
    return signal + (torch.linalg.norm(signal) / (snr * torch.linalg.norm(noise))) * noise


def spiked_decay_matrix(seed: int, m: int, n: int, n_spikes: int = 8, spike: float = 6.0,
                        noise: float = 0.05, dtype=torch.float32, device: DeviceLike = None):
    """Decaying background plus a few heavy columns. Returns ``(A, positions)``."""
    g, dev = _gen(seed, device)
    B = noise * _powerlaw(g, dev, m, n, 1.5, dtype)
    pos = _choice(g, dev, n, n_spikes)
    B[:, pos] += spike * torch.randn((m, n_spikes), generator=g, device=dev, dtype=dtype)
    return B, pos


def late_spike_matrix(seed: int, m: int, n: int, n_early: int = 8, n_late: int = 6,
                      early: float = 3.0, late: float = 9.0, noise: float = 0.05,
                      early_frac: float = 0.3, late_frac: float = 0.7, dtype=torch.float32,
                      device: DeviceLike = None):
    """Moderate spikes early, heavier ones after ``late_frac·n`` (the stream
    eviction exists for). Returns ``(A, early_positions, late_positions)``."""
    g, dev = _gen(seed, device)
    B = noise * _powerlaw(g, dev, m, n, 1.5, dtype)
    n_head = max(int(early_frac * n), n_early)
    late_lo = min(int(late_frac * n), n - n_late)
    if n_head > late_lo:
        raise ValueError(
            f"early window [0, {n_head}) overlaps late window [{late_lo}, {n}); "
            f"need a larger n for m×n={m}×{n}"
        )
    early_pos = _choice(g, dev, n_head, n_early)
    late_pos = late_lo + _choice(g, dev, n - late_lo, n_late)
    B[:, early_pos] += early * torch.randn((m, n_early), generator=g, device=dev, dtype=dtype)
    B[:, late_pos] += late * torch.randn((m, n_late), generator=g, device=dev, dtype=dtype)
    return B, early_pos, late_pos


def spiked_rows_matrix(seed: int, m: int, n: int, n_spikes: int = 6, spike: float = 6.0,
                       noise: float = 0.05, dtype=torch.float32, device: DeviceLike = None):
    """Decaying background plus a few heavy rows. Returns ``(A, positions)``."""
    g, dev = _gen(seed, device)
    B = noise * _powerlaw(g, dev, m, n, 1.5, dtype)
    pos = _choice(g, dev, m, n_spikes)
    B[pos, :] += spike * torch.randn((n_spikes, n), generator=g, device=dev, dtype=dtype)
    return B, pos


def drifting_spectrum_matrix(seed: int, m: int, n: int, n_blocks: int = 4, rank: int = 4,
                             ramp: float = 2.5, noise: float = 0.05, dtype=torch.float32,
                             device: DeviceLike = None):
    """Column stream whose dominant rank-``rank`` subspace changes per block,
    each block ``ramp×`` stronger than the last. Needs no QR, so it is cheap
    at full size; the blocks are added in place. Returns ``(A, bounds)``."""
    g, dev = _gen(seed, device)
    B = torch.randn((m, n), generator=g, device=dev, dtype=dtype)
    B.mul_(noise)
    bounds = np.linspace(0, n, n_blocks + 1).astype(int)
    for b in range(n_blocks):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        L = torch.randn((m, rank), generator=g, device=dev, dtype=dtype)
        Rf = torch.randn((rank, hi - lo), generator=g, device=dev, dtype=dtype)
        B[:, lo:hi].addmm_(L, Rf, alpha=(ramp ** b) / math.sqrt(rank))
    return B, torch.as_tensor(bounds, dtype=torch.int32, device=dev)
