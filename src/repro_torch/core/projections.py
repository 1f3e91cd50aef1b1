"""Convex-cone projections (paper §3.2, Proposition 1, Eqns. 3.5/3.6;
counterpart of ``repro/core/projections.py``)."""

from __future__ import annotations

import torch

__all__ = ["sym_project", "psd_project"]


def sym_project(X: torch.Tensor) -> torch.Tensor:
    """Π_{H^n}(X) = (X + Xᵀ)/2 (Eqn. 3.5)."""
    return 0.5 * (X + X.T)


def psd_project(X: torch.Tensor) -> torch.Tensor:
    """Π_{H^n₊}(X): symmetrise, eigendecompose, clip the negative spectrum
    (Eqn. 3.6), in fp32 or wider whatever ``X``'s dtype, then cast back."""
    dt = torch.promote_types(X.dtype, torch.float32)
    w, V = torch.linalg.eigh(sym_project(X.to(dt)))
    w = torch.clamp(w, min=0.0)
    return ((V * w[None, :]) @ V.T).to(X.dtype)
