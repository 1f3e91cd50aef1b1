"""Leverage scores (counterpart of ``repro/core/leverage.py``; paper §2.1,
Drineas et al. 2012 estimation).

Row leverage scores of ``A (m×n)``, m ≥ n: ``ℓᵢ = ‖Q_{i,:}‖²`` for an
orthonormal basis ``Q`` of range(A); ``Σℓᵢ = rank(A)``. They feed the
leverage-sampling core sketches of Tables 2/3.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .sketching import draw_sketch

__all__ = ["leverage_scores", "approx_leverage_scores"]


def _work_dtype(A: torch.Tensor) -> torch.dtype:
    return torch.float64 if A.dtype == torch.float64 else torch.float32


def leverage_scores(A: torch.Tensor) -> torch.Tensor:
    """Exact row leverage scores via QR — O(m n²)."""
    Q, _ = torch.linalg.qr(A.to(_work_dtype(A)))
    return torch.sum(Q * Q, dim=1)


def approx_leverage_scores(gen: Optional[torch.Generator], A: torch.Tensor,
                           s: Optional[int] = None, *, sketch=None,
                           jl: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sketched leverage scores ``ℓ̂ᵢ = ‖A_{i,:}·R⁻¹·G‖²``.

    ``R`` comes from the QR of a CountSketch ``S·A`` (``s`` rows; on a CUDA
    tensor through kernel 1) and ``G`` (n × jl) is a small Gaussian for the
    JL reduction: O(nnz(A) + n³) instead of O(mn²). ``sketch`` and ``jl``
    inject pre-drawn ``S`` and ``G`` (the parity tests hand the reference's
    across); otherwise both are drawn from ``gen``.
    """
    m, n = A.shape
    dt = _work_dtype(A)
    if sketch is None:
        s = s or min(m, max(4 * n, n + 8))
        sketch = draw_sketch(gen, "countsketch", s, m, dtype=A.dtype)
    _, Rf = torch.linalg.qr(sketch.apply(A).to(dt))
    Z = torch.linalg.solve_triangular(Rf, A.to(dt), upper=True, left=False)  # A R⁻¹
    if jl is None:
        k = max(8, math.ceil(math.log2(m)) * 2)
        jl = torch.randn((n, k), generator=gen, device=gen.device, dtype=dt) / math.sqrt(k)
    return torch.sum((Z @ jl.to(dt)) ** 2, dim=1)
