"""CUR decomposition ``A ≈ C U R`` with the GMR core (counterpart of ``repro/cur/cur.py``).

``C = A[:, col_idx]`` and ``R = A[row_idx, :]`` are actual columns and rows
of ``A``; the optimal core is ``U* = C† A R†`` (:func:`exact_cur`), which
Algorithm 1 sketches. One-shot ``fast_cur`` and the leverage policies are
not ported yet; the streaming paths build their CURResult directly.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.gmr import error_ratio, exact_gmr, residual_norm

__all__ = [
    "CURResult",
    "cur_sketch_sizes",
    "exact_cur",
    "cur_reconstruct",
    "cur_error_ratio",
    "cur_relative_error",
]


@dataclasses.dataclass(frozen=True)
class CURResult:
    """Factors ``A ≈ C U R`` plus the index sets that produced them."""

    C: torch.Tensor  # (m, c)
    U: torch.Tensor  # (c, r)
    R: torch.Tensor  # (r, n)
    col_idx: torch.Tensor  # (c,)
    row_idx: torch.Tensor  # (r,)


def cur_sketch_sizes(c: int, r: int, eps: float = 0.05, rho: float = 2.0, nu: float = 3.0) -> dict:
    """Table-2 sketch sizes with ρ-branch selection: ``s = ν·max{c/√ε, c/(ε ρ²)}``."""
    if eps <= 0:
        raise ValueError(f"eps must be positive, got {eps}")
    branch = max(1.0 / math.sqrt(eps), 1.0 / (eps * rho * rho))
    return dict(s_c=int(math.ceil(nu * c * branch)), s_r=int(math.ceil(nu * r * branch)))


def exact_cur(A: torch.Tensor, col_idx: torch.Tensor, row_idx: torch.Tensor) -> CURResult:
    """Oracle CUR: ``U* = C† A R†`` for the given index sets."""
    col_idx = torch.as_tensor(col_idx, device=A.device).long()
    row_idx = torch.as_tensor(row_idx, device=A.device).long()
    C = A[:, col_idx]
    R = A[row_idx, :]
    return CURResult(C=C, U=exact_gmr(A, C, R), R=R, col_idx=col_idx, row_idx=row_idx)


def cur_reconstruct(res: CURResult) -> torch.Tensor:
    """``C U R``."""
    return res.C @ res.U @ res.R


def cur_error_ratio(A: torch.Tensor, res: CURResult) -> torch.Tensor:
    """§6.1 metric vs the oracle core: ``‖A−CUR‖_F / ‖A−CU*R‖_F − 1``."""
    return error_ratio(A, res.C, res.U, res.R)


def cur_relative_error(A: torch.Tensor, res: CURResult) -> torch.Tensor:
    """``‖A − C U R‖_F / ‖A‖_F``."""
    num = residual_norm(A, res.C, res.U, res.R)
    den = torch.linalg.norm(A.to(num.dtype))
    return num / torch.clamp(den, min=torch.finfo(num.dtype).tiny)
