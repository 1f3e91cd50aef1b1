"""CUR decomposition ``A ≈ C U R`` with the GMR core (counterpart of ``repro/cur/cur.py``).

``C = A[:, col_idx]`` and ``R = A[row_idx, :]`` are actual columns and rows
of ``A``; the optimal core is ``U* = C† A R†`` (:func:`exact_cur`), which
Algorithm 1 sketches: ``Ũ = (S_C C)† (S_C A S_Rᵀ) (R S_Rᵀ)†``
(:func:`fast_cur`), with Table-2 sketch sizes. The default core sketch
family is ``"leverage"``: row sampling by the leverage scores of ``C`` and
``Rᵀ`` (Table 3). The streaming paths build their CURResult directly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core.gmr import error_ratio, exact_gmr, fast_gmr_core, residual_norm
from ..core.leverage import leverage_scores
from ..core.sketching import RowSampling, draw_sketch
from .selection import select_columns, select_rows

__all__ = [
    "CURResult",
    "cur_sketch_sizes",
    "exact_cur",
    "fast_cur",
    "cur_reconstruct",
    "cur_error_ratio",
    "cur_relative_error",
]


@dataclasses.dataclass(frozen=True)
class CURResult:
    """Factors ``A ≈ C U R`` plus the index sets that produced them; the
    tensors may carry a leading batch dimension (:mod:`repro_torch.cur.batched`)."""

    C: torch.Tensor  # (..., m, c)
    U: torch.Tensor  # (..., c, r)
    R: torch.Tensor  # (..., r, n)
    col_idx: torch.Tensor  # (..., c)
    row_idx: torch.Tensor  # (..., r)


def cur_sketch_sizes(c: int, r: int, eps: float = 0.05, rho: float = 2.0, nu: float = 3.0) -> dict:
    """Table-2 sketch sizes with ρ-branch selection: ``s = ν·max{c/√ε, c/(ε ρ²)}``."""
    if eps <= 0:
        raise ValueError(f"eps must be positive, got {eps}")
    branch = max(1.0 / math.sqrt(eps), 1.0 / (eps * rho * rho))
    return dict(s_c=int(math.ceil(nu * c * branch)), s_r=int(math.ceil(nu * r * branch)))


def _resolve_indices(gen, A, c, r, policy, col_idx, row_idx) -> tuple:
    """Explicit index sets as int64 tensors on ``A.device``, or drawn under
    ``policy`` (columns first, then rows, from ``gen``)."""
    if col_idx is None:
        if c is None:
            raise ValueError("pass either `c` or explicit `col_idx`")
        col_idx = select_columns(gen, A, c, policy).idx
    if row_idx is None:
        if r is None:
            raise ValueError("pass either `r` or explicit `row_idx`")
        row_idx = select_rows(gen, A, r, policy).idx
    return (torch.as_tensor(col_idx, device=A.device).long(),
            torch.as_tensor(row_idx, device=A.device).long())


def exact_cur(A: torch.Tensor, col_idx=None, row_idx=None, *, gen=None, c: Optional[int] = None,
              r: Optional[int] = None, policy: str = "uniform") -> CURResult:
    """Oracle CUR: ``U* = C† A R†`` for the given (or ``policy``-drawn) index sets."""
    if (col_idx is None or row_idx is None) and gen is None:
        raise ValueError("pass `gen` when indices are not explicit")
    col_idx, row_idx = _resolve_indices(gen, A, c, r, policy, col_idx, row_idx)
    C = A[:, col_idx]
    R = A[row_idx, :]
    return CURResult(C=C, U=exact_gmr(A, C, R), R=R, col_idx=col_idx, row_idx=row_idx)


def _draw_core_sketches(gen, C, R, s_c: int, s_r: int, sketch: str) -> tuple:
    """S_C (s_c×m) and S_R (s_r×n) of the requested Table-2/3 family."""
    m, n = C.shape[0], R.shape[1]
    if sketch == "leverage":
        S_C = RowSampling.draw(gen, s_c, m, probs=leverage_scores(C), dtype=C.dtype)
        S_R = RowSampling.draw(gen, s_r, n, probs=leverage_scores(R.T), dtype=C.dtype)
        return S_C, S_R
    return (draw_sketch(gen, sketch, s_c, m, dtype=C.dtype),
            draw_sketch(gen, sketch, s_r, n, dtype=C.dtype))


def fast_cur(gen, A: torch.Tensor, c: Optional[int] = None, r: Optional[int] = None, *,
             policy: str = "uniform", sketch: str = "leverage", eps: float = 0.05,
             rho_est: float = 2.0, s_c: Optional[int] = None, s_r: Optional[int] = None,
             col_idx=None, row_idx=None, sketches=None) -> CURResult:
    """Algorithm-1 CUR: selection → core sketches → sketched GMR solve.

    ``sketches=(S_C, S_R)`` injects pre-drawn operators and
    ``col_idx``/``row_idx`` pre-drawn index sets (how the parity tests hand
    the reference's randomness across); ``s_c``/``s_r`` override the
    Table-2 sizes from ``(eps, rho_est)``. With ``sketch="countsketch"`` on
    a CUDA tensor every sketch apply runs kernel 1.
    """
    m, n = A.shape
    col_idx, row_idx = _resolve_indices(gen, A, c, r, policy, col_idx, row_idx)
    C = A[:, col_idx]
    R = A[row_idx, :]
    if sketches is None:
        sizes = cur_sketch_sizes(C.shape[1], R.shape[0], eps=eps, rho=rho_est)
        s_c = min(s_c or sizes["s_c"], m)
        s_r = min(s_r or sizes["s_r"], n)
        S_C, S_R = _draw_core_sketches(gen, C, R, s_c, s_r, sketch)
    else:
        S_C, S_R = sketches
    ScC = S_C.apply(C)  # (s_c, c)
    RSr = S_R.apply_t(R)  # (r, s_r)
    ScASr = S_R.apply_t(S_C.apply(A))  # (s_c, s_r)
    U = fast_gmr_core(ScC, ScASr, RSr)
    return CURResult(C=C, U=U, R=R, col_idx=col_idx, row_idx=row_idx)


def cur_reconstruct(res: CURResult) -> torch.Tensor:
    """``C U R`` (batched-aware)."""
    return res.C @ res.U @ res.R


def cur_error_ratio(A: torch.Tensor, res: CURResult) -> torch.Tensor:
    """§6.1 metric vs the oracle core: ``‖A−CUR‖_F / ‖A−CU*R‖_F − 1``."""
    return error_ratio(A, res.C, res.U, res.R)


def cur_relative_error(A: torch.Tensor, res: CURResult) -> torch.Tensor:
    """``‖A − C U R‖_F / ‖A‖_F`` (over a batch: over every item together)."""
    num = residual_norm(A, res.C, res.U, res.R)
    den = torch.linalg.norm(A.to(num.dtype))
    return num / torch.clamp(den, min=torch.finfo(num.dtype).tiny)
