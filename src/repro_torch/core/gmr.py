"""Generalized matrix regression ``X* = argmin_X ‖A − C X R‖_F`` (paper §1, §3).

Counterpart of ``repro/core/gmr.py``: the exact solution ``C† A R†``, the
sketched core ``(S_C C)† (S_C A S_Rᵀ) (R S_Rᵀ)†`` of Algorithm 1 from
pre-sketched pieces, and the §6.1 error ratio. Least-squares solves are
Householder QR plus a triangular solve with the reference's sign-preserving
absolute floor on ``R``'s diagonal, so an all-zero operand gives a finite
answer, never NaN.
"""

from __future__ import annotations

import torch

__all__ = ["exact_gmr", "fast_gmr_core", "error_ratio", "residual_norm"]


def _work_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _solve_least_squares(B: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """argmin_X ‖B X − Y‖_F for tall ``B`` via QR, in fp32 or better.

    ``R``'s diagonal ``d`` is replaced by ``sign(d)·max(|d|, floor)`` with
    ``floor = max(eps·max|d|·k, sqrt(tiny))``: a relative rank floor backed by
    an absolute one, so the solve is finite even for an all-zero ``B``, and
    ``B @ X`` is the exact projection of ``Y`` onto the span of ``B``'s
    nonzero prefix columns (see the reference's docstring for the contract).
    """
    dt = _work_dtype(B)
    Q, Rf = torch.linalg.qr(B.to(dt))
    finfo = torch.finfo(dt)
    d = torch.diagonal(Rf)
    rel = finfo.eps * torch.max(torch.abs(d)) * Rf.shape[0]
    floor = torch.clamp(rel, min=finfo.tiny ** 0.5)
    safe = torch.where(d < 0, -1.0, 1.0).to(dt) * torch.maximum(torch.abs(d), floor)
    Rf = Rf.clone()
    Rf.diagonal().copy_(safe)
    return torch.linalg.solve_triangular(Rf, Q.T @ Y.to(dt), upper=True)


def exact_gmr(A: torch.Tensor, C: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """``X* = C† A R†`` — the exact GMR solution (Eqn. 1.1)."""
    left = _solve_least_squares(C, A)  # C† A
    return _solve_least_squares(R.T, left.T).T  # (C† A) R†


def fast_gmr_core(ScC: torch.Tensor, ScASr: torch.Tensor, RSr: torch.Tensor) -> torch.Tensor:
    """``X̃ = (S_C C)† (S_C A S_Rᵀ) (R S_Rᵀ)†`` from the three sketched pieces."""
    left = _solve_least_squares(ScC, ScASr)
    return _solve_least_squares(RSr.T, left.T).T


_RESIDUAL_BLOCK = 4096  # columns per block of residual_norm


def residual_norm(A, C, X, R) -> torch.Tensor:
    """``‖A − C X R‖_F`` in fp32 or better, a column block at a time so a
    large ``A`` never needs a second full-size temporary."""
    dt = _work_dtype(A)
    CX = C.to(dt) @ X.to(dt)
    total = torch.zeros((), dtype=dt, device=A.device)
    for j in range(0, A.shape[1], _RESIDUAL_BLOCK):
        blk = slice(j, j + _RESIDUAL_BLOCK)
        diff = A[:, blk].to(dt) - CX @ R[:, blk].to(dt)
        total = total + torch.sum(diff * diff)
    return torch.sqrt(total)


def error_ratio(A, C, X, R) -> torch.Tensor:
    """§6.1 metric: ``‖A − C X R‖_F / ‖A − C X* R‖_F − 1``."""
    Xstar = exact_gmr(A, C, R)
    num = residual_norm(A, C, X, R)
    den = residual_norm(A, C, Xstar, R)
    return num / torch.clamp(den, min=torch.finfo(num.dtype).tiny) - 1.0
