"""Generalized matrix regression ``X* = argmin_X ‖A − C X R‖_F`` (paper §1, §3).

Counterpart of ``repro/core/gmr.py``: the exact solution ``C† A R†``,
Algorithm 1 (:func:`fast_gmr`) and its sketched core
``(S_C C)† (S_C A S_Rᵀ) (R S_Rᵀ)†`` from pre-sketched pieces, the problem
constant ρ of Eqn. (3.2), the §6.1 error ratio and the §6.1 CountSketch
norm estimator. Least-squares solves are
Householder QR plus a triangular solve with the reference's sign-preserving
absolute floor on ``R``'s diagonal, so an all-zero operand gives a finite
answer, never NaN.
"""

from __future__ import annotations

from typing import Optional

import torch

from .sketching import draw_sketch

__all__ = ["exact_gmr", "fast_gmr", "fast_gmr_core", "rho", "error_ratio", "residual_norm",
           "sketched_fro_norm"]


def _work_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _solve_least_squares(B: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """argmin_X ‖B X − Y‖_F for tall ``B`` via QR, in fp32 or better.

    ``R``'s diagonal ``d`` is replaced by ``sign(d)·max(|d|, floor)`` with
    ``floor = max(eps·max|d|·k, sqrt(tiny))``: a relative rank floor backed by
    an absolute one, so the solve is finite even for an all-zero ``B``, and
    ``B @ X`` is the exact projection of ``Y`` onto the span of ``B``'s
    nonzero prefix columns (see the reference's docstring for the contract).

    Leading batch dimensions are solved item by item, as the reference's
    ``vmap`` does: each item's floor comes from its own diagonal.
    """
    dt = _work_dtype(B)
    Q, Rf = torch.linalg.qr(B.to(dt))
    finfo = torch.finfo(dt)
    d = torch.diagonal(Rf, dim1=-2, dim2=-1)
    rel = finfo.eps * torch.amax(torch.abs(d), dim=-1, keepdim=True) * Rf.shape[-2]
    floor = torch.clamp(rel, min=finfo.tiny ** 0.5)
    safe = torch.where(d < 0, -1.0, 1.0).to(dt) * torch.maximum(torch.abs(d), floor)
    Rf = Rf.clone()
    torch.diagonal(Rf, dim1=-2, dim2=-1).copy_(safe)
    return torch.linalg.solve_triangular(Rf, Q.mT @ Y.to(dt), upper=True)


def exact_gmr(A: torch.Tensor, C: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """``X* = C† A R†`` — the exact GMR solution (Eqn. 1.1)."""
    left = _solve_least_squares(C, A)  # C† A
    return _solve_least_squares(R.mT, left.mT).mT  # (C† A) R†


def fast_gmr_core(ScC: torch.Tensor, ScASr: torch.Tensor, RSr: torch.Tensor) -> torch.Tensor:
    """``X̃ = (S_C C)† (S_C A S_Rᵀ) (R S_Rᵀ)†`` from the three sketched pieces
    (leading batch dimensions allowed)."""
    left = _solve_least_squares(ScC, ScASr)
    return _solve_least_squares(RSr.mT, left.mT).mT


_RESIDUAL_BLOCK = 4096  # columns per block of residual_norm and rho


def fast_gmr(gen: Optional[torch.Generator], A: torch.Tensor, C: torch.Tensor, R: torch.Tensor,
             s_c: int, s_r: int, *, sketch_c: str = "gaussian", sketch_r: Optional[str] = None,
             probs_c=None, probs_r=None, sketches: Optional[tuple] = None) -> torch.Tensor:
    """Algorithm 1 (Fast GMR): ``X̃ = (S_C C)† (S_C A S_Rᵀ) (R S_Rᵀ)†``.

    Draws ``S_C`` (s_c × m) and then ``S_R`` (s_r × n) of the requested
    families from ``gen`` (on ``A``'s device), or takes the pre-drawn pair
    ``sketches=(S_C, S_R)`` (then ``gen``, the sizes and families are not
    used). With CountSketch on CUDA tensors, ``S_C·A`` is kernel 1's chunk
    sketch and ``(S_C A)·S_Rᵀ`` its view kernel, as in ``fast_cur``'s core.
    """
    m, n = A.shape
    if sketches is None:
        if gen is None:
            raise ValueError("pass a generator or pre-drawn `sketches`")
        S_C = draw_sketch(gen, sketch_c, s_c, m, probs=probs_c, dtype=A.dtype)
        S_R = draw_sketch(gen, sketch_r or sketch_c, s_r, n, probs=probs_r, dtype=A.dtype)
    else:
        S_C, S_R = sketches
    ScC = S_C.apply(C)  # (s_c, c)
    RSr = S_R.apply_t(R)  # (r, s_r)
    ScASr = S_R.apply_t(S_C.apply(A))  # (s_c, s_r)
    return fast_gmr_core(ScC, ScASr, RSr)


def rho(A: torch.Tensor, C: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Problem constant ρ (Eqn. 3.2):
    ``‖A − CC†ARR†‖_F / (‖(I−CC†)ARR†‖_F + ‖CC†A(I−RR†)‖_F)``, through
    orthonormal (QR) bases ``Uc`` of ``C`` and ``Vr`` of ``Rᵀ`` as in the
    reference, in fp32 or better. The three m × n terms are formed a column
    block at a time (as :func:`residual_norm` does), so a large ``A`` needs
    no full-size temporary."""
    dt = _work_dtype(A)
    Uc, _ = torch.linalg.qr(C.to(dt))
    Vr, _ = torch.linalg.qr(R.mT.to(dt))
    W = Uc.T @ A.to(dt)  # (c, n): CC†A = Uc·W
    A_Vr = A.to(dt) @ Vr  # (m, r): ARR† = A_Vr·Vrᵀ
    core = W @ Vr  # (c, r): CC†ARR† = Uc·core·Vrᵀ
    sums = torch.zeros(3, dtype=dt, device=A.device)
    for j in range(0, A.shape[-1], _RESIDUAL_BLOCK):
        blk = slice(j, j + _RESIDUAL_BLOCK)
        P_A_Vr = Uc @ (core @ Vr[blk].T)
        # one m × block temporary at a time beside P_A_Vr, squared in place
        sums[0] += torch.sum((A[:, blk].to(dt) - P_A_Vr).square_())
        sums[1] += torch.sum((A_Vr @ Vr[blk].T).sub_(P_A_Vr).square_())
        sums[2] += torch.sum((Uc @ W[:, blk]).sub_(P_A_Vr).square_())
    num, left, right = torch.sqrt(sums)
    return num / torch.clamp(left + right, min=torch.finfo(dt).tiny)


def residual_norm(A, C, X, R) -> torch.Tensor:
    """``‖A − C X R‖_F`` in fp32 or better, a column block at a time so a
    large ``A`` never needs a second full-size temporary. Over a batch the
    norm is taken over every item together (the reference's ``norm``)."""
    dt = _work_dtype(A)
    CX = C.to(dt) @ X.to(dt)
    total = torch.zeros((), dtype=dt, device=A.device)
    for j in range(0, A.shape[-1], _RESIDUAL_BLOCK):
        blk = slice(j, j + _RESIDUAL_BLOCK)
        diff = A[..., blk].to(dt) - CX @ R[..., blk].to(dt)
        total = total + torch.sum(diff * diff)
    return torch.sqrt(total)


def error_ratio(A, C, X, R) -> torch.Tensor:
    """§6.1 metric: ``‖A − C X R‖_F / ‖A − C X* R‖_F − 1``."""
    Xstar = exact_gmr(A, C, R)
    num = residual_norm(A, C, X, R)
    den = residual_norm(A, C, Xstar, R)
    return num / torch.clamp(den, min=torch.finfo(num.dtype).tiny) - 1.0


def sketched_fro_norm(gen: Optional[torch.Generator], B: torch.Tensor, s1: int, s2: int, *,
                      sketches: Optional[tuple] = None) -> torch.Tensor:
    """§6.1's CountSketch Frobenius-norm estimator ``‖S₁ B S₂ᵀ‖_F ≈ ‖B‖_F``:
    ``S₁`` (s1 × m) then ``S₂`` (s2 × n) drawn from ``gen``, or the pre-drawn
    pair ``sketches=(S₁, S₂)``. Both applies are kernel 1 on CUDA tensors."""
    if sketches is None:
        if gen is None:
            raise ValueError("pass a generator or pre-drawn `sketches`")
        S1 = draw_sketch(gen, "countsketch", s1, B.shape[0], dtype=B.dtype)
        S2 = draw_sketch(gen, "countsketch", s2, B.shape[1], dtype=B.dtype)
    else:
        S1, S2 = sketches
    return torch.linalg.norm(S2.apply_t(S1.apply(B)))
