"""Symmetric CUR ``K ≈ C X Cᵀ`` with ``R = Cᵀ`` tied (counterpart of
``repro/cur/symmetric_cur.py``).

One index set, chosen by any :mod:`repro_torch.cur.selection` policy on
``K`` itself, and Algorithm 2's sketched core with the PSD projection
(:mod:`repro_torch.spsd.batch`), or the exact core ``C† K (C†)ᵀ``. The
result keeps the SPSD contract (:class:`~repro_torch.spsd.batch.SPSDResult`,
``nc + s²`` or ``n²`` entries observed); :func:`spsd_to_cur` adapts it to
the :class:`~repro_torch.cur.cur.CURResult` surface.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..spsd.batch import SPSDResult, faster_spsd, matrix_oracle, optimal_core
from .cur import CURResult
from .selection import select_columns

__all__ = ["symmetric_cur", "spsd_to_cur"]


def symmetric_cur(gen: Optional[torch.Generator], K: torch.Tensor, c: Optional[int] = None, *,
                  policy: str = "uniform", col_idx=None, s: Optional[int] = None,
                  k: Optional[int] = None, method: str = "faster", sketches=None) -> SPSDResult:
    """Policy-driven symmetric CUR of an SPSD matrix ``K (n, n)``.

    ``c`` columns are selected by ``policy`` on ``K`` (``k`` is the leverage
    policies' subspace rank), unless ``col_idx`` is given. ``method="faster"``
    solves Algorithm 2's sketched core with ``s`` rows (default
    ``min(10·c, n)``; ``sketches=(S₁, S₂)`` injects a pre-drawn RowSampling
    pair), ``"exact"`` the oracle core. Selection and sketches draw from
    ``gen``. ``X`` is PSD either way.
    """
    n, n2 = K.shape
    if n != n2:
        raise ValueError(f"symmetric CUR needs a square SPSD matrix, got {tuple(K.shape)}")
    if col_idx is None:
        if c is None:
            raise ValueError("pass either `c` or explicit `col_idx`")
        col_idx = select_columns(gen, K, c, policy, k=k).idx
    col_idx = torch.as_tensor(col_idx).to(device=K.device, dtype=torch.int32)
    c = col_idx.shape[0]
    oracle = matrix_oracle(K)
    if method == "exact":
        return optimal_core(gen, oracle, n, c, col_idx=col_idx)
    if method != "faster":
        raise ValueError(f"unknown method {method!r}; expected 'faster' or 'exact'")
    if s is None:
        s = min(10 * c, n)
    return faster_spsd(gen, oracle, n, c, s, col_idx=col_idx, sketches=sketches)


def spsd_to_cur(res: SPSDResult) -> CURResult:
    """The CUR surface of an SPSD factorisation: ``U = X``, ``R = Cᵀ``,
    ``row_idx = col_idx`` (the tied index set)."""
    return CURResult(C=res.C, U=res.X, R=res.C.T, col_idx=res.col_idx, row_idx=res.col_idx)
