"""Column/row selection for CUR (counterpart of ``repro/cur/selection.py``).

Every policy sits behind ``select_columns(gen, A, c, policy)`` →
:class:`Selection` (idx, probs):

* ``uniform``         — ``c`` distinct indices, uniform without replacement.
* ``leverage``        — rank-k subspace leverage ``ℓ_j = ‖V_k[j, :]‖²`` from
                        the SVD of ``A`` (``k`` defaults to ``c``).
* ``approx_leverage`` — the same scores from a CountSketch ``S·A`` (on a
                        CUDA tensor through kernel 1), then a small SVD.
* ``pivoted_qr``      — deterministic greedy pivoted QR (``probs`` is None).

Weighted sampling without replacement is ``torch.multinomial``: successive
weighted draws, the distribution of the reference's
``jax.random.choice(replace=False, p=...)``, not its bits. Parity tests
compare the distributions (``probs``) and hand the reference's indices
across.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.sketching import CountSketch

__all__ = ["Selection", "SELECTION_POLICIES", "select_columns", "select_rows"]

SELECTION_POLICIES = ("uniform", "leverage", "approx_leverage", "pivoted_qr")


class Selection(NamedTuple):
    """Chosen indices plus the sampling distribution that produced them."""

    idx: torch.Tensor  # (c,) int32
    probs: Optional[torch.Tensor]  # (n,) distribution used, or None (deterministic)


def _work_dtype(A: torch.Tensor) -> torch.dtype:
    return torch.float64 if A.dtype == torch.float64 else torch.float32


def _pivoted_qr_idx(A: torch.Tensor, c: int) -> torch.Tensor:
    """Greedy column-pivoted QR: argmax residual column norm, Gram-Schmidt deflate."""
    dt = _work_dtype(A)
    res = A.to(dt)
    taken = torch.zeros(A.shape[1], dtype=torch.bool, device=A.device)
    picked = []
    for _ in range(c):
        # mask picked columns: deflation leaves fp-noise residuals past the rank
        norms = torch.where(taken, -torch.inf, torch.sum(res * res, dim=0))
        j = torch.argmax(norms)
        picked.append(j)
        taken[j] = True
        q = res[:, j] / torch.clamp(torch.sqrt(norms[j]), min=torch.finfo(dt).tiny)
        res = res - q[:, None] * (q @ res)[None, :]
    return torch.stack(picked).to(torch.int32)


def _subspace_leverage(Vt: torch.Tensor, k: int) -> torch.Tensor:
    """Column scores ``ℓ_j = ‖V_k[j, :]‖²`` from the rows of ``Vᵀ``."""
    return torch.sum(Vt[:k] * Vt[:k], dim=0)


def _draw_distinct(gen: torch.Generator, probs: torch.Tensor, c: int) -> torch.Tensor:
    """``c`` distinct indices by successive weighted draws. When fewer than
    ``c`` entries have positive weight, all of them come first and the rest
    are uniform among the zero-weight entries, as the reference's
    Gumbel-top-k draw orders them."""
    nonzero = int(torch.count_nonzero(probs))
    if nonzero >= c:
        return torch.multinomial(probs, c, replacement=False, generator=gen)
    head = torch.multinomial(probs, nonzero, replacement=False, generator=gen) if nonzero \
        else probs.new_zeros((0,), dtype=torch.long)
    zeros = torch.nonzero(probs == 0).squeeze(1)
    order = torch.randperm(zeros.numel(), generator=gen, device=gen.device).to(zeros.device)
    return torch.cat([head, zeros[order[: c - nonzero]]])


def _leverage_probs(gen, A: torch.Tensor, k: int, policy: str, sketch) -> torch.Tensor:
    m, _ = A.shape
    dt = _work_dtype(A)
    if policy == "leverage":
        Vt = torch.linalg.svd(A.to(dt), full_matrices=False)[2]
    else:
        if sketch is None:
            sketch = CountSketch.draw(gen, min(m, max(4 * k, k + 8)), m, dtype=A.dtype)
        Vt = torch.linalg.svd(sketch.apply(A).to(dt), full_matrices=False)[2]
    lev = _subspace_leverage(Vt, k)
    return lev / torch.sum(lev)


def select_columns(gen: torch.Generator, A: torch.Tensor, c: int, policy: str = "uniform", *,
                   k: Optional[int] = None, probs: Optional[torch.Tensor] = None,
                   sketch=None) -> Selection:
    """Pick ``c`` column indices of ``A`` under ``policy``.

    ``k`` is the subspace rank of the leverage policies (default ``c``);
    ``probs`` overrides the policy's distribution; ``sketch`` injects the
    CountSketch of ``approx_leverage`` (default: drawn from ``gen``).
    """
    m, n = A.shape
    if not 0 < c <= n:
        raise ValueError(f"need 0 < c <= n, got c={c}, n={n}")
    if policy not in SELECTION_POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected one of {SELECTION_POLICIES}")
    if policy == "pivoted_qr":
        return Selection(idx=_pivoted_qr_idx(A, c), probs=None)
    if probs is None and policy == "uniform":
        idx = torch.randperm(n, generator=gen, device=gen.device)[:c]
        probs = torch.full((n,), 1.0 / n, dtype=torch.float32, device=A.device)
        return Selection(idx=idx.to(device=A.device, dtype=torch.int32), probs=probs)
    if probs is None:
        probs = _leverage_probs(gen, A, min(k or c, m, n), policy, sketch)
    else:
        probs = probs / torch.sum(probs)
    idx = _draw_distinct(gen, probs.float(), c)
    return Selection(idx=idx.to(torch.int32), probs=probs)


def select_rows(gen: torch.Generator, A: torch.Tensor, r: int, policy: str = "uniform", *,
                k: Optional[int] = None, probs: Optional[torch.Tensor] = None,
                sketch=None) -> Selection:
    """Pick ``r`` row indices of ``A`` — :func:`select_columns` on ``Aᵀ`` (a
    view: the CountSketch of ``approx_leverage`` reads it without a copy)."""
    return select_columns(gen, A.T, r, policy, k=k, probs=probs, sketch=sketch)
