"""Batch SPSD / kernel-matrix approximation (paper §4; counterpart of
``repro/spsd/batch.py``).

* :func:`nystrom`        — Williams & Seeger 2001: ``X = W†``;
* :func:`optimal_core`   — ``X = C† K (C†)ᵀ`` (observes all n² entries);
* :func:`fast_spsd_wang` — Wang et al. 2016b, Eqn. (4.1): one leverage
  sampling sketch S, ``X̂ = (SC)† (S K Sᵀ) (Cᵀ Sᵀ)†``;
* :func:`faster_spsd`    — **Algorithm 2**: two independent leverage
  sampling sketches and the PSD projection, observing ``nc + s²`` entries.

Every path reads the kernel through an entry oracle ``oracle(rows, cols)``
(:func:`rbf_kernel_oracle`, :func:`matrix_oracle`), so only the entries it
touches are computed; ``entries_observed`` reports them. Randomness comes
from a ``torch.Generator``; ``col_idx=`` and ``sketches=`` (``sketch=`` for
:func:`fast_spsd_wang`) take pre-drawn indices and
:class:`~repro_torch.core.sketching.RowSampling` operators instead (how the
parity tests hand the reference's draws across, and how the streaming path
shares them).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..core.gmr import _solve_least_squares, fast_gmr_core, residual_norm
from ..core.leverage import leverage_scores
from ..core.projections import psd_project
from ..core.sketching import RowSampling

__all__ = [
    "rbf_kernel_oracle",
    "matrix_oracle",
    "KernelOracle",
    "SPSDResult",
    "leverage_sampling_sketches",
    "nystrom",
    "optimal_core",
    "fast_spsd_wang",
    "faster_spsd",
    "spsd_error_ratio",
]

# A kernel oracle maps (row_idx | None, col_idx | None) -> K[rows][:, cols].
KernelOracle = Callable[[Optional[torch.Tensor], Optional[torch.Tensor]], torch.Tensor]


def rbf_kernel_oracle(X: torch.Tensor, sigma: float) -> KernelOracle:
    """RBF oracle over data ``X (n, d)``: ``K_ij = exp(−σ ‖xᵢ − xⱼ‖²)`` (§6.2).
    The block is built in place from ``Xr·Xcᵀ``, so a full ``K`` needs one
    n × n buffer, with the reference's operations in its order."""

    def oracle(rows, cols):
        Xr = X if rows is None else X[rows.long()]
        Xc = X if cols is None else X[cols.long()]
        K = Xr @ Xc.T
        K.mul_(-2.0).add_(torch.sum(Xr * Xr, dim=1)[:, None])
        K.add_(torch.sum(Xc * Xc, dim=1)[None, :])
        return K.clamp_(min=0.0).mul_(-sigma).exp_()

    return oracle


def matrix_oracle(K: torch.Tensor) -> KernelOracle:
    """Entry oracle over a materialised SPSD ``K (n, n)``; ``entries_observed``
    still counts what the algorithm would have queried."""

    def oracle(rows, cols):
        Kr = K if rows is None else K[rows.long()]
        return Kr if cols is None else Kr[:, cols.long()]

    return oracle


@dataclasses.dataclass(frozen=True)
class SPSDResult:
    """Column matrix C, core X (``K ≈ C X Cᵀ``) and the entries observed."""

    C: torch.Tensor
    X: torch.Tensor
    col_idx: torch.Tensor
    entries_observed: int


def _validate_sizes(n: int, c: int, s: Optional[int] = None) -> None:
    """``0 < c ≤ n`` columns (drawn without replacement) and ``s > 0`` sketch
    rows (drawn with replacement, so ``s > n`` is legal)."""
    if not 0 < c <= n:
        raise ValueError(f"need 0 < c <= n sampled columns, got c={c}, n={n}")
    if s is not None and s <= 0:
        raise ValueError(f"need s > 0 sketch rows, got s={s} (n={n})")


def _uniform_columns(gen: torch.Generator, n: int, c: int) -> torch.Tensor:
    return torch.randperm(n, generator=gen, device=gen.device)[:c].to(torch.int32)


def _resolve_columns(gen, oracle: KernelOracle, n: int, c: int, col_idx):
    """A uniform column draw, or the caller's explicit indices, and ``C``."""
    if col_idx is None:
        col_idx = _uniform_columns(gen, n, c)
    else:
        col_idx = torch.as_tensor(col_idx).to(torch.int32)
        if col_idx.shape[0] != c:
            raise ValueError(f"col_idx has {col_idx.shape[0]} entries, expected c={c}")
    C = oracle(None, col_idx)
    return col_idx.to(C.device), C


def _leverage_probs(C: torch.Tensor) -> torch.Tensor:
    probs = leverage_scores(C)
    return probs / torch.sum(probs)


def leverage_sampling_sketches(gen: torch.Generator, C: torch.Tensor, s: int
                               ) -> Tuple[RowSampling, RowSampling]:
    """Algorithm 2 steps 2–3: two independent ``(s, n)`` leverage-score
    sampling sketches with respect to ``range(C)``, drawn from ``gen`` —
    the pair :func:`faster_spsd` and the streaming path both take."""
    probs = _leverage_probs(C)
    n = C.shape[0]
    return (RowSampling.draw(gen, s, n, probs=probs, dtype=torch.float32),
            RowSampling.draw(gen, s, n, probs=probs, dtype=torch.float32))


def _sampled_block(oracle: KernelOracle, S1: RowSampling, S2: RowSampling) -> torch.Tensor:
    """``S₁ K S₂ᵀ`` from s² oracle entries."""
    return oracle(S1.idx, S2.idx) * (S1.scale[:, None] * S2.scale[None, :])


def _require_sampling(sketches) -> Tuple[RowSampling, RowSampling]:
    S1, S2 = sketches
    if not (isinstance(S1, RowSampling) and isinstance(S2, RowSampling)):
        raise TypeError(
            "batch SPSD sketch injection requires RowSampling operators — the "
            "entry-oracle contract needs explicit sampled indices (S K Sᵀ must "
            "cost s² entries, not n²)"
        )
    return S1, S2


def nystrom(gen: Optional[torch.Generator], oracle: KernelOracle, n: int, c: int, *,
            col_idx=None) -> SPSDResult:
    """Conventional Nyström: ``X = W†`` with W the c × c intersection block."""
    _validate_sizes(n, c)
    idx, C = _resolve_columns(gen, oracle, n, c, col_idx)
    W = C[idx.long()]  # (c, c), already observed
    dt = torch.promote_types(C.dtype, torch.float32)
    X = torch.linalg.pinv(W.to(dt), rtol=1e-6).to(C.dtype)
    return SPSDResult(C=C, X=X, col_idx=idx, entries_observed=n * c)


def optimal_core(gen: Optional[torch.Generator], oracle: KernelOracle, n: int, c: int, *,
                 col_idx=None) -> SPSDResult:
    """``X = C† K (C†)ᵀ``, PSD-projected; observes all n² entries."""
    _validate_sizes(n, c)
    idx, C = _resolve_columns(gen, oracle, n, c, col_idx)
    K = oracle(None, None)
    left = _solve_least_squares(C, K)  # C† K
    del K
    X = _solve_least_squares(C, left.T).T  # C† K (C†)ᵀ
    return SPSDResult(C=C, X=psd_project(X), col_idx=idx, entries_observed=n * n)


def fast_spsd_wang(gen: Optional[torch.Generator], oracle: KernelOracle, n: int, c: int,
                   s: int, *, col_idx=None, sketch: Optional[RowSampling] = None) -> SPSDResult:
    """Wang et al. 2016b (Eqn. 4.1): one leverage sampling sketch S,
    ``X̂ = (SC)† (S K Sᵀ) (Cᵀ Sᵀ)†``, PSD-projected (``nc + s²`` entries)."""
    _validate_sizes(n, c, s)
    idx, C = _resolve_columns(gen, oracle, n, c, col_idx)
    if sketch is None:
        sketch = RowSampling.draw(gen, s, n, probs=_leverage_probs(C), dtype=torch.float32)
    else:
        sketch, _ = _require_sampling((sketch, sketch))
    SC = sketch.apply(C)
    X = fast_gmr_core(SC, _sampled_block(oracle, sketch, sketch), SC.T)
    return SPSDResult(C=C, X=psd_project(X), col_idx=idx, entries_observed=n * c + s * s)


def faster_spsd(gen: Optional[torch.Generator], oracle: KernelOracle, n: int, c: int,
                s: int, *, col_idx=None,
                sketches: Optional[Tuple[RowSampling, RowSampling]] = None) -> SPSDResult:
    """**Algorithm 2**: c uniform columns → C (nc entries); two independent
    leverage sampling sketches S₁, S₂ of range(C);
    ``X̃ = (S₁C)† (S₁ K S₂ᵀ) (Cᵀ S₂ᵀ)†`` (s² more entries); ``X̃₊ = Π_PSD(X̃)``.
    ``col_idx`` replaces step 1, ``sketches=(S₁, S₂)`` the sketch draw."""
    _validate_sizes(n, c, s)
    idx, C = _resolve_columns(gen, oracle, n, c, col_idx)
    if sketches is None:
        S1, S2 = leverage_sampling_sketches(gen, C, s)
    else:
        S1, S2 = _require_sampling(sketches)
    S1C = S1.apply(C)  # (s, c), rows of the observed C, rescaled
    CS2 = S2.apply(C).T  # (c, s)
    X = fast_gmr_core(S1C, _sampled_block(oracle, S1, S2), CS2)
    return SPSDResult(C=C, X=psd_project(X), col_idx=idx, entries_observed=n * c + s * s)


def spsd_error_ratio(K: torch.Tensor, res: SPSDResult) -> torch.Tensor:
    """§6.2 metric ``‖K − C X Cᵀ‖_F / ‖K‖_F``, in fp32 or wider, a column
    block of ``K`` at a time (no second n × n buffer)."""
    num = residual_norm(K, res.C, res.X, res.C.T)
    return num / torch.linalg.norm(K.to(num.dtype))
