"""Column/row selection for CUR (counterpart of ``repro/cur/selection.py``).

Only the ``uniform`` policy is ported: ``c`` distinct indices drawn uniformly
without replacement from a ``torch.Generator``. The leverage and pivoted-QR
policies are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["Selection", "SELECTION_POLICIES", "select_columns", "select_rows"]

SELECTION_POLICIES = ("uniform",)


class Selection(NamedTuple):
    """Chosen indices plus the sampling distribution that produced them."""

    idx: torch.Tensor  # (c,) int32
    probs: Optional[torch.Tensor]  # (n,) distribution used


def _select(gen: torch.Generator, n: int, c: int, policy: str, device) -> Selection:
    if not 0 < c <= n:
        raise ValueError(f"need 0 < c <= n, got c={c}, n={n}")
    if policy != "uniform":
        raise ValueError(f"unknown or unported policy {policy!r}; expected one of {SELECTION_POLICIES}")
    idx = torch.randperm(n, generator=gen, device=gen.device)[:c].to(device=device, dtype=torch.int32)
    probs = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    return Selection(idx=idx, probs=probs)


def select_columns(gen: torch.Generator, A: torch.Tensor, c: int, policy: str = "uniform") -> Selection:
    """Pick ``c`` column indices of ``A`` under ``policy``."""
    return _select(gen, A.shape[1], c, policy, A.device)


def select_rows(gen: torch.Generator, A: torch.Tensor, r: int, policy: str = "uniform") -> Selection:
    """Pick ``r`` row indices of ``A`` — :func:`select_columns` on ``Aᵀ``."""
    return _select(gen, A.shape[0], r, policy, A.device)
