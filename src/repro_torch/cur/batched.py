"""Batched CUR for serving: a stack ``A (B, m, n)`` of small matrices
(counterpart of ``repro/cur/batched.py``).

* **Shared core sketches** ``S_C (s_c×m)``, ``S_R (s_r×n)`` across the batch
  (dense Gaussian), so the hot spot ``M_b = S_C A_b S_Rᵀ`` is one batched
  product: on a CUDA tensor the hand-written kernel 4
  (:func:`repro_torch.kernels.ops.twoside_sketch`), with the batch on its
  grid.
* **Per-item selection**: ``selection="uniform"`` (one batched draw for
  the stack) or ``"approx_leverage"`` (the sketched-leverage policy of
  :mod:`repro_torch.cur.selection`, each item with its own generator seeded
  from the caller's). The reference ``vmap``s this over folded keys; here
  the leverage policy is a loop over items.

``batched_fast_cur(...)`` equals a loop of :func:`repro_torch.cur.fast_cur`
with the same shared sketches and per-item indices (tested).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.gmr import fast_gmr_core
from ..core.sketching import GaussianSketch
from ..device import generator
from ..kernels import ops
from .cur import CURResult, cur_sketch_sizes
from .selection import select_columns, select_rows

__all__ = ["batched_fast_cur", "draw_shared_sketches"]

SELECTIONS = ("uniform", "approx_leverage")


def draw_shared_sketches(gen: torch.Generator, m: int, n: int, s_c: int, s_r: int,
                         dtype=torch.float32) -> Tuple[GaussianSketch, GaussianSketch]:
    """One Gaussian ``(S_C, S_R)`` pair shared by every item.

    A ``dtype`` narrower than float32 gives a float32 pair, as the
    reference's draw comes out (its ``1/√s`` scale promotes it), so a bf16
    stack is sketched in float32 there and here.
    """
    dtype = torch.promote_types(dtype, torch.float32)
    return GaussianSketch.draw(gen, s_c, m, dtype), GaussianSketch.draw(gen, s_r, n, dtype)


def _pick(gen: torch.Generator, A: torch.Tensor, c: int, r: int, selection: str,
          k: Optional[int]) -> tuple:
    """Per-item ``(col_idx (B, c), row_idx (B, r))``: uniform draws for the
    whole stack at once, or the leverage policy item by item, one generator
    each."""
    B, m, n = A.shape
    if selection == "uniform":
        def draw(size, k_):  # the first k_ of a uniform random permutation per row
            keys = torch.rand((B, size), generator=gen, device=gen.device, dtype=torch.float64)
            return keys.argsort(dim=1)[:, :k_].to(device=A.device, dtype=torch.int32)
        return draw(n, c), draw(m, r)
    seeds = torch.randint(0, 2**62, (B,), generator=gen, device=gen.device).tolist()
    cols, rows = [], []
    for b, seed in enumerate(seeds):
        g = generator(seed, A.device)
        cols.append(select_columns(g, A[b], c, "approx_leverage", k=k).idx)
        rows.append(select_rows(g, A[b], r, "approx_leverage", k=k).idx)
    return torch.stack(cols).to(torch.int32), torch.stack(rows).to(torch.int32)


def batched_fast_cur(gen: Optional[torch.Generator], A: torch.Tensor, c: int, r: int, *,
                     s_c: Optional[int] = None, s_r: Optional[int] = None, eps: float = 0.05,
                     rho_est: float = 2.0, sketches=None, use_kernel: Optional[bool] = None,
                     selection: str = "uniform", k: Optional[int] = None,
                     col_idx=None, row_idx=None) -> CURResult:
    """Fast CUR of a stack ``A (B, m, n)``; the result's tensors carry the
    leading batch dimension.

    ``M_b = S_C A_b S_Rᵀ`` goes through :func:`ops.twoside_sketch` unless
    ``use_kernel=False``, which takes the reference's einsum route instead
    (an explicit option; nothing falls back to it). The wrapper launches
    kernel 4 for a CUDA tensor and runs its plain version for a CPU one.
    ``sketches=(S_C, S_R)`` and ``col_idx (B, c)``/``row_idx (B, r)`` inject
    pre-drawn randomness (the parity tests hand the reference's across);
    otherwise the indices are drawn per item under ``selection`` and the
    sketches at Table-2 sizes, both from ``gen``.
    """
    if A.dim() != 3:
        raise ValueError(f"expected A of shape (B, m, n), got {tuple(A.shape)}")
    if selection not in SELECTIONS:
        raise ValueError(f"selection must be one of {SELECTIONS}, got {selection!r}")
    B, m, n = A.shape
    if col_idx is None or row_idx is None:
        picked = _pick(gen, A, c, r, selection, k)
        col_idx = picked[0] if col_idx is None else col_idx
        row_idx = picked[1] if row_idx is None else row_idx
    col_idx = torch.as_tensor(col_idx, device=A.device)
    row_idx = torch.as_tensor(row_idx, device=A.device)
    if sketches is None:
        sizes = cur_sketch_sizes(c, r, eps=eps, rho=rho_est)
        s_c = min(s_c or sizes["s_c"], m)
        s_r = min(s_r or sizes["s_r"], n)
        sketches = draw_shared_sketches(gen, m, n, s_c, s_r, dtype=A.dtype)
    S_C, S_R = sketches

    C = torch.take_along_dim(A, col_idx[:, None, :].long(), dim=2)  # (B, m, c)
    R = torch.take_along_dim(A, row_idx[:, :, None].long(), dim=1)  # (B, r, n)
    # injected sketches may differ from A in dtype: promote, as jnp does
    dt = torch.promote_types(A.dtype, S_C.mat.dtype)
    Sc, Sr, Ap = S_C.mat.to(dt), S_R.mat.to(dt), A.to(dt)
    if use_kernel is False:
        M = torch.einsum("sm,bmn,tn->bst", Sc, Ap, Sr)
    else:
        M = ops.twoside_sketch(Sc, Ap, Sr.T).to(A.dtype)
    ScC = Sc @ C.to(dt)  # (B, s_c, c)
    RSr = R.to(dt) @ Sr.T  # (B, r, s_r)
    U = fast_gmr_core(ScC, M, RSr)  # (B, c, r)
    return CURResult(C=C, U=U, R=R, col_idx=col_idx, row_idx=row_idx)
