"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, as ordinary tensor ops.
The wrappers in :mod:`repro_torch.kernels.ops` take them for tensors that lie
on the CPU; the tests and ``chip_smoke.py`` hold the kernels against them.
Counterpart of ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import torch


def top_k_desc(x: torch.Tensor, k: int) -> tuple:
    """``jax.lax.top_k`` order: the ``k`` largest values, best first, ties to
    the lower index (a stable descending sort; ``torch.topk`` does not
    promise that tie order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def countsketch_ref(hashes: torch.Tensor, signs: torch.Tensor, a: torch.Tensor, s: int) -> torch.Tensor:
    """Signed segment sum ``out[h[i]] += sign[i]·a[i]`` in fp32, rows in order."""
    signed = a.float() * signs.float()[:, None]
    out = torch.zeros((s, a.shape[1]), dtype=torch.float32, device=a.device)
    return out.index_add_(0, hashes.long(), signed)


def panel_score_ref(sc: torch.Tensor, a_l: torch.Tensor, q: torch.Tensor) -> tuple:
    """``(sc_a, resid2, energy)``: ``sc_a = S_C·A_L``, the column energies and
    the residual energies against the zero-masked basis ``q``, all fp32."""
    sc_a = sc.float() @ a_l.float()
    energy = torch.sum(sc_a * sc_a, dim=0)
    t = q.float().T @ sc_a
    resid2 = torch.clamp(energy - torch.sum(t * t, dim=0), min=0.0)
    return sc_a, resid2, energy


def admission_slots(resid2, energy, *, min_gain, run_mean, true_cols, n_filled, free, panel_cap, c_total):
    """Per-column admission slot of one panel (``c_total`` = not admitted).

    ``thresh = min_gain·max(run_mean, Σenergy/true_cols)``; eligible columns
    (strictly above it) are ranked by ``resid2``, best first, ties to the
    lower index, and the first ``min(free, panel_cap)`` of them land in slots
    ``n_filled + rank``. The scalars may be 0-dim tensors or numbers.
    """
    L = resid2.shape[0]
    panel_mean = torch.sum(energy) / true_cols
    thresh = min_gain * torch.maximum(torch.as_tensor(run_mean, dtype=torch.float32,
                                                      device=resid2.device), panel_mean)
    eligible = resid2 > thresh
    K = min(panel_cap, L)
    _, cand = top_k_desc(torch.where(eligible, resid2, torch.full_like(resid2, -1.0)), K)
    cand_ok = eligible[cand]
    ranks = torch.cumsum(cand_ok.to(torch.int32), 0) - 1
    admit = cand_ok & (ranks < free)
    cand_slots = torch.where(admit, n_filled + ranks, torch.full_like(ranks, c_total))
    slots = torch.full((L,), c_total, dtype=torch.int32, device=resid2.device)
    slots[cand] = cand_slots.to(torch.int32)
    return slots


def panel_update_ref(sc, a_l, srt, q, C, M, *, min_gain, run_mean, true_cols,
                     n_filled, free, panel_cap: int) -> tuple:
    """The admission-only panel update, as separate ops, with ``C`` and ``M``
    updated in place: the scores, the admission slots, ``C[:, slot_j] =
    A_L[:, j]`` for each admitted column, and ``M += sc_a·srt``. Returns
    ``(C, M, sc_a, resid2, energy, slots)``."""
    sc_a, resid2, energy = panel_score_ref(sc, a_l, q)
    c_total = C.shape[1]
    slots = admission_slots(
        resid2, energy, min_gain=min_gain, run_mean=run_mean, true_cols=true_cols,
        n_filled=n_filled, free=free, panel_cap=panel_cap, c_total=c_total,
    )
    cols = torch.nonzero(slots < c_total).squeeze(1)
    C[:, slots[cols].long()] = a_l[:, cols].to(C.dtype)
    M.add_((sc_a @ srt.float()).to(M.dtype))
    return C, M, sc_a, resid2, energy, slots
