"""Adaptive streaming CUR: in-stream column admission and eviction, and row
admission with backfill (counterpart of ``repro/stream/adaptive.py``).

Columns are scored from the panel sketch ``y = S_C a_j`` alone:
``score_j = ‖y‖² − ‖Qᵀ y‖²`` with ``Q`` the Gram-whitened basis of the
admitted columns' sketches (:func:`_whitened_basis`). A column is admitted
into the next free ``C`` slot when its score clears ``min_gain ×`` the mean
column energy (the larger of the running and the panel mean), at most
``panel_cap`` per panel, best first with ties to the lower index (the order
of ``jax.lax.top_k``). With ``swap_gain`` set, a full budget evicts its
weakest slot for a candidate that clears ``swap_gain ×`` that slot's
retained energy. Adaptive rows accumulate ``A S_Rᵀ`` and admit rows by the
same residual rule; a late-admitted row's missed column prefix is backfilled
from its sketched reconstruction.

Routes through the engine (:mod:`repro_torch.stream.engine`):

* Route B (``_panel_kernel``) on CUDA tensors for admission-only, fixed-row,
  Gaussian streams: kernel 3 does the sketch, scores, admission, ``C``
  writes and ``M`` fold of each panel;
* Route A (``_chunk_fold`` + ``_fused_step``) otherwise, without adaptive rows;
* the per-panel body (``_sketch_panel`` + ``_update_c`` + ``_update_r``)
  for adaptive rows; ``_sketch_panel`` runs kernel 2 on CUDA with a Gaussian
  ``S_C``.

Slot writes use :func:`_scatter_drop`, which needs no host sync; the host
reads one value per panel only where a loop or a branch needs it (the
eviction loop's candidate count, the backfill's "any fresh row" test). The
distributed (sharding) hooks are not ported yet; this is one worker.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.gmr import fast_gmr_core
from ..core.sketching import GaussianSketch, draw_sketch
from ..device import DeviceLike, resolve_device
from ..kernels import ops
from ..kernels.ref import top_k_desc
from .engine import PanelOps, PanelState, padded_n, truncated_R

__all__ = [
    "AdaptiveCURCtx",
    "AdaptiveRowState",
    "ADAPTIVE_CUR_OPS",
    "adaptive_cur_init",
    "adaptive_cur_finalize",
]


@dataclasses.dataclass
class AdaptiveRowState:
    """Adaptive row-admission state (only when rows are adaptive); see the
    reference's docstring. ``gram`` covers the S_R windows of ``[seen_lo, off)``
    when the backfill reads it; ``sr_dense`` is the dense S_R, built once."""

    row_sketch: torch.Tensor  # (m, s_r) running A S_Rᵀ over seen columns
    backfill: torch.Tensor  # (r, s_r) pre-panel sketches of this panel's admits
    admit_off: torch.Tensor  # (r,) int32 admission offset per slot, −1 = unfilled
    gram: torch.Tensor  # (s_r, s_r)
    gram_pending: torch.Tensor  # (s_r, s_r) current panel's window Gram
    sr_dense: torch.Tensor  # (s_r, n_pad)
    n_filled: torch.Tensor  # () int32 — next free row slot
    min_gain: float
    seen_lo: int  # first column offset seen, −1 = none yet
    r_local: int
    panel_cap: int


@dataclasses.dataclass
class AdaptiveCURCtx:
    """Admission/eviction state threaded through the panel stream."""

    col_idx: torch.Tensor  # (c,) int32, −1 = unfilled slot
    row_idx: torch.Tensor  # (r,) int32, −1 = unfilled
    S_C: object
    S_R: object
    ScC: torch.Tensor  # (s_c, c) sketches of the admitted columns, by slot
    slot_score: torch.Tensor  # (c,) f32 retained energy at admission
    n_filled: torch.Tensor  # () int32 next free slot
    energy: torch.Tensor  # () f32 running Σ ‖S_C a_j‖²
    cols_seen: torch.Tensor  # () f32 true columns seen
    min_gain: float
    swap_gain: float  # +inf = eviction off
    n_evicted: torch.Tensor  # () int32
    rows: Optional[AdaptiveRowState]
    c_local: int
    panel_cap: int
    n: int
    evict: bool = False


def _scatter_drop(X: torch.Tensor, dim: int, slots: torch.Tensor, src: torch.Tensor,
                  admit: torch.Tensor) -> torch.Tensor:
    """In place ``X[..., slots[k], ...] = src[..., k, ...]`` along ``dim`` for
    the ``k`` with ``admit[k]``, the others dropped, without a host sync.

    The admitted slots are distinct. Each dropped entry is sent to the slot of
    the first admitted entry with that entry's value (or, when none is
    admitted, to slot 0 with its current value), so every duplicate index of
    the one ``index_copy_`` carries the same bits and the result does not
    depend on the order of the writes.
    """
    if slots.numel() == 0:
        return X
    shape = [1] * X.dim()
    shape[dim] = -1
    k0 = torch.argmax(admit.to(torch.int32)).reshape(1)
    has = admit[k0]
    target = torch.where(admit, slots, torch.where(has, slots[k0], 0)).long()
    zero = torch.zeros(1, dtype=torch.long, device=X.device)
    anchor = torch.where(has.reshape([1] * X.dim()), src.index_select(dim, k0).to(X.dtype),
                         X.index_select(dim, zero))
    vals = torch.where(admit.reshape(shape), src.to(X.dtype), anchor)
    return X.index_copy_(dim, target, vals)


def _core_sketches(ctx):
    return ctx.S_C, ctx.S_R


def _whitened_basis(mat: torch.Tensor) -> torch.Tensor:
    """``Q = mat·L⁻ᵀ`` with ``LLᵀ = matᵀmat + λI``, ``λ = c·eps·tr(G) + tiny``:
    ``‖y‖² − ‖Qᵀy‖²`` is the ridge-regularised projection residual, zero
    columns of ``mat`` give zero columns of ``Q``, and the ridge keeps the
    Cholesky factorisation finite for duplicate columns."""
    M = mat.float()
    G = M.T @ M
    finfo = torch.finfo(torch.float32)
    lam = G.shape[0] * finfo.eps * torch.trace(G) + finfo.tiny
    L, _ = torch.linalg.cholesky_ex(G + lam * torch.eye(G.shape[0], device=G.device))
    return torch.linalg.solve_triangular(L, M.T, upper=False).T.contiguous()


def _admitted_basis(ctx: AdaptiveCURCtx) -> torch.Tensor:
    return _whitened_basis(ctx.ScC)


def _score_columns(Qm: torch.Tensor, sc_a: torch.Tensor) -> tuple:
    """Per-column ``(resid2, energy)`` of the panel sketches against ``Qm``."""
    y = sc_a.float()
    energy = torch.sum(y * y, dim=0)
    t = Qm.T @ y
    resid2 = torch.clamp(energy - torch.sum(t * t, dim=0), min=0.0)
    return resid2, energy


def _sketch_panel(ctx: AdaptiveCURCtx, A_L, off):
    """Engine ``sketch_panel`` hook: ``sc_a = S_C A_L`` and the column scores
    in one pass — kernel 2 on CUDA with a Gaussian ``S_C``, otherwise the
    structured sketch apply plus the scoring ops."""
    Qm = _admitted_basis(ctx)
    if A_L.is_cuda and isinstance(ctx.S_C, GaussianSketch):
        sc_a, resid2, energy = ops.panel_score(ctx.S_C.mat[:, : A_L.shape[0]], A_L, Qm)
    else:
        sc_a = ctx.S_C.apply(A_L)
        resid2, energy = _score_columns(Qm, sc_a)
    return ctx, sc_a, (resid2, energy)


def _admit_or_evict_columns(ctx: AdaptiveCURCtx, C, block, col0, sc_a, resid2, eligible, off):
    """Admit the top-``panel_cap`` eligible columns into free slots or, with
    eviction on and the budget full, swap out the weakest slot. The panel's
    columns are ``block[:, col0 + j]``."""
    L = sc_a.shape[1]
    c_total = C.shape[1]
    K = min(ctx.panel_cap, L)
    cand_res, cand = top_k_desc(torch.where(eligible, resid2, torch.full_like(resid2, -1.0)), K)
    cand_ok = eligible[cand]
    cand_A = block[:, col0 + cand]  # (m, K)
    cand_sc = sc_a[:, cand]  # (s_c, K)
    cand_idx = (off + cand).to(torch.int32)

    if not ctx.evict:
        # admission only: candidate k (best first) takes slot n_filled + rank
        ranks = torch.cumsum(cand_ok.to(torch.int32), 0) - 1
        admit = cand_ok & (ranks < ctx.c_local - ctx.n_filled)
        slots = torch.where(admit, ctx.n_filled + ranks, c_total)
        _scatter_drop(C, 1, slots, cand_A, admit)
        _scatter_drop(ctx.ScC, 1, slots, cand_sc, admit)
        _scatter_drop(ctx.col_idx, 0, slots, cand_idx, admit)
        _scatter_drop(ctx.slot_score, 0, slots, cand_res, admit)
        ctx.n_filled = (ctx.n_filled + admit.sum()).to(torch.int32)
        return ctx, C

    # Sequential: each decision changes the slot table the next one sees.
    # Eligible candidates lead the best-first list (their scores beat the −1
    # mask) and an ineligible one changes nothing, so the loop stops at them.
    for k in range(int(cand_ok.sum())):
        admit = ctx.n_filled < ctx.c_local  # a free slot is left
        scores = torch.where(ctx.col_idx >= 0, ctx.slot_score,
                             torch.full_like(ctx.slot_score, float("inf")))
        victim = torch.argmin(scores)
        swap = ~admit & (cand_res[k] > ctx.swap_gain * scores[victim])
        slot = torch.where(admit, ctx.n_filled, torch.where(swap, victim, c_total)).reshape(1)
        take = (admit | swap).reshape(1)
        _scatter_drop(C, 1, slot, cand_A[:, k : k + 1], take)
        _scatter_drop(ctx.ScC, 1, slot, cand_sc[:, k : k + 1], take)
        _scatter_drop(ctx.col_idx, 0, slot, cand_idx[k : k + 1], take)
        _scatter_drop(ctx.slot_score, 0, slot, cand_res[k : k + 1], take)
        ctx.n_filled = (ctx.n_filled + admit.to(torch.int32)).to(torch.int32)
        ctx.n_evicted = (ctx.n_evicted + swap.to(torch.int32)).to(torch.int32)
    return ctx, C


def _admit_rows(ctx: AdaptiveCURCtx, A_L, off):
    """Fold the panel into the row sketch and admit the top residual rows
    into free row slots (the ``R`` writes happen in ``_update_r``)."""
    rows = ctx.rows
    L, m = A_L.shape[1], A_L.shape[0]
    r_total = ctx.row_idx.shape[0]
    prev = rows.row_sketch
    row_sketch = prev + ctx.S_R.cols(off, L).apply_t(A_L).to(prev.dtype)
    if rows.seen_lo < 0:
        rows.seen_lo = off
    Sw = rows.sr_dense[:, off : off + L]
    gram = rows.gram + rows.gram_pending
    gram_pending = Sw @ Sw.T

    filled = ctx.row_idx >= 0
    basis = row_sketch[ctx.row_idx.clamp(min=0).long()]
    basis = torch.where(filled[:, None], basis, torch.zeros((), dtype=basis.dtype, device=basis.device))
    Qm = _whitened_basis(basis.T)
    t = row_sketch.float() @ Qm
    row_energy = torch.sum(row_sketch * row_sketch, dim=1)
    resid2 = torch.clamp(row_energy - torch.sum(t * t, dim=1), min=0.0)

    taken = torch.zeros(m + 1, dtype=torch.bool, device=A_L.device)
    taken[torch.where(filled, ctx.row_idx, m).long()] = True
    mean_energy = torch.sum(row_energy) / m
    eligible = (resid2 > rows.min_gain * mean_energy) & ~taken[:m]

    K = min(rows.panel_cap, m)
    _, top = top_k_desc(torch.where(eligible, resid2, torch.full_like(resid2, -1.0)), K)
    free = rows.r_local - rows.n_filled
    cap = torch.clamp(torch.minimum(free, eligible.sum()), max=rows.panel_cap)
    ar = torch.arange(K, device=A_L.device)
    admit = ar < cap
    slots = torch.where(admit, rows.n_filled + ar, r_total)
    _scatter_drop(ctx.row_idx, 0, slots, top.to(torch.int32), admit)
    _scatter_drop(rows.admit_off, 0, slots, torch.full((K,), off, dtype=torch.int32,
                                                       device=A_L.device), admit)
    backfill = torch.zeros_like(rows.backfill)
    _scatter_drop(backfill, 0, slots, prev[top], admit)
    rows.row_sketch, rows.backfill = row_sketch, backfill
    rows.gram, rows.gram_pending = gram, gram_pending
    rows.n_filled = (rows.n_filled + cap).to(torch.int32)
    return ctx


def _score_and_admit(ctx: AdaptiveCURCtx, C, block, col0, sc_a, resid2, col_energy, off):
    """Threshold, admit/evict, and fold the energy bookkeeping. The mean is
    the larger of the running mean and this panel's mean over true columns."""
    L = sc_a.shape[1]
    true_cols = float(min(max(ctx.n - off, 1), L))
    panel_mean = torch.sum(col_energy) / true_cols
    run_mean = ctx.energy / torch.clamp(ctx.cols_seen, min=1.0)
    thresh = ctx.min_gain * torch.maximum(run_mean, panel_mean)
    eligible = resid2 > thresh  # strict: zero-padded tail columns never pass
    ctx, C = _admit_or_evict_columns(ctx, C, block, col0, sc_a, resid2, eligible, off)
    ctx.energy = ctx.energy + torch.sum(col_energy)
    ctx.cols_seen = ctx.cols_seen + float(min(max(ctx.n - off, 0), L))
    return ctx, C


def _update_c(ctx: AdaptiveCURCtx, C, A_L, sc_a, off, scores):
    resid2, col_energy = scores
    ctx, C = _score_and_admit(ctx, C, A_L, 0, sc_a, resid2, col_energy, off)
    if ctx.rows is not None:
        ctx = _admit_rows(ctx, A_L, off)
    return ctx, C


def _update_r(ctx: AdaptiveCURCtx, R, A_L, off):
    """Write the panel block of the current rows (unfilled slots zero), then
    backfill the missed prefix ``[seen_lo, off)`` of rows admitted this panel
    with ``x = S_preᵀ (S_pre S_preᵀ + λI)⁻¹ y``."""
    L = A_L.shape[1]
    filled = ctx.row_idx >= 0
    blk = A_L[ctx.row_idx.clamp(min=0).long()]
    blk = torch.where(filled[:, None], blk, torch.zeros((), dtype=blk.dtype, device=blk.device))
    R[:, off : off + L] = blk.to(R.dtype)
    rows = ctx.rows
    if rows is None:
        return R
    fresh = (rows.admit_off == off) & filled
    lo = rows.seen_lo
    if off > lo and bool(fresh.any()):
        G = rows.gram
        lam = 1e-6 * torch.trace(G) / G.shape[0] + torch.finfo(torch.float32).tiny
        Z = torch.linalg.solve(G + lam * torch.eye(G.shape[0], device=G.device),
                               rows.backfill.T.float())  # (s_r, r)
        Xb = Z.T @ rows.sr_dense[:, lo:off]  # (r, off − lo)
        R[:, lo:off] = torch.where(fresh[:, None], Xb.to(R.dtype), R[:, lo:off])
    return R


def _chunk_fold(ctx: AdaptiveCURCtx, C, R, block, bcol0, start, width):
    """Route-A hook: the chunk's fixed-row ``R`` stripe in one pass."""
    filled = ctx.row_idx >= 0
    stripe = block[ctx.row_idx.clamp(min=0).long(), bcol0 : bcol0 + width]
    stripe = torch.where(filled[:, None], stripe,
                         torch.zeros((), dtype=stripe.dtype, device=stripe.device))
    R[:, start : start + width] = stripe.to(R.dtype)
    return ctx, C, R


def _fused_step(ctx: AdaptiveCURCtx, C, block, bcol, sc_a, off):
    """Route-A hook: score the pre-sliced panel sketch and admit/evict,
    gathering candidates straight from ``block[:, bcol + j]``."""
    Qm = _admitted_basis(ctx)
    resid2, col_energy = _score_columns(Qm, sc_a)
    ctx, C = _score_and_admit(ctx, C, block, bcol, sc_a, resid2, col_energy, off)
    return ctx, C, (resid2, col_energy)


def _kernel_ok(ctx: AdaptiveCURCtx) -> bool:
    """Route-B gate: CUDA tensors (or the forced test route), admission-only
    columns, fixed rows, Gaussian sketches on both sides."""
    return (
        ops.kernel_route_enabled(ctx.ScC)
        and not ctx.evict
        and ctx.rows is None
        and isinstance(ctx.S_C, GaussianSketch)
        and isinstance(ctx.S_R, GaussianSketch)
    )


def _supports_fused(ctx: AdaptiveCURCtx) -> bool:
    """Route-A gate: not with adaptive rows (per panel by nature), and not
    when Route B takes every panel."""
    return ctx.rows is None and not _kernel_ok(ctx)


def _panel_kernel(ctx: AdaptiveCURCtx, C, M, A_L, off):
    """Route-B hook: kernel 3 does the sketch, scores, admission, ``C``
    writes and ``M`` fold of the panel; the whitening and the slot-table
    bookkeeping stay here. ``None`` when the config is outside its contract;
    dtypes the kernel does not take raise in :func:`ops.panel_update`."""
    if not _kernel_ok(ctx):
        return None
    L = A_L.shape[1]
    c_total = C.shape[1]
    Qm = _admitted_basis(ctx)
    srt = ctx.S_R.mat[:, off : off + L].T  # (L, s_r) window, no copy
    run_mean = ctx.energy / torch.clamp(ctx.cols_seen, min=1.0)
    true_cols = float(min(max(ctx.n - off, 1), L))
    free = ctx.c_local - ctx.n_filled
    C, M, sc_a, resid2, energy, slots = ops.panel_update(
        ctx.S_C.mat[:, : A_L.shape[0]], A_L, srt, Qm, C, M,
        min_gain=ctx.min_gain, run_mean=run_mean, true_cols=true_cols,
        n_filled=ctx.n_filled, free=free, panel_cap=ctx.panel_cap,
    )
    admit = slots < c_total
    cols = (off + torch.arange(L, device=slots.device)).to(torch.int32)
    _scatter_drop(ctx.ScC, 1, slots, sc_a, admit)
    _scatter_drop(ctx.col_idx, 0, slots, cols, admit)
    _scatter_drop(ctx.slot_score, 0, slots, resid2, admit)
    ctx.n_filled = (ctx.n_filled + admit.sum()).to(torch.int32)
    ctx.energy = ctx.energy + torch.sum(energy)
    ctx.cols_seen = ctx.cols_seen + float(min(max(ctx.n - off, 0), L))
    return ctx, C, M, sc_a, (resid2, energy)


ADAPTIVE_CUR_OPS = PanelOps(
    name="adaptive_cur",
    core_sketches=_core_sketches,
    sketch_panel=_sketch_panel,
    update_c=_update_c,
    update_r=_update_r,
    chunk_fold=_chunk_fold,
    fused_step=_fused_step,
    supports_fused=_supports_fused,
    panel_kernel=_panel_kernel,
)


def adaptive_cur_init(
    gen: Optional[torch.Generator],
    m: int,
    n: int,
    c: int,
    row_idx=None,
    *,
    r: Optional[int] = None,
    s_c: Optional[int] = None,
    s_r: Optional[int] = None,
    eps: float = 0.05,
    rho_est: float = 2.0,
    sketch: str = "countsketch",
    osnap_p: int = 2,
    min_gain: float = 2.0,
    panel_cap: Optional[int] = None,
    swap_gain: Optional[float] = None,
    min_gain_rows: Optional[float] = None,
    panel_cap_rows: Optional[int] = None,
    dtype=torch.float32,
    sketches=None,
    panel: Optional[int] = None,
    telemetry: bool = False,
    device: DeviceLike = None,
) -> PanelState:
    """Allocate an adaptive streaming-CUR state with an empty column budget.

    Arguments as in the reference's ``adaptive_cur_init``, with ``gen`` (a
    ``torch.Generator`` on ``device``, unused when ``sketches`` is given) in
    place of the key. ``row_idx=None`` with ``r=`` turns on adaptive rows.
    ``telemetry=True`` raises ``NotImplementedError`` (not ported yet).
    ``device=None`` means CUDA and raises without it.
    """
    # imported here: repro_torch.cur imports the SPSD modules, which import this one
    from ..cur.cur import cur_sketch_sizes

    dev = resolve_device(device)
    if telemetry:
        raise NotImplementedError("telemetry is not ported yet (repro.obs)")
    adaptive_rows = row_idx is None
    if adaptive_rows:
        if r is None:
            raise ValueError("pass `row_idx` (fixed rows) or `r=` (adaptive rows)")
        row_idx_t = torch.full((r,), -1, dtype=torch.int32, device=dev)
    else:
        if r is not None:
            raise ValueError("`r=` is the adaptive-row budget and requires `row_idx=None`")
        row_idx_t = torch.as_tensor(row_idx).to(device=dev, dtype=torch.int32).clone()
        r = row_idx_t.shape[0]
    n_pad = padded_n(n, panel) if panel else n
    if sketches is None:
        if gen is None:
            raise ValueError("pass a generator or pre-drawn `sketches`")
        sizes = cur_sketch_sizes(c, r, eps=eps, rho=rho_est)
        s_c = min(s_c or sizes["s_c"], m)
        s_r = min(s_r or sizes["s_r"], n)
        S_C = draw_sketch(gen, sketch, s_c, m, p=osnap_p, dtype=dtype)
        S_R = draw_sketch(gen, sketch, s_r, n, p=osnap_p, dtype=dtype)
    else:
        S_C, S_R = sketches
        s_c, s_r = S_C.s, S_R.s
    S_R = S_R.pad_cols(n_pad)
    zeros_i = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    rows = None
    if adaptive_rows:
        rows = AdaptiveRowState(
            row_sketch=torch.zeros((m, s_r), dtype=torch.float32, device=dev),
            backfill=torch.zeros((r, s_r), dtype=torch.float32, device=dev),
            admit_off=torch.full((r,), -1, dtype=torch.int32, device=dev),
            gram=torch.zeros((s_r, s_r), dtype=torch.float32, device=dev),
            gram_pending=torch.zeros((s_r, s_r), dtype=torch.float32, device=dev),
            sr_dense=S_R.materialize().float(),
            n_filled=zeros_i(),
            min_gain=float(min_gain if min_gain_rows is None else min_gain_rows),
            seen_lo=-1,
            r_local=r,
            panel_cap=panel_cap_rows if panel_cap_rows is not None else max(1, r // 8),
        )
    ctx = AdaptiveCURCtx(
        col_idx=torch.full((c,), -1, dtype=torch.int32, device=dev),
        row_idx=row_idx_t,
        S_C=S_C,
        S_R=S_R,
        ScC=torch.zeros((s_c, c), dtype=dtype, device=dev),
        slot_score=torch.zeros((c,), dtype=torch.float32, device=dev),
        n_filled=zeros_i(),
        energy=torch.zeros((), dtype=torch.float32, device=dev),
        cols_seen=torch.zeros((), dtype=torch.float32, device=dev),
        min_gain=float(min_gain),
        swap_gain=float("inf") if swap_gain is None else float(swap_gain),
        n_evicted=zeros_i(),
        rows=rows,
        c_local=c,
        panel_cap=panel_cap if panel_cap is not None else max(1, c // 8),
        n=n,
        evict=swap_gain is not None,
    )
    return PanelState(
        C=torch.zeros((m, c), dtype=dtype, device=dev),
        R=torch.zeros((r, n_pad), dtype=dtype, device=dev),
        M=torch.zeros((s_c, s_r), dtype=dtype, device=dev),
        offset=0,
        ctx=ctx,
        ops=ADAPTIVE_CUR_OPS,
        n=n,
    )


def adaptive_cur_finalize(state: PanelState) -> CURResult:
    """Fast-GMR core solve on the admitted columns/rows; unfilled slots get
    zeroed core rows/columns. ``col_idx``/``row_idx`` hold −1 there."""
    from ..cur.cur import CURResult  # see adaptive_cur_init

    ctx = state.ctx
    R = truncated_R(state)
    RSr = ctx.S_R.apply_t(R)
    U = fast_gmr_core(ctx.ScC, state.M, RSr)
    zero = torch.zeros((), dtype=U.dtype, device=U.device)
    U = torch.where((ctx.col_idx >= 0)[:, None], U, zero)
    if ctx.rows is not None:
        U = torch.where((ctx.row_idx >= 0)[None, :], U, zero)
    return CURResult(C=state.C, U=U, R=R, col_idx=ctx.col_idx, row_idx=ctx.row_idx)
