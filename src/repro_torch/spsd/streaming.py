"""Single-pass streaming SPSD approximation (Algorithm 2 over a kernel
stream; counterpart of ``repro/spsd/streaming.py``).

The kernel ``K`` arrives as column panels ``K_L`` that are never kept. The
stream is square and symmetric, so the engine runs in its tied-operand mode
(``PanelOps(symmetric=True)``): no R accumulator, ``R = Cᵀ`` derived. Per
panel, the selected kernel columns land in their C slots (fixed ``col_idx``,
:func:`streaming_spsd_init`) or are admitted in-stream by the adaptive
residual policy of :mod:`repro_torch.stream.adaptive` with ``rows=None``
(:func:`adaptive_spsd_init`), and ``M += S₁ K_L S₂[:, cols]ᵀ``. Finalize
solves ``X̃ = (S₁C)† M (Cᵀ S₂ᵀ)†`` and projects it onto the PSD cone.

Routes on CUDA tensors: the fixed-index stream and the adaptive CountSketch
stream take Route A (kernel 1's chunk sketch ``S₁·K`` once, kernel 1's fold
per panel); an admission-only adaptive stream with a Gaussian pair takes
Route B (kernel 3 every panel, ``M`` of s × s); on the per-panel route,
a Gaussian stream that Route B does not take (``swap_gain``) scores each
panel through kernel 2.

With the same ``col_idx`` and the RowSampling pair of
:func:`repro_torch.spsd.batch.leverage_sampling_sketches`, the streamed X
matches :func:`~repro_torch.spsd.batch.faster_spsd`'s up to fp32 order.
The sharding hooks and telemetry are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.gmr import fast_gmr_core
from ..core.projections import psd_project
from ..core.sketching import draw_sketch
from ..device import DeviceLike, resolve_device
from ..stream.adaptive import (
    AdaptiveCURCtx,
    _chunk_fold,
    _core_sketches,
    _fused_step,
    _panel_kernel,
    _sketch_panel,
    _supports_fused,
    _update_c,
)
from ..stream.engine import PanelOps, PanelState, copy_selected_columns, padded_n
from .batch import SPSDResult

__all__ = [
    "SPSDStreamCtx",
    "STREAMING_SPSD_OPS",
    "ADAPTIVE_SPSD_OPS",
    "streaming_spsd_init",
    "streaming_spsd_finalize",
    "adaptive_spsd_init",
    "adaptive_spsd_finalize",
]


@dataclasses.dataclass
class SPSDStreamCtx:
    """Fixed column selection and the tied-operand sketch pair: both (s, n)
    over the same index space; ``S2`` drives the ``M`` windows and is padded
    to ``n_pad``."""

    col_idx: torch.Tensor  # (c,) int32
    S1: object  # (s, n)
    S2: object  # (s, n_pad)


def _spsd_core_sketches(ctx: SPSDStreamCtx):
    return ctx.S1, ctx.S2


def _spsd_update_c(ctx: SPSDStreamCtx, C, K_L, sc_a, off):
    return ctx, copy_selected_columns(ctx.col_idx, C, K_L, off)


def _spsd_chunk_fold(ctx: SPSDStreamCtx, C, R, block, bcol0, start, width):
    """Route-A hook: the chunk's selected columns into their C slots in one
    gather (no R side: ``R = Cᵀ`` is derived)."""
    rel = ctx.col_idx.long() - start
    in_chunk = (rel >= 0) & (rel < width)
    picked = block[:, bcol0 + rel.clamp(0, width - 1)]
    C.copy_(torch.where(in_chunk[None, :], picked.to(C.dtype), C))
    return ctx, C, R


STREAMING_SPSD_OPS = PanelOps(
    name="streaming_spsd",
    core_sketches=_spsd_core_sketches,
    update_c=_spsd_update_c,
    chunk_fold=_spsd_chunk_fold,
    symmetric=True,
)

# The column half of adaptive CUR, verbatim, on the symmetric engine: the
# (0,)-row ``row_idx`` makes the R stripe of ``_chunk_fold`` empty, and
# Route B's gate takes the Gaussian S₂ as its S_R.
ADAPTIVE_SPSD_OPS = PanelOps(
    name="adaptive_spsd",
    core_sketches=_core_sketches,
    sketch_panel=_sketch_panel,
    update_c=_update_c,
    chunk_fold=_chunk_fold,
    fused_step=_fused_step,
    supports_fused=_supports_fused,
    panel_kernel=_panel_kernel,
    symmetric=True,
)


def _resolve_sketch_pair(gen, n, c, s, sketch, osnap_p, dtype, sketches, panel):
    """Validate the budget (``0 < c ≤ n``, ``s > 0``), draw the ``(S₁, S₂)``
    pair from ``gen`` (``s`` defaults to ``min(10·c, n)``) or take
    ``sketches``, fail fast on a family without windows (SRHT), and pad S₂
    to whole panels. Returns ``(S1, S2_padded, n_pad)``."""
    if not 0 < c <= n:
        raise ValueError(f"need 0 < c <= n column slots, got c={c}, n={n}")
    if sketches is None:
        if s is not None and s <= 0:
            raise ValueError(f"need s > 0 sketch rows, got s={s} (n={n})")
        if gen is None:
            raise ValueError("pass a generator or pre-drawn `sketches`")
        s = min(s or 10 * c, n)
        S1 = draw_sketch(gen, sketch, s, n, p=osnap_p, dtype=dtype)
        S2 = draw_sketch(gen, sketch, s, n, p=osnap_p, dtype=dtype)
    else:
        S1, S2 = sketches
    S2.cols(0, 1)  # raises for a family without windows
    n_pad = padded_n(n, panel) if panel else n
    return S1, S2.pad_cols(n_pad), n_pad


def _state(ctx, ops, n, c, n_pad, s1, s2, dtype, dev) -> PanelState:
    return PanelState(
        C=torch.zeros((n, c), dtype=dtype, device=dev),
        R=torch.zeros((0, n_pad), dtype=dtype, device=dev),  # tied operand: R = Cᵀ
        M=torch.zeros((s1, s2), dtype=dtype, device=dev),
        offset=0,
        ctx=ctx,
        ops=ops,
        n=n,
    )


def streaming_spsd_init(gen: Optional[torch.Generator], n: int, col_idx, *,
                        s: Optional[int] = None, sketch: str = "countsketch", osnap_p: int = 2,
                        dtype=torch.float32, sketches: Optional[Tuple] = None,
                        panel: Optional[int] = None, telemetry: bool = False,
                        device: DeviceLike = None) -> PanelState:
    """A fixed-index streaming-SPSD state on the symmetric engine.

    Arguments as in the reference's ``streaming_spsd_init``, with ``gen`` (a
    ``torch.Generator`` on ``device``, unused when ``sketches`` is given) in
    place of the key: ``col_idx`` (c,) the selected kernel columns; ``s``
    the sketch size (default ``min(10·c, n)``, the paper's §6.2 operating
    point); ``sketch`` the family of both draws; ``sketches`` a pre-drawn
    ``(S₁, S₂)``, e.g. :func:`~repro_torch.spsd.batch.leverage_sampling_sketches`;
    ``panel`` pads S₂ to whole panels. ``telemetry=True`` raises
    ``NotImplementedError`` (not ported yet); ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    if telemetry:
        raise NotImplementedError("telemetry is not ported yet (repro.obs)")
    col_idx = torch.as_tensor(col_idx).to(device=dev, dtype=torch.int32).clone()
    c = col_idx.shape[0]
    if c and not (0 <= int(col_idx.min()) and int(col_idx.max()) < n):
        raise ValueError(
            f"col_idx entries must lie in [0, {n}), got range "
            f"[{int(col_idx.min())}, {int(col_idx.max())}] — an "
            "out-of-range index would leave its C slot permanently zero"
        )
    S1, S2, n_pad = _resolve_sketch_pair(gen, n, c, s, sketch, osnap_p, dtype, sketches, panel)
    ctx = SPSDStreamCtx(col_idx=col_idx, S1=S1, S2=S2)
    return _state(ctx, STREAMING_SPSD_OPS, n, c, n_pad, S1.s, S2.s, dtype, dev)


def streaming_spsd_finalize(state: PanelState) -> SPSDResult:
    """``X̃ = (S₁C)† M (Cᵀ S₂ᵀ)†`` on the streamed pieces, PSD-projected;
    ``entries_observed`` is n² (every kernel entry streamed through once)."""
    ctx = state.ctx
    S1C = ctx.S1.apply(state.C)  # (s, c)
    CS2 = ctx.S2.apply(state.C).T  # (c, s)
    X = psd_project(fast_gmr_core(S1C, state.M, CS2))
    return SPSDResult(C=state.C, X=X, col_idx=ctx.col_idx, entries_observed=state.n * state.n)


def adaptive_spsd_init(gen: Optional[torch.Generator], n: int, c: int, *,
                       s: Optional[int] = None, sketch: str = "countsketch", osnap_p: int = 2,
                       min_gain: float = 2.0, panel_cap: Optional[int] = None,
                       swap_gain: Optional[float] = None, dtype=torch.float32,
                       sketches: Optional[Tuple] = None, panel: Optional[int] = None,
                       telemetry: bool = False, device: DeviceLike = None) -> PanelState:
    """Adaptive streaming SPSD: kernel columns are admitted in-stream by the
    column policy of :func:`~repro_torch.stream.adaptive.adaptive_cur_init`
    (``min_gain``, ``panel_cap``, ``swap_gain``) with the row machinery off.
    Other arguments as in :func:`streaming_spsd_init`."""
    dev = resolve_device(device)
    if telemetry:
        raise NotImplementedError("telemetry is not ported yet (repro.obs)")
    S1, S2, n_pad = _resolve_sketch_pair(gen, n, c, s, sketch, osnap_p, dtype, sketches, panel)
    zeros_i = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    ctx = AdaptiveCURCtx(
        col_idx=torch.full((c,), -1, dtype=torch.int32, device=dev),
        row_idx=torch.zeros((0,), dtype=torch.int32, device=dev),  # tied operand: no rows
        S_C=S1,
        S_R=S2,
        ScC=torch.zeros((S1.s, c), dtype=dtype, device=dev),
        slot_score=torch.zeros((c,), dtype=torch.float32, device=dev),
        n_filled=zeros_i(),
        energy=torch.zeros((), dtype=torch.float32, device=dev),
        cols_seen=torch.zeros((), dtype=torch.float32, device=dev),
        min_gain=float(min_gain),
        swap_gain=float("inf") if swap_gain is None else float(swap_gain),
        n_evicted=zeros_i(),
        rows=None,
        c_local=c,
        panel_cap=panel_cap if panel_cap is not None else max(1, c // 8),
        n=n,
        evict=swap_gain is not None,
    )
    return _state(ctx, ADAPTIVE_SPSD_OPS, n, c, n_pad, S1.s, S2.s, dtype, dev)


def adaptive_spsd_finalize(state: PanelState) -> SPSDResult:
    """The core solve on the admitted columns, PSD-projected. Unfilled slots
    (zero C columns) get their core rows and columns zeroed before the
    projection, so the floored solve's finite values there cannot leak into
    ``C X Cᵀ`` (zeroing a symmetric row/column pair keeps a PSD matrix PSD)."""
    ctx = state.ctx
    CS2 = ctx.S_R.apply(state.C).T  # (c, s)
    X = fast_gmr_core(ctx.ScC, state.M, CS2)  # ScC is S₁C by construction
    filled = ctx.col_idx >= 0
    X = torch.where(filled[:, None] & filled[None, :], X, torch.zeros((), dtype=X.dtype,
                                                                        device=X.device))
    return SPSDResult(C=state.C, X=psd_project(X), col_idx=ctx.col_idx,
                      entries_observed=state.n * state.n)
