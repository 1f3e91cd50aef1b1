"""Panel-streaming engine: C/R/M accumulators over L-column panels.

Counterpart of ``repro/stream/engine.py``. ``A`` arrives as L-column panels
``A_L`` that are never kept; per panel the engine folds

* ``C`` (m × c)  — the column factor, through the application's ``update_c``;
* ``R`` (r × n)  — the row factor, block by block at the panel's offset;
* ``M`` (s_c × s_r) — ``M += (S_C A_L) · S_R[:, cols]ᵀ`` via ``cols()``.

Applications plug in a :class:`PanelOps`. The accumulators are updated in
place (the reference donates their buffers to the same end), so a caller
keeps only the state that :func:`stream_panels` returns.

:func:`stream_panels` has two routes:

* ``route="chunk"`` (default; the reference's ``"scan"`` mode) runs Route A
  — the chunk sketch ``S_C·window`` once, panel-invariant factor writes
  folded once by ``chunk_fold``, then a thin per-panel loop — where
  :func:`_fused_route_ok` holds, and the per-panel body otherwise;
* ``route="per-panel"`` always runs the per-panel body
  (:func:`panel_update`), the parity oracle.

Both zero-pad the ragged tail, which is exact because the sketches were
extended with ``pad_cols`` at init. Route B — one kernel launch per panel
through ``PanelOps.panel_kernel`` — is tried first by :func:`panel_update`.
Telemetry and the distributed hooks are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.profiler import record_function

__all__ = [
    "PanelOps",
    "PanelState",
    "panel_update",
    "stream_panels",
    "padded_n",
    "copy_selected_columns",
    "truncated_R",
    "with_quarantine",
]

ROUTES = ("chunk", "per-panel")


def copy_selected_columns(col_idx, C, A_L, off: int):
    """Every panel column whose global index is in ``col_idx`` lands in its
    C slot (in place); other slots, and −1 sentinels, are left as they are."""
    L = A_L.shape[1]
    rel = col_idx.long() - off
    in_panel = (rel >= 0) & (rel < L)
    picked = A_L[:, rel.clamp(0, L - 1)]
    C.copy_(torch.where(in_panel[None, :], picked.to(C.dtype), C))
    return C


@dataclasses.dataclass(frozen=True)
class PanelOps:
    """The per-application slice of the streaming contract.

    Hooks (``ctx`` is the application's state object, threaded through):

    * ``core_sketches(ctx) -> (S_C, S_R)``;
    * ``update_c(ctx, C, A_L, sc_a, off[, scores]) -> (ctx, C)`` — the sixth
      argument is passed when ``sketch_panel`` is set;
    * ``sketch_panel(ctx, A_L, off) -> (ctx, sc_a, scores)`` — replaces the
      engine's own ``S_C.apply(A_L)`` so scores come out of the same pass;
    * ``r_block(ctx, A_L, off) -> (r, L)`` block written at ``R[:, off:off+L]``,
      or ``update_r(ctx, R, A_L, off) -> R`` for full control (exactly one);
    * Route A: ``chunk_fold(ctx, C, R, block, bcol0, start, width) -> (ctx, C, R)``,
      ``fused_step(ctx, C, block, bcol, sc_a, off) -> (ctx, C, scores)`` and
      the gate ``supports_fused(ctx) -> bool``;
    * Route B: ``panel_kernel(ctx, C, M, A_L, off) -> None | (ctx, C, M, sc_a,
      scores)`` — ``None`` declines and the standard body runs.
    """

    name: str
    core_sketches: Callable[[Any], tuple]
    update_c: Callable[..., tuple]
    sketch_panel: Optional[Callable] = None
    r_block: Optional[Callable] = None
    update_r: Optional[Callable] = None
    chunk_fold: Optional[Callable] = None
    fused_step: Optional[Callable] = None
    supports_fused: Optional[Callable] = None
    panel_kernel: Optional[Callable] = None

    def __post_init__(self):
        if (self.r_block is None) == (self.update_r is None):
            raise ValueError(f"PanelOps {self.name!r} needs exactly one of r_block / update_r")


@dataclasses.dataclass
class PanelState:
    """Streaming accumulators plus the application context.

    ``R`` is allocated at the padded width ``ceil(n/panel)·panel`` when a
    panel width is given at init; ``n`` is the true column count.
    ``offset`` (a host integer) counts the columns consumed. ``quarantined``
    is ``None`` or a 0-dim int32 counter that arms the non-finite panel
    guard (:func:`with_quarantine`). Unknown attributes resolve on ``ctx``.
    """

    C: torch.Tensor
    R: torch.Tensor
    M: torch.Tensor
    offset: int
    ctx: Any
    ops: PanelOps
    n: int
    quarantined: Optional[torch.Tensor] = None

    def __getattr__(self, name):
        ctx = object.__getattribute__(self, "ctx")
        try:
            return getattr(ctx, name)
        except AttributeError:
            raise AttributeError(
                f"{type(self).__name__} has no attribute {name!r} (nor does its ctx)"
            ) from None


def with_quarantine(state: PanelState) -> PanelState:
    """Arm the non-finite panel guard: from then on a panel carrying NaN/Inf
    is zero-scaled (it contributes exactly what an all-zero panel would) and
    counted in ``state.quarantined``. Idempotent."""
    if state.quarantined is None:
        state.quarantined = torch.zeros((), dtype=torch.int32, device=state.M.device)
    return state


def padded_n(n: int, panel: int) -> int:
    """Column count rounded up to a whole number of panels."""
    return ((n + panel - 1) // panel) * panel


def panel_update(state: PanelState, A_L: torch.Tensor) -> PanelState:
    """Consume one L-column panel at ``state.offset`` (accumulators in place)."""
    L = A_L.shape[1]
    off = state.offset
    ops = state.ops
    if state.quarantined is not None:
        bad = ~torch.all(torch.isfinite(A_L))
        A_L = torch.where(bad, torch.zeros((), dtype=A_L.dtype, device=A_L.device), A_L)
        state.quarantined.add_(bad.to(torch.int32))

    fast = None
    if ops.panel_kernel is not None:
        fast = ops.panel_kernel(state.ctx, state.C, state.M, A_L, off)
    if fast is not None:
        ctx, C, M, _sc_a, _scores = fast
    else:
        S_C, S_R = ops.core_sketches(state.ctx)
        if ops.sketch_panel is not None:
            ctx, sc_a, scores = ops.sketch_panel(state.ctx, A_L, off)
        else:
            ctx, sc_a, scores = state.ctx, S_C.apply(A_L), None
        M = state.M
        M.add_(S_R.cols(off, L).apply_t(sc_a).to(M.dtype))
        if scores is None:
            ctx, C = ops.update_c(ctx, state.C, A_L, sc_a, off)
        else:
            ctx, C = ops.update_c(ctx, state.C, A_L, sc_a, off, scores)
    if ops.update_r is not None:
        R = ops.update_r(ctx, state.R, A_L, off)
    else:
        R = state.R
        R[:, off : off + L] = ops.r_block(ctx, A_L, off).to(R.dtype)
    state.C, state.R, state.M, state.ctx = C, R, M, ctx
    state.offset = off + L
    return state


def _fused_route_ok(state: PanelState) -> bool:
    """May this state take Route A? The ops opted in (``chunk_fold``), the
    quarantine guard is off (it is per panel by nature), and the ops' own
    ``supports_fused`` accepts the ctx."""
    ops = state.ops
    return (
        ops.chunk_fold is not None
        and state.quarantined is None
        and (ops.supports_fused is None or ops.supports_fused(state.ctx))
    )


def _fused_scan(state: PanelState, block, bcol0: int, window, num_panels: int,
                panel: int) -> PanelState:
    """Route A: the chunk sketch ``sca = S_C.apply(window)`` once (each
    column's sketch depends on that column alone, so these are the per-panel
    sketches side by side), the panel-invariant factor writes once through
    ``chunk_fold``, then per panel only the ``M`` fold — kept per panel so
    its summation order matches the per-panel body — and ``fused_step``.
    ``window`` is columns ``[bcol0, bcol0 + num_panels·panel)`` of ``block``."""
    ops = state.ops
    start = state.offset
    S_C, S_R = ops.core_sketches(state.ctx)
    sca = S_C.apply(window)
    ctx, C, R = ops.chunk_fold(state.ctx, state.C, state.R, block, bcol0, start,
                               num_panels * panel)
    M = state.M
    for t in range(num_panels):
        off = start + t * panel
        sc_a = sca[:, t * panel : (t + 1) * panel]
        M.add_(S_R.cols(off, panel).apply_t(sc_a).to(M.dtype))
        if ops.fused_step is not None:
            ctx, C, _ = ops.fused_step(ctx, C, block, bcol0 + t * panel, sc_a, off)
    state.C, state.R, state.M, state.ctx = C, R, M, ctx
    state.offset = start + num_panels * panel
    return state


def stream_panels(state: PanelState, A: torch.Tensor, panel: int, *,
                  stop: Optional[int] = None, route: str = "chunk") -> PanelState:
    """Drive columns ``[offset, stop)`` of ``A`` through the engine in
    ``panel``-wide panels, zero-padding the ragged tail (see the module
    docstring for ``route``). The accumulators are updated in place."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if A.device != state.M.device:
        raise ValueError(f"A is on {A.device} but the state lives on {state.M.device}")
    n = A.shape[1]
    start = state.offset
    stop = min(n, state.n) if stop is None else stop
    if state.R.shape[1] < padded_n(stop - start, panel) + start:
        raise ValueError(
            f"state was initialised without room for panel={panel} tail padding "
            f"(R width {state.R.shape[1]}, need {start + padded_n(stop - start, panel)}); "
            "pass `panel=` at init"
        )
    if stop <= start:
        return state
    width = stop - start
    num_panels = padded_n(width, panel) // panel
    label = f"stream/{state.ops.name}/{'scan' if route == 'chunk' else 'per-panel'}"
    if route == "chunk" and _fused_route_ok(state):
        with record_function(label):
            if width == num_panels * panel:
                return _fused_scan(state, A, start, A[:, start:stop], num_panels, panel)
            chunk = A.new_zeros((A.shape[0], num_panels * panel))
            chunk[:, :width] = A[:, start:stop]
            return _fused_scan(state, chunk, 0, chunk, num_panels, panel)
    with record_function(label):
        for off in range(start, stop, panel):
            w = min(panel, stop - off)
            A_L = A[:, off : off + w]
            if w != panel:
                A_L = torch.nn.functional.pad(A_L, (0, panel - w))
            state = panel_update(state, A_L)
    return state


def truncated_R(state: PanelState) -> torch.Tensor:
    """``R`` restricted to the true (unpadded) column range."""
    return state.R[:, : state.n]
