"""Panel-streaming engine: C/R/M accumulators over L-column panels.

Counterpart of ``repro/stream/engine.py``. ``A`` arrives as L-column panels
``A_L`` that are never kept; per panel the engine folds

* ``C`` (m × c)  — the column factor, through the application's ``update_c``;
* ``R`` (r × n)  — the row factor, block by block at the panel's offset;
* ``M`` (s_c × s_r) — ``M += (S_C A_L) · S_R[:, cols]ᵀ`` via ``cols()``
  (:func:`~repro_torch.core.sketching.fold_apply_t`).

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

**Symmetric (tied-operand) streams** (``PanelOps(symmetric=True)``): for a
square stream whose row factor is tied to the column factor (SPSD / kernel
matrices, ``R = Cᵀ``) the engine skips the R half of every panel, the
state's ``R`` is a ``(0, n_pad)`` placeholder, and :func:`truncated_R`
derives ``Cᵀ``.

**Telemetry** (:mod:`repro_torch.obs`): a state with a frame in
``state.tel`` and ops with a ``telemetry`` hook folds each panel's
diagnostics after its updates, and :func:`stream_panels` folds the
estimator's ``Ψ += A_window·Ω_test`` once over the consumed window before
the route is chosen. With ``tel=None`` the engine runs exactly what it
runs without telemetry. **Sharding** (:mod:`repro_torch.stream.distributed`)
runs workers on :func:`fresh_state` copies through the ``prep_shard``,
``bind_shard``, ``merge_ctx`` (or, across processes, ``collective_ctx``)
and ``merge_state`` hooks.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import torch

from ..core.sketching import (ComposedSketch, CountSketch, GaussianSketch, OSNAPSketch,
                              RowSampling, SRHTSketch, fold_apply_t, index_windows)
from ..obs.spans import span
from ..obs.telemetry import EVENT_QUARANTINED, fold_psi_chunk

__all__ = [
    "PanelOps",
    "PanelState",
    "panel_update",
    "stream_panels",
    "padded_n",
    "copy_selected_columns",
    "truncated_R",
    "with_quarantine",
    "zero_nonfinite_panels",
    "fresh_state",
]

# sketch objects are read-only (bar their order caches): worker copies share them
_SKETCHES = (GaussianSketch, SRHTSketch, CountSketch, OSNAPSketch, RowSampling, ComposedSketch)

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
      scores)`` — ``None`` declines and the standard body runs;
    * ``window_sketches(ctx) -> tuple`` — sketches other than ``S_R`` that
      the hooks read in panel windows; the engine indexes their windows
      (and the view kernel's chunks of them) once per stream, as ``S_R``'s;
    * ``telemetry(tel, ctx_pre, ctx_post, A_L, sc_a, scores, off) -> tel`` —
      runs last, only for a state with a frame, and writes only the frame.
      It reads ``A_L``'s width, never its values: Route A passes a
      ``(0, panel)`` placeholder, or, for ops without ``fused_step`` (no
      per-panel ctx update), one ``(0, chunk width)`` placeholder with the
      whole chunk sketch;
    * sharding: ``prep_shard(ctx, W) -> ctx`` once per run,
      ``bind_shard(ctx, w) -> ctx`` per worker, ``merge_ctx(ctxs) -> ctx``
      and ``merge_state(state) -> state`` after the accumulators are summed;
      ``collective_ctx(ctx, group) -> ctx`` is ``merge_ctx`` as collectives
      over a ``torch.distributed`` group, run by every rank of
      :func:`~repro_torch.stream.distributed.mesh_sharded_stream` once per
      call, never per panel;
    * ``symmetric`` — a tied-operand stream: no R hook, ``R = Cᵀ``.
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
    window_sketches: Optional[Callable] = None
    telemetry: Optional[Callable] = None
    prep_shard: Optional[Callable] = None
    bind_shard: Optional[Callable] = None
    merge_ctx: Optional[Callable] = None
    collective_ctx: Optional[Callable] = None
    merge_state: Optional[Callable] = None
    symmetric: bool = False

    def __post_init__(self):
        if self.symmetric:
            if self.r_block is not None or self.update_r is not None:
                raise ValueError(
                    f"PanelOps {self.name!r} is symmetric (R = Cᵀ is derived); "
                    "it must not declare r_block / update_r"
                )
        elif (self.r_block is None) == (self.update_r is None):
            raise ValueError(f"PanelOps {self.name!r} needs exactly one of r_block / update_r")


@dataclasses.dataclass
class PanelState:
    """Streaming accumulators plus the application context.

    ``R`` is allocated at the padded width ``ceil(n/panel)·panel`` when a
    panel width is given at init; ``n`` is the true column count.
    ``offset`` (a host integer) counts the columns consumed. ``tel`` is
    ``None`` or the diagnostics frame (:class:`~repro_torch.obs.telemetry.TelemetryFrame`).
    ``quarantined`` is ``None`` or a 0-dim int32 counter that arms the
    non-finite panel guard (:func:`with_quarantine`). Unknown attributes
    resolve on ``ctx``.
    """

    C: torch.Tensor
    R: torch.Tensor
    M: torch.Tensor
    offset: int
    ctx: Any
    ops: PanelOps
    n: int
    tel: Any = None
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
    is zero-scaled (it contributes exactly what an all-zero panel would),
    counted in ``state.quarantined`` and, with telemetry, flagged
    ``EVENT_QUARANTINED`` in its frame slot. Idempotent."""
    if state.quarantined is None:
        state.quarantined = torch.zeros((), dtype=torch.int32, device=state.M.device)
    return state


def padded_n(n: int, panel: int) -> int:
    """Column count rounded up to a whole number of panels."""
    return ((n + panel - 1) // panel) * panel


def zero_nonfinite_panels(block: torch.Tensor, panel: int) -> torch.Tensor:
    """``block`` with every ``panel``-wide column group that carries a
    NaN/Inf zeroed (a ragged tail is its own group): the quarantine guard's
    rule at block granularity, applied to the window the ``Ψ`` fold reads
    before the per-panel guard runs, so a quarantined panel adds nothing
    to ``Ψ`` either. ``block`` starts on a panel boundary."""
    m, w = block.shape
    P = padded_n(w, panel) // panel
    padded = torch.nn.functional.pad(block, (0, P * panel - w))
    fin = torch.all(torch.isfinite(padded.reshape(m, P, panel)), dim=2).all(dim=0)
    mask = fin.repeat_interleave(panel)[:w]
    return torch.where(mask[None, :], block, torch.zeros((), dtype=block.dtype, device=block.device))


def _fresh(x):
    """A copy of ``x`` whose tensors a stream may update without touching
    ``x``'s: tensors cloned, sketches shared, dataclasses copied field by
    field (but for the read-only fields a class lists in ``FRESH_SHARED``)."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, _SKETCHES) or not dataclasses.is_dataclass(x) or isinstance(x, type):
        return x
    shared = getattr(x, "FRESH_SHARED", ())
    return dataclasses.replace(x, **{
        f.name: getattr(x, f.name) if f.name in shared else _fresh(getattr(x, f.name))
        for f in dataclasses.fields(x) if f.init})


def fresh_state(state: PanelState) -> PanelState:
    """A copy of ``state`` that streams independently of it: the
    accumulators (C, R, M), every ctx tensor, the telemetry frame and the
    quarantine counter cloned; the sketches shared. The port's counterpart
    of the reference's ``fresh_pytree`` (the engine updates in place)."""
    return dataclasses.replace(
        state, C=state.C.clone(), R=state.R.clone(), M=state.M.clone(),
        ctx=_fresh(state.ctx), tel=_fresh(state.tel), quarantined=_fresh(state.quarantined))


def _snapshot(ctx):
    """The ctx as it stands, for a telemetry hook to compare with after the
    panel: the hooks rebind the counters they change, so a shallow copy
    (of nested state too) keeps the old ones."""
    if not dataclasses.is_dataclass(ctx) or isinstance(ctx, _SKETCHES):
        return ctx
    snap = copy.copy(ctx)
    for f in dataclasses.fields(ctx):
        v = getattr(ctx, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, _SKETCHES):
            object.__setattr__(snap, f.name, copy.copy(v))
    return snap


def panel_update(state: PanelState, A_L: torch.Tensor) -> PanelState:
    """Consume one L-column panel at ``state.offset`` (accumulators in place)."""
    L = A_L.shape[1]
    off = state.offset
    ops = state.ops
    bad = None
    if state.quarantined is not None:
        bad = ~torch.all(torch.isfinite(A_L))
        A_L = torch.where(bad, torch.zeros((), dtype=A_L.dtype, device=A_L.device), A_L)
        state.quarantined.add_(bad.to(torch.int32))
    tel = state.tel
    has_tel = ops.telemetry is not None and tel is not None
    ctx_pre = _snapshot(state.ctx) if has_tel else None

    fast = None
    if ops.panel_kernel is not None:
        fast = ops.panel_kernel(state.ctx, state.C, state.M, A_L, off)
    if fast is not None:
        ctx, C, M, sc_a, scores = fast
    else:
        S_C, S_R = ops.core_sketches(state.ctx)
        if ops.sketch_panel is not None:
            ctx, sc_a, scores = ops.sketch_panel(state.ctx, A_L, off)
        else:
            ctx, sc_a, scores = state.ctx, S_C.apply(A_L), None
        M = fold_apply_t(S_R.cols(off, L), sc_a, state.M)
        if scores is None:
            ctx, C = ops.update_c(ctx, state.C, A_L, sc_a, off)
        else:
            ctx, C = ops.update_c(ctx, state.C, A_L, sc_a, off, scores)
    if ops.symmetric:
        R = state.R  # tied operand: R = Cᵀ is derived, nothing to accumulate
    elif ops.update_r is not None:
        R = ops.update_r(ctx, state.R, A_L, off)
    else:
        R = state.R
        R[:, off : off + L] = ops.r_block(ctx, A_L, off).to(R.dtype)
    # the telemetry fold runs last: it reads the panel's outcome, writes the frame only
    if has_tel:
        tel = ops.telemetry(tel, ctx_pre, ctx, A_L, sc_a, scores, off)
    if bad is not None and tel is not None:
        t = off // tel.panel
        tel.events[t : t + 1].add_(bad.to(torch.int32).reshape(1) * EVENT_QUARANTINED)
    state.C, state.R, state.M, state.ctx, state.tel = C, R, M, ctx, tel
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
    ``window`` is columns ``[bcol0, bcol0 + num_panels·panel)`` of ``block``.
    A telemetry hook runs per panel after ``fused_step``, on a ``(0, panel)``
    placeholder; for ops without ``fused_step`` (nothing in the ctx changes
    per panel) it runs once over the whole chunk sketch."""
    ops = state.ops
    start = state.offset
    width = num_panels * panel
    S_C, S_R = ops.core_sketches(state.ctx)
    sca = S_C.apply(window)
    ctx, C, R = ops.chunk_fold(state.ctx, state.C, state.R, block, bcol0, start, width)
    tel = state.tel
    has_tel = ops.telemetry is not None and tel is not None
    tel_per_panel = has_tel and ops.fused_step is not None
    placeholder = block.new_zeros((0, panel)) if tel_per_panel else None
    M = state.M
    for t in range(num_panels):
        off = start + t * panel
        sc_a = sca[:, t * panel : (t + 1) * panel]
        fold_apply_t(S_R.cols(off, panel), sc_a, M)
        if ops.fused_step is not None:
            ctx_pre = _snapshot(ctx) if tel_per_panel else None
            ctx, C, scores = ops.fused_step(ctx, C, block, bcol0 + t * panel, sc_a, off)
            if tel_per_panel:
                tel = ops.telemetry(tel, ctx_pre, ctx, placeholder, sc_a, scores, off)
    if has_tel and not tel_per_panel:
        tel = ops.telemetry(tel, ctx, ctx, block.new_zeros((0, width)), sca, None, start)
    state.C, state.R, state.M, state.ctx, state.tel = C, R, M, ctx, tel
    state.offset = start + width
    return state


def stream_panels(state: PanelState, A: torch.Tensor, panel: int, *,
                  stop: Optional[int] = None, route: str = "chunk", col0: int = 0) -> PanelState:
    """Drive columns ``[offset, stop)`` of the stream through the engine in
    ``panel``-wide panels, zero-padding the ragged tail (see the module
    docstring for ``route``). ``A`` holds the stream's columns from ``col0``
    on (the whole stream by default; a chunk or a worker's column block
    starting at ``col0 <= offset`` otherwise), and ``stop`` defaults to the
    end of ``A`` or of the stream, whichever is first. The accumulators are
    updated in place. A telemetered state first folds ``Ψ`` over the whole
    window, once."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if A.device != state.M.device:
        raise ValueError(f"A is on {A.device} but the state lives on {state.M.device}")
    n = col0 + A.shape[1]
    start = state.offset
    if start < col0:
        raise ValueError(f"A starts at column {col0}, after the state's offset {start}")
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
    # the bucket orders of S_R's panel windows, and of every other sketch the
    # hooks window per panel, built once per stream
    index_windows(state.ops.core_sketches(state.ctx)[1], panel)
    if state.ops.window_sketches is not None:
        for S in state.ops.window_sketches(state.ctx):
            index_windows(S, panel, chunks=True)
    label = f"stream/{state.ops.name}/{'scan' if route == 'chunk' else 'per-panel'}"
    lo, hi = start - col0, stop - col0  # the window in A's own columns
    with span(label):
        if state.ops.telemetry is not None and state.tel is not None:
            block = A[:, lo:hi]
            if state.quarantined is not None:  # a quarantined panel adds nothing to Ψ
                block = zero_nonfinite_panels(block, panel)
            fold_psi_chunk(state.tel, block, start)
        if route == "chunk" and _fused_route_ok(state):
            if width == num_panels * panel:
                return _fused_scan(state, A, lo, A[:, lo:hi], num_panels, panel)
            chunk = A.new_zeros((A.shape[0], num_panels * panel))
            chunk[:, :width] = A[:, lo:hi]
            return _fused_scan(state, chunk, 0, chunk, num_panels, panel)
        for off in range(lo, hi, panel):
            w = min(panel, hi - off)
            A_L = A[:, off : off + w]
            if w != panel:
                A_L = torch.nn.functional.pad(A_L, (0, panel - w))
            state = panel_update(state, A_L)
    return state


def truncated_R(state: PanelState) -> torch.Tensor:
    """``R`` restricted to the true (unpadded) column range; for a symmetric
    stream, ``Cᵀ`` (C's rows are never padded)."""
    if state.ops.symmetric:
        return state.C.T
    return state.R[:, : state.n]
