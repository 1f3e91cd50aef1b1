"""Single-pass streaming CUR with fixed index sets (counterpart of ``repro/cur/streaming.py``).

Per panel of the :mod:`repro_torch.stream.engine` stream: the panel's
selected columns land in their ``C`` slots, ``R[:, cols] = A_L[row_idx, :]``,
and ``M += (S_C A_L)·S_R[:, cols]ᵀ``. :func:`streaming_cur_finalize` then
solves the Fast-GMR core ``U = (S_C C)† M (R S_Rᵀ)†``. On the chunk route
the fixed-index copies are folded once per chunk (:func:`_cur_chunk_fold`).
``telemetry=True`` streams with :data:`STREAMING_CUR_TEL_OPS` and a
diagnostics frame (:mod:`repro_torch.obs`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.gmr import fast_gmr_core
from ..core.sketching import draw_sketch
from ..device import DeviceLike, resolve_device
from ..obs.telemetry import check_telemetry, fixed_stream_telemetry, init_telemetry
from ..stream.engine import (
    PanelOps,
    PanelState,
    copy_selected_columns,
    padded_n,
    panel_update,
    truncated_R,
)
from .cur import CURResult, cur_sketch_sizes

__all__ = [
    "StreamingCURState",
    "CURStreamCtx",
    "STREAMING_CUR_OPS",
    "STREAMING_CUR_TEL_OPS",
    "streaming_cur_init",
    "streaming_cur_update",
    "streaming_cur_finalize",
]


@dataclasses.dataclass
class CURStreamCtx:
    """Fixed selection indices + the shared core sketching operators."""

    col_idx: torch.Tensor  # (c,) int32
    row_idx: torch.Tensor  # (r,) int32
    S_C: object  # column-sliceable sketch, (s_c, m)
    S_R: object  # column-sliceable sketch, (s_r, n_pad)


def _cur_core_sketches(ctx: CURStreamCtx):
    return ctx.S_C, ctx.S_R


def _cur_update_c(ctx: CURStreamCtx, C, A_L, sc_a, off):
    return ctx, copy_selected_columns(ctx.col_idx, C, A_L, off)


def _cur_r_block(ctx: CURStreamCtx, A_L, off):
    return A_L[ctx.row_idx.long()]


def _cur_chunk_fold(ctx: CURStreamCtx, C, R, block, bcol0, start, width):
    """Route-A hook: the whole chunk's C/R writes in one pass — the selected
    columns inside ``[start, start+width)`` gathered into their C slots and
    the selected rows' stripe written into ``R``; bitwise the values the
    per-panel body copies."""
    rel = ctx.col_idx.long() - start
    in_chunk = (rel >= 0) & (rel < width)
    picked = block[:, bcol0 + rel.clamp(0, width - 1)]
    C.copy_(torch.where(in_chunk[None, :], picked.to(C.dtype), C))
    R[:, start : start + width] = block[ctx.row_idx.long(), bcol0 : bcol0 + width].to(R.dtype)
    return ctx, C, R


STREAMING_CUR_OPS = PanelOps(
    name="streaming_cur",
    core_sketches=_cur_core_sketches,
    update_c=_cur_update_c,
    r_block=_cur_r_block,
    chunk_fold=_cur_chunk_fold,
)

# the same hooks plus the fixed-index diagnostics fold (repro_torch.obs)
STREAMING_CUR_TEL_OPS = dataclasses.replace(STREAMING_CUR_OPS, telemetry=fixed_stream_telemetry)

StreamingCURState = PanelState


def streaming_cur_init(
    gen: Optional[torch.Generator],
    m: int,
    n: int,
    col_idx,
    row_idx,
    *,
    s_c: Optional[int] = None,
    s_r: Optional[int] = None,
    eps: float = 0.05,
    rho_est: float = 2.0,
    sketch: str = "countsketch",
    osnap_p: int = 2,
    dtype=torch.float32,
    sketches=None,
    panel: Optional[int] = None,
    telemetry: bool = False,
    tel_omega=None,
    device: DeviceLike = None,
) -> StreamingCURState:
    """Allocate zero accumulators and draw (or take) the core sketches.

    Args:
        gen: generator for the core sketches, on ``device`` (unused when
            ``sketches`` is given).
        m, n: stream shape — ``A`` is (m, n), arriving as column panels.
        col_idx, row_idx: fixed pre-pass selections, (c,) / (r,).
        s_c, s_r: core sketch sizes; default to the Table-2 ``cur_sketch_sizes``.
        eps, rho_est: Table-2 sketch-size parameters.
        sketch: ``countsketch`` / ``osnap`` / ``gaussian``.
        osnap_p: nonzeros per column for OSNAP.
        dtype: accumulator dtype.
        sketches: pre-drawn ``(S_C, S_R)`` pair (shared randomness).
        panel: fixed streaming width — pads ``R``/``S_R`` to whole panels.
        telemetry: attach a diagnostics frame and the error estimator's test
            sketch (:mod:`repro_torch.obs`); needs ``panel=``. Factors are the
            same bits with it on or off.
        tel_omega: the test sketch Ω_test (n × q, e.g. the reference's
            draw); by default drawn from ``gen`` after the core sketches.
        device: where the state lives; ``None`` means CUDA (raises without it).
    """
    dev = resolve_device(device)
    check_telemetry(telemetry, panel)
    col_idx = torch.as_tensor(col_idx).to(device=dev, dtype=torch.int32).clone()
    row_idx = torch.as_tensor(row_idx).to(device=dev, dtype=torch.int32).clone()
    c, r = col_idx.shape[0], row_idx.shape[0]
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
    n_pad = padded_n(n, panel) if panel else n
    ctx = CURStreamCtx(col_idx=col_idx, row_idx=row_idx, S_C=S_C, S_R=S_R.pad_cols(n_pad))
    tel = init_telemetry(gen, m, n, panel, omega=tel_omega, device=dev) if telemetry else None
    return StreamingCURState(
        C=torch.zeros((m, c), dtype=dtype, device=dev),
        R=torch.zeros((r, n_pad), dtype=dtype, device=dev),
        M=torch.zeros((s_c, s_r), dtype=dtype, device=dev),
        offset=0,
        ctx=ctx,
        ops=STREAMING_CUR_TEL_OPS if telemetry else STREAMING_CUR_OPS,
        n=n,
        tel=tel,
    )


def streaming_cur_update(state: StreamingCURState, A_L: torch.Tensor) -> StreamingCURState:
    """Consume one (m, L) column panel at the state's offset."""
    return panel_update(state, A_L)


def streaming_cur_finalize(state: StreamingCURState) -> CURResult:
    """Fast-GMR core solve ``U = (S_C C)† M (R S_Rᵀ)†`` on the streamed pieces."""
    ctx = state.ctx
    R = truncated_R(state)
    ScC = ctx.S_C.apply(state.C)
    RSr = ctx.S_R.apply_t(R)
    U = fast_gmr_core(ScC, state.M, RSr)
    return CURResult(C=state.C, U=U, R=R, col_idx=ctx.col_idx, row_idx=ctx.row_idx)
