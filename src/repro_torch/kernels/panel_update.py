"""Kernel 3: admission-only panel update (``csrc/panel_update.cu``).

Counterpart of ``repro/kernels/panel_update.py``: scores, admission slots,
``C[:, slot] = A_L[:, j]`` and ``M += sc_a·srt`` for one panel, ``C`` and
``M`` updated in place. Call through :func:`repro_torch.kernels.ops.panel_update`,
which checks the arguments, packs the scalars on the device and counts
launches.
"""

from __future__ import annotations

import torch

from .build import launcher
from .countsketch import DTYPE_CODE
from .panel_score import (BM, FOLD_BN, PANEL_BN, blocks_per_sm, device_index, score_scratch,
                          sm_count, split_plan)


def panel_update_kernel(sc, a_l, srt, q, C, M, scal_f, scal_i, *, panel_cap: int,
                        sc_a, resid2, energy, slots) -> None:
    """Launch the fixed sequence of stages on the current stream. ``srt`` is
    read in place: k-contiguous (a transposed window, strides (1, n)) or
    row-major."""
    s_c, m = sc.shape
    L = a_l.shape[1]
    s_r = srt.shape[1]
    codes = (DTYPE_CODE[sc.dtype], DTYPE_CODE[a_l.dtype], DTYPE_CODE[C.dtype])
    kmajor = int(srt.stride(1) != 1)
    n_sm = sm_count(device_index(sc))
    plan = split_plan(s_c, L, m, n_sm, blocks_per_sm("panel_update", 0, *codes, kmajor))
    fold = split_plan(s_c, s_r, L, n_sm, blocks_per_sm("panel_update", 1, *codes, kmajor),
                      bn=FOLD_BN)
    # the fold's pieces reuse the sketch product's slots once the scores have read them
    partial = torch.empty(max(plan.partial_slots * PANEL_BN, fold.partial_slots * FOLD_BN) * BM,
                          dtype=torch.float32, device=sc.device)
    scratch = score_scratch(s_c, L, q.shape[1], sc.device)
    rc = launcher("panel_update")(
        *codes, kmajor, sc.data_ptr(), sc.stride(0), a_l.data_ptr(), a_l.stride(0),
        srt.data_ptr(), srt.stride(1) if kmajor else srt.stride(0),
        q.data_ptr(), q.stride(0), q.shape[1], C.data_ptr(), C.stride(0), C.shape[1],
        M.data_ptr(), M.stride(0), scal_f.data_ptr(), scal_i.data_ptr(), panel_cap,
        partial.data_ptr(), plan.nblocks, fold.nblocks, scratch.data_ptr(), sc_a.data_ptr(),
        resid2.data_ptr(), energy.data_ptr(), slots.data_ptr(), s_c, m, L, s_r,
        torch.cuda.current_stream(sc.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"panel_update kernel launch failed: cudaError {rc}")
