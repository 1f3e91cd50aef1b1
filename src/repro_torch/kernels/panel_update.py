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
from .panel_score import split_plan


def panel_update_kernel(sc, a_l, srt, q, C, M, scal_f, scal_i, *, panel_cap: int,
                        sc_a, resid2, energy, slots) -> None:
    """Launch the fixed sequence of stages on the current stream."""
    s_c, m = sc.shape
    L = a_l.shape[1]
    s_r = srt.shape[1]
    nsplit, kchunk = split_plan(s_c, L, m, sc.device)
    partial = torch.empty(nsplit * s_c * L, dtype=torch.float32, device=sc.device)
    fn = launcher("panel_update")
    rc = fn(
        DTYPE_CODE[sc.dtype], sc.data_ptr(), sc.stride(0), a_l.data_ptr(), a_l.stride(0),
        srt.data_ptr(), srt.stride(0), srt.stride(1), q.data_ptr(), q.stride(0), q.shape[1],
        C.data_ptr(), C.stride(0), C.shape[1], M.data_ptr(), M.stride(0),
        scal_f.data_ptr(), scal_i.data_ptr(), panel_cap, partial.data_ptr(), nsplit, kchunk,
        sc_a.data_ptr(), resid2.data_ptr(), energy.data_ptr(), slots.data_ptr(),
        s_c, m, L, s_r, torch.cuda.current_stream(sc.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"panel_update kernel launch failed: cudaError {rc}")
