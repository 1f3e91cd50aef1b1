"""Kernel 4: two-sided sketch ``M_b = S_C·A_b·S_Rᵀ`` over a batch (``csrc/twoside_sketch.cu``).

Counterpart of ``repro/kernels/twoside_sketch.py``. Call through
:func:`repro_torch.kernels.ops.twoside_sketch`, which checks the arguments,
allocates the output and counts launches. Both products run on the mainloop
of ``csrc/sgemm_sm90.cuh`` with the batch a grid axis: :func:`twoside_plans`
gives their launch plans (whole tiles for every full wave, the last wave
split stream-K).
"""

from __future__ import annotations

import torch

from .build import launcher
from .countsketch import DTYPE_CODE
from .panel_score import BM, PANEL_BN, blocks_per_sm, device_index, sm_count, split_plan


def twoside_plans(batch: int, s_c: int, m: int, n: int, s_r: int, n_sm: int, bps: tuple) -> tuple:
    """The plans of ``T_b = S_C·A_b`` ((s_c × m)·(m × n)) and ``T_b·S_Rᵀ``
    ((s_c × n)·(n × s_r)) over the batch, with ``bps`` the resident blocks
    per SM of each product."""
    return (split_plan(s_c, n, m, n_sm, bps[0], batch=batch, whole_waves=True),
            split_plan(s_c, s_r, n, n_sm, bps[1], batch=batch, whole_waves=True))


def twoside_sketch_kernel(sc, a, srt, out) -> None:
    """Launch both products on the current stream: ``out[b] = sc·a[b]·srt``.

    ``sc`` and each item of ``a`` (B, m, n) have contiguous rows; ``srt``
    is copied to contiguous rows when it is a transposed view. The (B, s_c,
    n) fp32 intermediate ``S_C·A_b`` and the split tiles' pieces are
    scratch allocated here.
    """
    B, m, n = a.shape
    s_c, s_r = sc.shape[0], srt.shape[1]
    if srt.stride(1) != 1:  # the products read B along its rows
        srt = srt.contiguous()
    code = DTYPE_CODE[a.dtype]
    bps = (blocks_per_sm("twoside_sketch", 0, code), blocks_per_sm("twoside_sketch", 1, code))
    p1, p2 = twoside_plans(B, s_c, m, n, s_r, sm_count(device_index(a)), bps)
    t = torch.empty((B, s_c, n), dtype=torch.float32, device=a.device)
    partial = torch.empty(max(p1.partial_slots, p2.partial_slots, 1) * BM * PANEL_BN,
                          dtype=torch.float32, device=a.device)
    rc = launcher("twoside_sketch")(
        code, sc.data_ptr(), sc.stride(0), a.data_ptr(), a.stride(1), a.stride(0),
        srt.data_ptr(), srt.stride(0), t.data_ptr(), partial.data_ptr(), out.data_ptr(),
        B, s_c, m, n, s_r, p1.nblocks, p1.whole, p2.nblocks, p2.whole,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"twoside_sketch kernel launch failed: cudaError {rc}")
