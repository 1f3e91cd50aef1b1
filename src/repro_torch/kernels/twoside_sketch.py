"""Kernel 4: two-sided sketch ``M_b = S_C·A_b·S_Rᵀ`` over a batch (``csrc/twoside_sketch.cu``).

Counterpart of ``repro/kernels/twoside_sketch.py``. Call through
:func:`repro_torch.kernels.ops.twoside_sketch`, which checks the arguments,
allocates the output and counts launches.
"""

from __future__ import annotations

import torch

from .build import launcher
from .countsketch import DTYPE_CODE


def twoside_sketch_kernel(sc, a, srt, out) -> None:
    """Launch both stages on the current stream: ``out[b] = sc·a[b]·srt``.

    ``a`` is (B, m, n); the (B, s_c, n) fp32 intermediate ``S_C·A_b`` is
    scratch allocated here.
    """
    B, m, n = a.shape
    s_c, s_r = sc.shape[0], srt.shape[1]
    t = torch.empty((B, s_c, n), dtype=torch.float32, device=a.device)
    fn = launcher("twoside_sketch")
    rc = fn(
        DTYPE_CODE[a.dtype], sc.data_ptr(), sc.stride(0), sc.stride(1),
        a.data_ptr(), a.stride(0), a.stride(1), a.stride(2),
        srt.data_ptr(), srt.stride(0), srt.stride(1), t.data_ptr(), out.data_ptr(),
        B, s_c, m, n, s_r, torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"twoside_sketch kernel launch failed: cudaError {rc}")
