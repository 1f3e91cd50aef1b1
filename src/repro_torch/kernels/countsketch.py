"""Kernel 1: CountSketch ``S·A`` (``csrc/countsketch.cu``).

Counterpart of ``repro/kernels/countsketch.py``. The kernel gathers each
bucket's rows in ascending row order; :func:`bucket_order` builds that order
once per sketch (or sketch window) with a stable sort in plain torch. Call
through :func:`repro_torch.kernels.ops.countsketch_apply`, which checks the
arguments and counts launches.
"""

from __future__ import annotations

import torch

from .build import launcher

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def bucket_order(hashes: torch.Tensor, s: int) -> tuple:
    """``(perm, start)``: row ids grouped by bucket, ascending within each
    bucket, and the (s+1,) bucket offsets into ``perm`` (int32 both)."""
    perm = torch.sort(hashes, stable=True).indices.to(torch.int32)
    counts = torch.bincount(hashes.long(), minlength=s)
    start = torch.zeros(s + 1, dtype=torch.int32, device=hashes.device)
    start[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return perm, start


def countsketch_kernel(perm, start, signs, a, out, *, out_strides, s: int) -> None:
    """Launch on the current stream: ``out[b, j] = Σ_{h[i]=b} signs[i]·a[i, j]``,
    with ``out``'s element (b, j) at ``b·out_strides[0] + j·out_strides[1]``."""
    fn = launcher("countsketch")
    rc = fn(
        DTYPE_CODE[a.dtype], perm.data_ptr(), start.data_ptr(), signs.data_ptr(),
        a.data_ptr(), a.stride(0), a.stride(1), out.data_ptr(),
        out_strides[0], out_strides[1], s, a.shape[1],
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"countsketch kernel launch failed: cudaError {rc}")
