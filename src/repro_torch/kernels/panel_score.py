"""Kernel 2: fused panel scoring ``(S_C·A_L, resid2, energy)`` (``csrc/panel_score.cu``).

Counterpart of ``repro/kernels/panel_score.py``. Call through
:func:`repro_torch.kernels.ops.panel_score`, which checks the arguments,
allocates the outputs and the split-K scratch, and counts launches.
"""

from __future__ import annotations

import functools
import math

import torch

from .build import launcher
from .countsketch import DTYPE_CODE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


TILE = 128  # the block tile of csrc/common.cuh (BM = BN)
K_STEP = 8  # its k-slab (BK)


def split_plan(s_c: int, L: int, m: int, device: torch.device) -> tuple:
    """``(nsplit, kchunk)`` for the split-K sketch product: about two blocks
    per SM (the product kernel's occupancy), each split a whole number of
    k-slabs. Depends only on the shapes and the card, so the summation order
    is fixed."""
    tiles = math.ceil(s_c / TILE) * math.ceil(L / TILE)
    sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
    nsplit = max(1, min(math.ceil(2 * sms / tiles), math.ceil(m / 256)))
    kchunk = math.ceil(math.ceil(m / nsplit) / K_STEP) * K_STEP
    return math.ceil(m / kchunk), kchunk


def panel_score_kernel(sc, a_l, q, sc_a, resid2, energy) -> None:
    """Launch both stages on the current stream into the given outputs."""
    s_c, m = sc.shape
    L = a_l.shape[1]
    nsplit, kchunk = split_plan(s_c, L, m, sc.device)
    partial = torch.empty(nsplit * s_c * L, dtype=torch.float32, device=sc.device)
    fn = launcher("panel_score")
    rc = fn(
        DTYPE_CODE[sc.dtype], sc.data_ptr(), sc.stride(0), a_l.data_ptr(), a_l.stride(0),
        q.data_ptr(), q.stride(0), q.shape[1], partial.data_ptr(), nsplit, kchunk,
        sc_a.data_ptr(), resid2.data_ptr(), energy.data_ptr(), s_c, m, L,
        torch.cuda.current_stream(sc.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"panel_score kernel launch failed: cudaError {rc}")
