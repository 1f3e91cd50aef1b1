"""Kernel 2: fused panel scoring ``(S_C·A_L, resid2, energy)`` (``csrc/panel_score.cu``).

Counterpart of ``repro/kernels/panel_score.py``. Call through
:func:`repro_torch.kernels.ops.panel_score`, which checks the arguments,
allocates the outputs and counts launches. The sketch product runs on the
stream-K mainloop of ``csrc/sgemm_sm90.cuh``; :func:`split_plan` is its launch
plan, and kernel 3 shares it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .build import launcher
from .countsketch import DTYPE_CODE

# the mainloop's tile (csrc/sgemm_sm90.cuh): BM rows, BK-deep k-slabs; the
# sketch product's tiles are PANEL_BN wide, the M fold's FOLD_BN. A copy of
# the kernels' own, which size the buffers allocated here: each library is
# checked against it before its first launch (`check_geometry`).
BM, BK = 128, 16
PANEL_BN, FOLD_BN = 256, 128


class SplitPlan(NamedTuple):
    """Launch plan of a tiled product ``(rows × k)·(k × cols)``, per item of
    a batch. The tiles of every item, ordered item by item and tile by tile,
    are ``tiles``; the first ``whole`` go one per block per wave (tile ``t``
    to block ``t % nblocks``), and the split tiles after them × their
    k-slabs are ``units``, taken stream-K: block ``b`` of ``nblocks`` takes
    units ``[b·units // nblocks, (b+1)·units // nblocks)``, and the pieces
    of split tile ``t`` (counted from ``whole``) are summed in block order
    from partial slots ``b + t``."""

    tiles: int
    ntn: int  # column tiles of an item
    slabs: int  # k-slabs per tile
    units: int
    nblocks: int
    whole: int = 0

    def begin(self, b: int) -> int:
        return b * self.units // self.nblocks

    def block_of(self, u: int) -> int:
        """The block whose range holds unit ``u``."""
        return ((u + 1) * self.nblocks - 1) // self.units

    def tile_blocks(self, t: int) -> range:
        """The blocks holding pieces of split tile ``t``, in summation order."""
        return range(self.block_of(t * self.slabs), self.block_of((t + 1) * self.slabs - 1) + 1)

    @property
    def partial_slots(self) -> int:
        split = self.tiles - self.whole
        return self.nblocks + split - 1 if split else 0


def split_plan(rows: int, cols: int, k: int, n_sm: int, blocks_per_sm: int, *,
               bn: int = PANEL_BN, batch: int = 1, whole_waves: bool = False) -> SplitPlan:
    """The launch plan of the product ``(rows × k)·(k × cols)`` over
    ``batch`` items on a card with ``n_sm`` SMs that keeps ``blocks_per_sm``
    of the product's blocks resident: one block per resident slot (one
    whole wave at a time) unless there are fewer k-slabs to split than
    slots, each block a run of whole k-slabs. With ``whole_waves`` every
    full wave of tiles goes whole and only the last, partial wave is split.
    A pure function of the shapes and the card, so the summation order is
    fixed."""
    if min(rows, cols, k, n_sm, blocks_per_sm, batch) < 1:
        raise ValueError(f"empty product or card: {rows}, {cols}, {k}, {n_sm}, {blocks_per_sm}, "
                         f"{batch}")
    slots = n_sm * blocks_per_sm
    ntn = math.ceil(cols / bn)
    tiles = batch * math.ceil(rows / BM) * ntn
    slabs = math.ceil(k / BK)
    whole = tiles // slots * slots if whole_waves else 0
    units = (tiles - whole) * slabs
    return SplitPlan(tiles, ntn, slabs, units, slots if whole else min(slots, units), whole)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def check_geometry(lib: str) -> None:
    """Raise unless the built library's tile geometry (``<lib>_geometry``)
    is this module's ``BM, BK, PANEL_BN, FOLD_BN``."""
    got = (ctypes.c_int * 4)()
    launcher(lib, "geometry")(got)
    if tuple(got) != (BM, BK, PANEL_BN, FOLD_BN):
        raise RuntimeError(f"{lib}: the kernels' tiles (BM, BK, PANEL_BN, FOLD_BN) = "
                           f"{tuple(got)}, the launch plan's {(BM, BK, PANEL_BN, FOLD_BN)}")


@functools.lru_cache(maxsize=None)
def blocks_per_sm(lib: str, *args: int) -> int:
    """Resident blocks per SM of a product kernel, from the built library's
    ``<lib>_blocks_per_sm(*args, &out)`` (the CUDA occupancy calculator at
    the kernel's registers and shared memory). The library's tile geometry
    is checked first, since the plan built on the answer sizes its buffers."""
    check_geometry(lib)
    out = ctypes.c_int(0)
    rc = launcher(lib, "blocks_per_sm")(*args, ctypes.byref(out))
    if rc != 0 or out.value < 1:
        raise RuntimeError(f"{lib} occupancy query failed: cudaError {rc}, {out.value} blocks")
    return out.value


def score_scratch(s_c: int, L: int, c: int, device) -> torch.Tensor:
    """Scratch of the score stage: each 128-row tile's share of ``Qᵀ·sc_a``
    and of the energies (``score_scratch`` in ``csrc/panel_stages.cuh``)."""
    return torch.empty(math.ceil(s_c / BM) * (c + 1) * L, dtype=torch.float32, device=device)


def device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def panel_score_kernel(sc, a_l, q, sc_a, resid2, energy) -> None:
    """Launch the stages on the current stream into the given outputs."""
    s_c, m = sc.shape
    L = a_l.shape[1]
    codes = (DTYPE_CODE[sc.dtype], DTYPE_CODE[a_l.dtype])
    n_sm = sm_count(device_index(sc))
    plan = split_plan(s_c, L, m, n_sm, blocks_per_sm("panel_score", *codes))
    partial = torch.empty(plan.partial_slots * BM * PANEL_BN, dtype=torch.float32,
                          device=sc.device)
    scratch = score_scratch(s_c, L, q.shape[1], sc.device)
    rc = launcher("panel_score")(
        *codes, sc.data_ptr(), sc.stride(0), a_l.data_ptr(), a_l.stride(0),
        q.data_ptr(), q.stride(0), q.shape[1], partial.data_ptr(), plan.nblocks,
        scratch.data_ptr(), sc_a.data_ptr(), resid2.data_ptr(), energy.data_ptr(), s_c, m, L,
        torch.cuda.current_stream(sc.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"panel_score kernel launch failed: cudaError {rc}")
