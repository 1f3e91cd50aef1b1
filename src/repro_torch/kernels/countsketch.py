"""Kernel 1: CountSketch ``S·A`` (``csrc/countsketch.cu``).

Counterpart of ``repro/kernels/countsketch.py``. The kernels sum each
bucket's rows in ascending row order; the orders they walk are built in plain
torch, once per sketch: :func:`bucket_order` for a whole sketch (or window),
:func:`window_orders` for every window of a grid at once (a streamed sketch's
panels, or the view kernel's chunks). Call through
:func:`repro_torch.kernels.ops.countsketch_apply` and
:func:`repro_torch.kernels.ops.countsketch_fold`, which check the arguments
and count launches.
"""

from __future__ import annotations

import torch

from .build import launcher

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# rows of A per chunk of the view kernel (VIEW_CHUNK in csrc/countsketch.cu,
# which refuses any other value)
VIEW_CHUNK = 256


def bucket_order(hashes: torch.Tensor, s: int) -> tuple:
    """``(perm, start)``: row ids grouped by bucket, ascending within each
    bucket, and the (s+1,) bucket offsets into ``perm`` (int32 both). No
    value is read back to the host."""
    keys, perm = torch.sort(hashes, stable=True)
    bounds = torch.arange(s + 1, dtype=keys.dtype, device=keys.device)
    return perm.to(torch.int32), torch.searchsorted(keys, bounds).to(torch.int32)


def window_orders(hashes: torch.Tensor, s: int, L: int) -> tuple:
    """The :func:`bucket_order` of every window ``[w·L, (w+1)·L)`` of the
    rows (the last one ragged when ``L`` does not divide them), from one
    stable sort of the key ``window·s + hash``: ``perm`` (m,), window ``w``'s
    rows relative to ``w·L`` at ``perm[w·L : (w+1)·L]``, and ``start``
    (windows, s+1), window ``w``'s offsets into that slice. Both int32."""
    m, dev = hashes.shape[0], hashes.device
    nw = -(-m // L)
    rows = torch.arange(m, device=dev)
    keys, perm = torch.sort((rows // L) * s + hashes.long(), stable=True)
    first = torch.arange(nw, device=dev)
    bounds = first[:, None] * s + torch.arange(s + 1, device=dev)
    start = torch.searchsorted(keys, bounds) - (first * L)[:, None]
    return (perm % L).to(torch.int32), start.to(torch.int32)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def countsketch_kernel(perm, start, signs, a, out, *, out_strides, s: int) -> None:
    """Launch on the current stream: ``out[b, j] = Σ_{h[i]=b} signs[i]·a[i, j]``,
    with ``out``'s element (b, j) at ``b·out_strides[0] + j·out_strides[1]``
    (the gather kernel; ``a`` may have any strides)."""
    rc = launcher("countsketch")(
        DTYPE_CODE[a.dtype], perm.data_ptr(), start.data_ptr(), signs.data_ptr(),
        a.data_ptr(), a.stride(0), a.stride(1), out.data_ptr(),
        out_strides[0], out_strides[1], s, a.shape[1], _stream(a),
    )
    _raise(rc, "countsketch kernel")


def countsketch_view_kernel(perm, start, hashes, signs, a, out, *, out_strides, s: int) -> None:
    """As :func:`countsketch_kernel` for a column-major ``a`` (``a.stride(0)
    == 1``), read along its rows; ``(perm, start)`` is
    ``window_orders(hashes, s, VIEW_CHUNK)``."""
    rc = launcher("countsketch", "view_launch")(
        DTYPE_CODE[a.dtype], perm.data_ptr(), start.data_ptr(), hashes.data_ptr(),
        signs.data_ptr(), a.data_ptr(), a.stride(1), a.shape[0], a.shape[1], out.data_ptr(),
        out_strides[0], out_strides[1], s, VIEW_CHUNK, _stream(a),
    )
    _raise(rc, "countsketch view kernel")


def countsketch_fold_kernel(perm, start, signs, x, M, *, round_bf16: bool) -> None:
    """``M[i, b] += Σ_{h[k]=b} signs[k]·x[i, k]`` on the current stream, for a
    row-major ``M`` (rows, s); each sum rounded to bf16 first with
    ``round_bf16``. Buckets without rows are left alone."""
    rc = launcher("countsketch", "fold_launch")(
        DTYPE_CODE[x.dtype], DTYPE_CODE[M.dtype], int(round_bf16), perm.data_ptr(),
        start.data_ptr(), signs.data_ptr(), x.data_ptr(), x.stride(1), x.stride(0),
        M.data_ptr(), M.stride(0), M.shape[1], x.shape[0], _stream(x),
    )
    _raise(rc, "countsketch fold kernel")
