"""Kernel 1: CountSketch ``S·A`` (``csrc/countsketch.cu``).

Counterpart of ``repro/kernels/countsketch.py``. The kernels sum each
bucket's rows in ascending row order; the orders they walk are built in plain
torch, once per sketch: :func:`bucket_order` for a whole sketch (or window),
:func:`window_orders` for every window of a grid at once (a streamed sketch's
panels, or the view kernel's chunks), and :func:`batched_window_orders` for
a stack of K sketches at once (the head batch of the KV compressor: every
head's OSNAP parts, each window of each). Call through
:func:`repro_torch.kernels.ops.countsketch_apply`,
:func:`repro_torch.kernels.ops.countsketch_fold` and their batched
counterparts, which check the arguments and count launches.
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
    perm, start = batched_window_orders(hashes[None], s, L)
    return perm[0], start[0]


def batched_window_orders(hashes: torch.Tensor, s: int, L: int) -> tuple:
    """:func:`window_orders` of each of K stacked sketches, ``hashes``
    (K, m), from one stable sort of the key ``(item·windows + window)·s +
    hash``: ``perm`` (K, m) and ``start`` (K, windows, s+1), item ``k``'s
    window orders at ``perm[k]``, ``start[k]``. With ``L >= m`` each item's
    one window is its whole :func:`bucket_order`."""
    K, m = hashes.shape
    dev = hashes.device
    nw = -(-m // L)
    if nw == 0:
        return (torch.zeros((K, 0), dtype=torch.int32, device=dev),
                torch.zeros((K, 0, s + 1), dtype=torch.int32, device=dev))
    rows = torch.arange(m, device=dev)
    item = torch.arange(K, device=dev)[:, None]
    keys, perm = torch.sort(((item * nw + rows // L) * s + hashes.long()).reshape(-1),
                            stable=True)
    first = torch.arange(K * nw, device=dev)
    bounds = first[:, None] * s + torch.arange(s + 1, device=dev)
    start = torch.searchsorted(keys, bounds) - ((first // nw) * m + (first % nw) * L)[:, None]
    return (perm % m % L).reshape(K, m).to(torch.int32), start.reshape(K, nw, s + 1).to(torch.int32)


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


def countsketch_batched_kernel(perm, start, signs, a, out, *, a_strides, out_strides, s: int,
                               items: int, parts: int, order_strides) -> None:
    """Launch on the current stream, over ``items`` items of ``parts``
    CountSketches each: ``out[n, b, j] = Σ_q Σ_{h[n,q,i]=b} signs[n,q,i]·a[n,i,j]``,
    the parts' sums added in order. ``a_strides`` and ``out_strides`` are
    (item, row, column) strides; ``order_strides`` the strides between
    consecutive (item, part) sketches of ``perm``, ``start`` and ``signs``
    (the gather kernel with a batch grid axis)."""
    rc = launcher("countsketch", "batched_launch")(
        DTYPE_CODE[a.dtype], perm.data_ptr(), start.data_ptr(), signs.data_ptr(), a.data_ptr(),
        a_strides[0], a_strides[1], a_strides[2], out.data_ptr(), out_strides[0],
        out_strides[1], out_strides[2], s, a.shape[2], items, parts, order_strides[0],
        order_strides[1], order_strides[2], _stream(a),
    )
    _raise(rc, "countsketch batched kernel")


def countsketch_batched_fold_kernel(perm, start, signs, x, M, *, s: int, items: int,
                                    parts: int, order_strides) -> None:
    """``M[n, i, b] += Σ_q Σ_{h[n,q,k]=b} signs[n,q,k]·x[n,i,k]`` on the
    current stream for row-major items of ``M`` (items, rows, s): the
    batched fold (the parts' sums added in order, then into M). Buckets
    without rows in any part are left alone."""
    rc = launcher("countsketch", "batched_fold_launch")(
        DTYPE_CODE[x.dtype], DTYPE_CODE[M.dtype], perm.data_ptr(), start.data_ptr(),
        signs.data_ptr(), x.data_ptr(), x.stride(0), x.stride(2), x.stride(1), M.data_ptr(),
        M.stride(0), M.stride(1), s, x.shape[1], items, parts, order_strides[0],
        order_strides[1], order_strides[2], _stream(x),
    )
    _raise(rc, "countsketch batched fold kernel")


def countsketch_batched_view_kernel(perm, start, hashes, signs, a, out, *, out_strides, s: int,
                                    items: int, parts: int, order_strides) -> None:
    """The view kernel over ``items·parts`` sketches: sketch ``k`` reads
    item ``k // parts`` of the column-major stack ``a`` (items, m, ncols)
    and writes its own slab ``out[k]`` (``out_strides``: sketch, bucket,
    column); ``(perm, start)`` are each sketch's ``VIEW_CHUNK`` chunk
    orders, ``order_strides`` the strides between sketches of ``perm``,
    ``start`` and ``hashes``/``signs``."""
    rc = launcher("countsketch", "batched_view_launch")(
        DTYPE_CODE[a.dtype], perm.data_ptr(), start.data_ptr(), hashes.data_ptr(),
        signs.data_ptr(), a.data_ptr(), a.stride(0), a.stride(2), a.shape[1], a.shape[2],
        out.data_ptr(), out_strides[0], out_strides[1], out_strides[2], s, VIEW_CHUNK,
        items * parts, parts, order_strides[0], order_strides[1], order_strides[2], _stream(a),
    )
    _raise(rc, "countsketch batched view kernel")
