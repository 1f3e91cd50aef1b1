"""Kernel wrappers: argument checks, dispatch and launch counts.

Dispatch rule, the same for every wrapper:

* a tensor on the CPU takes the kernel's plain version (:mod:`.ref`);
* a tensor on a CUDA device launches the hand-written kernel, or raises when
  the arguments are outside what the kernel takes. There is no fallback;
* a tensor on the ``meta`` device takes a shape-only launch: it returns
  outputs of the kernel's shapes, unwritten, and only a census counts it
  (the dry run's, :mod:`repro_torch.launch.hlo_census`): ``LAUNCHES``
  counts launches on a card alone.

Under a :class:`~repro_torch.launch.hlo_census.Census` each wrapper records
one launch with the operations and bytes of its bound; the ops it runs
itself (the plain version, the orders it builds) are not counted.

``LAUNCHES`` counts, per kernel, the launches made (a plain integer each;
kernel 1's stacked launches, one for a whole head batch, under
``countsketch_batched``); :func:`reset_launches` sets them to 0. A wrapper
called while a CUDA graph captures launches nothing: inside
:func:`captured_launches` its count is recorded instead, and
:func:`add_launches` adds the record at each replay of the graph. Three
test hooks: ``_FORCE_KERNEL_ROUTE`` makes :func:`kernel_route_enabled` true
on the CPU, so the engine's kernel route (Route B) runs there with the
plain versions; :func:`force_plain` makes CUDA tensors take the plain
versions, so a run on the card can be compared with the kernels;
:func:`eager_route` makes :func:`repro_torch.serve.generate` run its decode
loop eagerly on the card, so the CUDA graphs can be compared with it. Only
tests and ``chip_smoke.py`` use them. Counterpart of
``repro/kernels/ops.py``.
"""

from __future__ import annotations

import contextlib

import torch

from .. import census as _census
from . import ref
from .countsketch import (VIEW_CHUNK, batched_window_orders, bucket_order,
                          countsketch_batched_fold_kernel, countsketch_batched_kernel,
                          countsketch_batched_view_kernel, countsketch_fold_kernel,
                          countsketch_kernel, countsketch_view_kernel, window_orders)
from .panel_score import panel_score_kernel
from .panel_update import panel_update_kernel
from .twoside_sketch import twoside_sketch_kernel

LAUNCHES = {"countsketch": 0, "countsketch_batched": 0, "panel_score": 0, "panel_update": 0,
            "twoside_sketch": 0}

# Test hook: take the kernel route on the CPU (plain versions run there).
_FORCE_KERNEL_ROUTE = False
_PLAIN = False
_EAGER = False

_DTYPES = (torch.float32, torch.bfloat16)
_F32, _BF16 = torch.float32, torch.bfloat16
# (sketch, panel) pairs that kernels 2 and 3 take: one dtype, or an fp32
# sketch with a bf16 panel (a bf16 Gaussian stream: the reference draws its
# sketch in fp32). Kernel 3 takes C and M in either dtype with any pair.
_PAIRS = ((_F32, _F32), (_BF16, _BF16), (_F32, _BF16))
_MAX_L = 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def force_plain():
    """Within the block, CUDA tensors take the plain versions (no launches)."""
    global _PLAIN
    prev, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = prev


@contextlib.contextmanager
def eager_route():
    """Within the block, ``generate`` decodes on the card step by step,
    eagerly, with no CUDA graph: the route its graphs are held against."""
    global _EAGER
    prev, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = prev


@contextlib.contextmanager
def captured_launches():
    """Within the block (a CUDA graph's capture), the wrappers' launches are
    recorded, not counted: yields a dict that holds, on exit, the launches
    of each kernel the graph holds, and ``LAUNCHES`` is as it was before."""
    before = dict(LAUNCHES)
    record = {}
    try:
        yield record
    finally:
        for k in LAUNCHES:
            record[k] = LAUNCHES[k] - before[k]
            LAUNCHES[k] = before[k]


def add_launches(record: dict) -> None:
    """Count the launches of one replay of a graph (its :func:`captured_launches` record)."""
    for k, n in record.items():
        LAUNCHES[k] += n


def kernel_route_enabled(t: torch.Tensor) -> bool:
    """Should engine hooks send panels down the kernel route? True for CUDA
    and ``meta`` tensors (a census counts the card's route), and on the CPU
    when a test forces the route."""
    return _FORCE_KERNEL_ROUTE or t.is_cuda or t.is_meta


def _meta(*tensors) -> bool:
    """True for a shape-only launch: the tensors lie on ``meta``."""
    return all(t.is_meta for t in tensors)


def _on_card(*tensors) -> bool:
    """True when the kernel must launch, False for the plain version."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return not _PLAIN


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _row_major(name: str, t: torch.Tensor) -> None:
    _check(t.dim() == 2 and t.stride(1) == 1,
           f"{name} must be 2-D with contiguous rows, got shape {tuple(t.shape)} "
           f"strides {t.stride()}")


# fewest columns of a column-major operand for which a transposed output
# (apply_t) goes to the view kernel: 32 bands of 32 columns. Below it the
# view kernel has too few blocks, while the gather kernel's warps, which
# span buckets, read along one column.
_VIEW_T_MIN_COLS = 1024


def reads_columns(a: torch.Tensor, transpose_out: bool = False) -> bool:
    """Does :func:`countsketch_apply` give ``a`` to the view kernel? Yes for a
    column-major ``a`` (a transposed view such as ``Aᵀ``) with a row-major
    output, or with the transposed output when ``a`` has at least
    ``_VIEW_T_MIN_COLS`` columns; every other layout goes to the gather
    kernel."""
    return (a.dim() == 2 and a.stride(0) == 1 and a.stride(1) != 1 and min(a.shape) > 1
            and (not transpose_out or a.shape[1] >= _VIEW_T_MIN_COLS))


def _sketch_args(hashes, signs, rows: int) -> None:
    _check(hashes.shape == (rows,) and signs.shape == (rows,),
           f"hashes/signs must be ({rows},), got {tuple(hashes.shape)}/{tuple(signs.shape)}")


def _sketch_on_card(hashes, signs) -> None:
    _check(hashes.dtype == torch.int32 and signs.dtype == torch.float32,
           "hashes must be int32 and signs float32")
    _check(hashes.is_contiguous() and signs.is_contiguous(), "hashes/signs must be contiguous")


# ---------------------------------------------------------------------------
# Census records: each launch's operations and bytes, by its bound's formula
# (PERF.md §6: each input read once, each output written once)
# ---------------------------------------------------------------------------

_nb = _census.nbytes


def _apply_bound(out, hashes, signs, a, s, **_):
    m, n = a.shape
    return ("countsketch", m * n, _nb(a) + 8 * m + 4 * s * n) if m and n and s else None


def _fold_bound(out, hashes, signs, x, M, **_):
    m = x.shape[1]
    return ("countsketch", x.numel(), _nb(x) + 2 * _nb(M) + 8 * m) if M.numel() and m else None


def _batched_bound(out, hashes, signs, a, s, **_):
    N, p, m = hashes.shape
    ok = a.numel() and s
    return ("countsketch_batched", p * a.numel(), _nb(a) + 8 * N * p * m + 4 * out.numel()
            ) if ok else None


def _batched_fold_bound(out, hashes, signs, x, M, **_):
    N, p, m = hashes.shape
    return ("countsketch_batched", p * x.numel(), _nb(x) + 2 * _nb(M) + 8 * N * p * m
            ) if M.numel() and m else None


def _score_bound(out, sc, a_l, q):
    (s_c, m), L, c = sc.shape, a_l.shape[1], q.shape[1]
    flops = 2 * s_c * L * (m + c + 1)
    return ("panel_score", flops, _nb(sc) + _nb(a_l) + _nb(q) + 4 * (s_c * L + 2 * L)
            ) if L else None


def _update_bound(out, sc, a_l, srt, q, C, M, *, panel_cap, **_):
    # C's admitted columns at panel_cap, the most a panel admits: a census
    # reads nothing back
    (s_c, m), L, c = sc.shape, a_l.shape[1], q.shape[1]
    flops = 2 * s_c * L * (m + c + 1 + M.shape[1])
    cols = int(panel_cap) * m * C.element_size()
    return ("panel_update", flops, _nb(sc) + _nb(a_l) + _nb(srt) + _nb(q) + 2 * _nb(M) + cols
            + 4 * (s_c * L + 4 * L))


def _twoside_bound(out, sc, a, srt):
    B = a.shape[0] if a.dim() == 3 else 1
    (s_c, m), (n, s_r) = sc.shape, srt.shape
    flops = 2 * B * s_c * n * (m + s_r)
    return ("twoside_sketch", flops, _nb(sc) + _nb(a) + _nb(srt) + 4 * B * s_c * s_r
            ) if m and n else None


@_census.kernel_launch(_apply_bound)
def countsketch_apply(hashes, signs, a, s: int, *, order=None, chunks=None,
                      transpose_out: bool = False):
    """``S·a`` for a CountSketch ``(hashes, signs)`` with ``s`` buckets, fp32.

    ``a`` is (m, n) with any strides (a transposed view needs no copy). A
    column-major ``a`` (:func:`reads_columns`) goes to the view kernel, which
    walks ``chunks``, the ``window_orders(hashes, s, VIEW_CHUNK)``; any other
    to the gather kernel, which walks ``order``, the :func:`bucket_order` of
    ``hashes``. Either is built here when not given. With ``transpose_out``
    the result is returned as the contiguous (n, s) transpose ``(S·a)ᵀ``
    (what ``apply_t`` wants).
    """
    _check(a.dim() == 2, f"a must be 2-D, got {tuple(a.shape)}")
    m, n = a.shape
    _sketch_args(hashes, signs, m)
    if _meta(hashes, signs, a):
        shape = (n, s) if transpose_out else (s, n)
        return a.new_empty(shape, dtype=torch.float32)
    if not _on_card(hashes, signs, a):
        out = ref.countsketch_ref(hashes, signs, a, s)
        return out.T.contiguous() if transpose_out else out
    _check(a.dtype in _DTYPES, f"a must be float32 or bfloat16, got {a.dtype}")
    _sketch_on_card(hashes, signs)
    view = reads_columns(a, transpose_out)
    # grid rows of 8 outputs along the slower output dimension, or view
    # bands of 32 columns (at most 65535 either way)
    _check((n if transpose_out else s) <= 8 * 65535 and (n <= 32 * 65535 or not view),
           f"too many outputs: s={s}, n={n}")
    if transpose_out:
        out = torch.empty((n, s), dtype=torch.float32, device=a.device)
        strides = (1, s)
    else:
        out = torch.empty((s, n), dtype=torch.float32, device=a.device)
        strides = (n, 1)
    if m == 0 or n == 0 or s == 0:
        return out.zero_()
    if view:
        perm, start = chunks if chunks is not None else window_orders(hashes, s, VIEW_CHUNK)
        countsketch_view_kernel(perm, start, hashes, signs, a, out, out_strides=strides, s=s)
    else:
        perm, start = order if order is not None else bucket_order(hashes, s)
        countsketch_kernel(perm, start, signs, a, out, out_strides=strides, s=s)
    LAUNCHES["countsketch"] += 1
    return out


@_census.kernel_launch(_fold_bound)
def countsketch_fold(hashes, signs, x, M, *, order=None, fold_dtype=torch.float32):
    """``M += (x·Sᵀ).to(fold_dtype).to(M.dtype)`` in place for a CountSketch
    ``S`` = ``(hashes, signs)`` with ``s = M.shape[1]`` buckets: the
    streaming engine's per-panel fold of ``x = S_C·A_L`` (rows, m) into
    ``M`` (rows, s). Rounds exactly as that expression does: the fp32 bucket
    sum, then ``fold_dtype`` (float32 or bfloat16), then the add in ``M``'s
    dtype. ``order`` is the :func:`bucket_order` of ``hashes`` (built when
    not given); on the card ``M`` must have contiguous rows, and buckets
    without rows leave ``M`` as it is. Returns ``M``.
    """
    _check(x.dim() == 2 and M.dim() == 2 and x.shape[0] == M.shape[0],
           f"x (rows, m) and M (rows, s) must share rows, got {tuple(x.shape)}, {tuple(M.shape)}")
    _sketch_args(hashes, signs, x.shape[1])
    _check(fold_dtype in _DTYPES, f"fold_dtype must be float32 or bfloat16, got {fold_dtype}")
    s = M.shape[1]
    if _meta(hashes, signs, x, M):
        return M
    if not _on_card(hashes, signs, x, M):
        return M.add_(ref.countsketch_ref(hashes, signs, x.T, s).T.to(fold_dtype).to(M.dtype))
    _check(x.dtype in _DTYPES and M.dtype in _DTYPES,
           f"x and M must be float32 or bfloat16, got {x.dtype}, {M.dtype}")
    _sketch_on_card(hashes, signs)
    _row_major("M", M)
    _check(x.shape[0] <= 8 * 65535, f"too many rows: {x.shape[0]}")
    if M.numel() and x.shape[1]:
        perm, start = order if order is not None else bucket_order(hashes, s)
        countsketch_fold_kernel(perm, start, signs, x, M, round_bf16=fold_dtype == _BF16)
        LAUNCHES["countsketch"] += 1
    return M


def _stack_args(hashes, signs, a, rows_dim: int) -> tuple:
    _check(hashes.dim() == 3 and signs.shape == hashes.shape and a.dim() == 3
           and a.shape[0] == hashes.shape[0] and a.shape[rows_dim] == hashes.shape[2],
           f"need hashes/signs (N, p, m) and a stack of N operands with m rows, got "
           f"{tuple(hashes.shape)}, {tuple(signs.shape)}, {tuple(a.shape)}")
    return hashes.shape


def _stack_on_card(hashes, signs, *orders) -> None:
    """The layout the stacked launches take: every (item, part) sketch at a
    fixed stride, contiguous along its columns, the same for hashes and
    signs; each order array contiguous along its last dimension."""
    _check(hashes.dtype == torch.int32 and signs.dtype == torch.float32,
           "hashes must be int32 and signs float32")
    N, p, _ = hashes.shape
    for t in (hashes, signs):
        _check(t.stride(2) == 1 and (N == 1 or t.stride(0) == p * t.stride(1)),
               f"sketch stacks need unit column strides and evenly spaced parts, got {t.stride()}")
    _check(hashes.stride() == signs.stride(), "hashes and signs must share strides")
    for t in orders:
        _check(t.dtype == torch.int32 and t.stride(-1) == 1, "orders must be int32 rows")
    _check(N <= 65535, f"at most 65535 items a launch, got {N}")


def _whole_orders(hashes, s: int, L: int) -> tuple:
    N, p, m = hashes.shape
    return batched_window_orders(hashes.reshape(N * p, m), s, L)


@_census.kernel_launch(_batched_bound)
def countsketch_batched(hashes, signs, a, s: int, *, order=None, chunks=None,
                        transpose_out: bool = False):
    """``out[n] = Σ_q S_{n,q}·a[n]`` for a stack of N items of ``p``
    CountSketches each (an OSNAP per item), the parts added in order, fp32.

    ``hashes``/``signs`` are (N, p, m); ``a`` is (N, m, ncols) with any
    strides. Returns (N, s, ncols), or with ``transpose_out`` the contiguous
    (N, ncols, s). One launch for the whole stack: items whose operands are
    column-major (as :func:`reads_columns` decides for one) go to the view
    kernel, which walks ``chunks`` — the (N·p, m) and (N·p, chunks, s+1)
    :func:`batched_window_orders` at ``VIEW_CHUNK`` — and writes one slab
    per part, added here in order; the rest to the gather kernel, which
    walks ``order`` — (N·p, m) rows and (N·p, s+1) offsets, any row
    strides. Either is built here when not given.
    """
    N, p, m = _stack_args(hashes, signs, a, 1)
    ncols = a.shape[2]
    if _meta(hashes, signs, a):
        shape = (N, ncols, s) if transpose_out else (N, s, ncols)
        return a.new_empty(shape, dtype=torch.float32)
    if not _on_card(hashes, signs, a):
        out = ref.countsketch_batched_ref(hashes, signs, a, s)
        return out.transpose(1, 2).contiguous() if transpose_out else out
    _check(a.dtype in _DTYPES, f"a must be float32 or bfloat16, got {a.dtype}")
    view = reads_columns(a[0], transpose_out)
    _check((ncols if transpose_out else s) <= 8 * 65535 and (ncols <= 32 * 65535 or not view),
           f"too many outputs: s={s}, ncols={ncols}")
    shape = (N, ncols, s) if transpose_out else (N, s, ncols)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    if m == 0 or ncols == 0 or s == 0 or N == 0:
        return out.zero_()
    if view:
        perm, start = chunks if chunks is not None else _whole_orders(hashes, s, VIEW_CHUNK)
        _stack_on_card(hashes, signs, perm, start)
        _check(N * p <= 65535, f"at most 65535 sketches a view launch, got {N * p}")
        slabs = torch.empty((N * p,) + shape[1:], dtype=torch.float32, device=a.device)
        strides = (slabs.stride(0), 1, s) if transpose_out else slabs.stride()
        countsketch_batched_view_kernel(
            perm, start, hashes, signs, a, slabs, out_strides=strides, s=s, items=N, parts=p,
            order_strides=(perm.stride(0), start.stride(0), signs.stride(1)))
        slabs = slabs.view((N, p) + shape[1:])
        out.copy_(slabs[:, 0])
        for q in range(1, p):
            out.add_(slabs[:, q])
    else:
        if order is None:
            perm, start = _whole_orders(hashes, s, m)
            order = (perm, start[:, 0])
        perm, start = order
        _stack_on_card(hashes, signs, perm, start)
        strides = (out.stride(0), 1, s) if transpose_out else out.stride()
        countsketch_batched_kernel(
            perm, start, signs, a, out, a_strides=a.stride(), out_strides=strides, s=s, items=N,
            parts=p, order_strides=(perm.stride(0), start.stride(0), signs.stride(1)))
    LAUNCHES["countsketch_batched"] += 1
    return out


@_census.kernel_launch(_batched_fold_bound)
def countsketch_batched_fold(hashes, signs, x, M, *, order=None):
    """``M[n] += (Σ_q x[n]·S_{n,q}ᵀ).to(M.dtype)`` in place for a stack of N
    items of ``p`` CountSketches (``s = M.shape[2]`` buckets): the batched
    per-panel fold of ``x = S_C·A_L`` (N, rows, m) into ``M`` (N, rows, s),
    with the bits of ``M.add_(apply_t(x))`` per item — the parts' fp32 sums
    added in order, then into ``M``. ``order`` as for
    :func:`countsketch_batched`'s gather kernel; on the card each item of
    ``M`` has contiguous rows, and buckets without rows in any part leave
    ``M`` as it is. Returns ``M``."""
    N, p, m = _stack_args(hashes, signs, x, 2)
    _check(M.dim() == 3 and M.shape[:2] == x.shape[:2],
           f"x (N, rows, m) and M (N, rows, s) must share N and rows, got "
           f"{tuple(x.shape)}, {tuple(M.shape)}")
    s = M.shape[2]
    if _meta(hashes, signs, x, M):
        return M
    if not _on_card(hashes, signs, x, M):
        return M.add_(ref.countsketch_batched_ref(hashes, signs, x.transpose(1, 2), s)
                      .transpose(1, 2).to(M.dtype))
    _check(x.dtype in _DTYPES and M.dtype in _DTYPES,
           f"x and M must be float32 or bfloat16, got {x.dtype}, {M.dtype}")
    _check(M.stride(2) == 1, f"M's items need contiguous rows, got strides {M.stride()}")
    _check(x.shape[1] <= 8 * 65535, f"too many rows: {x.shape[1]}")
    if M.numel() and m:
        if order is None:
            perm, start = _whole_orders(hashes, s, m)
            order = (perm, start[:, 0])
        perm, start = order
        _stack_on_card(hashes, signs, perm, start)
        countsketch_batched_fold_kernel(perm, start, signs, x, M, s=s, items=N, parts=p,
                                        order_strides=(perm.stride(0), start.stride(0),
                                                       signs.stride(1)))
        LAUNCHES["countsketch_batched"] += 1
    return M


@_census.kernel_launch(_score_bound)
def panel_score(sc, a_l, q):
    """``(sc_a, resid2, energy)`` of one panel, fp32: ``sc_a = S_C·A_L`` (s_c, L),
    ``energy_j = ‖sc_a[:, j]‖²``, ``resid2_j = max(energy_j − ‖qᵀ sc_a[:, j]‖², 0)``.

    ``sc`` (s_c, m) and ``a_l`` (m, L) are float32 and float32, bfloat16 and
    bfloat16, or a float32 sketch with a bfloat16 panel, with contiguous rows
    (row strides are free, so a panel window of a wider matrix needs no
    copy); ``q`` is float32 (s_c, c).
    """
    _check((sc.dtype, a_l.dtype) in _PAIRS,
           f"sc/a_l must be float32/float32, bfloat16/bfloat16 or float32/bfloat16, "
           f"got {sc.dtype}/{a_l.dtype}")
    if _meta(sc, a_l, q):
        s_c, L = sc.shape[0], a_l.shape[1]
        return (sc.new_empty((s_c, L), dtype=torch.float32),
                sc.new_empty((L,), dtype=torch.float32), sc.new_empty((L,), dtype=torch.float32))
    if not _on_card(sc, a_l, q):
        return ref.panel_score_ref(sc, a_l, q)
    s_c, m = sc.shape
    _row_major("sc", sc)
    _row_major("a_l", a_l)
    _row_major("q", q)
    _check(a_l.shape[0] == m and q.shape[0] == s_c,
           f"shape mismatch: sc {tuple(sc.shape)}, a_l {tuple(a_l.shape)}, q {tuple(q.shape)}")
    _check(q.dtype == torch.float32, "q must be float32")
    _check(s_c > 0 and m > 0, f"empty sketch product: s_c = {s_c}, m = {m}")
    L = a_l.shape[1]
    dev = sc.device
    sc_a = torch.empty((s_c, L), dtype=torch.float32, device=dev)
    resid2 = torch.empty((L,), dtype=torch.float32, device=dev)
    energy = torch.empty((L,), dtype=torch.float32, device=dev)
    if L == 0:
        return sc_a, resid2, energy
    panel_score_kernel(sc, a_l, q, sc_a, resid2, energy)
    LAUNCHES["panel_score"] += 1
    return sc_a, resid2, energy


def _scalars(vals, dtype, device):
    """The values (numbers or 0-dim tensors) as one tensor on ``device``,
    filled there: no copy from pageable host memory, which would wait for
    the stream."""
    return torch.stack([v.to(dtype=dtype, device=device).reshape(()) if torch.is_tensor(v)
                        else torch.full((), v, dtype=dtype, device=device) for v in vals])


@_census.kernel_launch(_update_bound)
def panel_update(sc, a_l, srt, q, C, M, *, min_gain, run_mean, true_cols, n_filled,
                 free, panel_cap: int):
    """Admission-only panel update; ``C`` and ``M`` are updated in place.

    Shapes: ``sc (s_c, m)``, ``a_l (m, L)``, ``srt (L, s_r)`` (row-major or
    a transposed window of ``S_R``, strides (1, n)), ``q (s_c, c)``,
    ``C (m, c_total)``, ``M (s_c, s_r)``. Dtypes: the sketch ``sc`` (and
    ``srt``, which shares it) with the panel float32/float32,
    bfloat16/bfloat16 or float32/bfloat16; ``C`` and ``M`` share float32 or
    bfloat16 with any of these; ``q`` is float32. The scalars may be
    numbers or 0-dim tensors.
    Returns ``(C, M, sc_a, resid2, energy, slots)`` with ``slots[j]`` the C
    slot column ``j`` went to, or the ``c_total`` sentinel.
    """
    _check((sc.dtype, a_l.dtype) in _PAIRS and srt.dtype == sc.dtype and C.dtype in _DTYPES
           and M.dtype == C.dtype,
           f"sketch/panel must be float32/float32, bfloat16/bfloat16 or float32/bfloat16 "
           f"with srt as the sketch, and C and M one of float32 or bfloat16, got sc "
           f"{sc.dtype}, a_l {a_l.dtype}, srt {srt.dtype}, C {C.dtype}, M {M.dtype}")
    kw = dict(min_gain=min_gain, run_mean=run_mean, true_cols=true_cols,
              n_filled=n_filled, free=free, panel_cap=panel_cap)
    if _meta(sc, a_l, srt, q, C, M):
        s_c, L = sc.shape[0], a_l.shape[1]
        f32 = dict(dtype=torch.float32)
        return (C, M, sc.new_empty((s_c, L), **f32), sc.new_empty((L,), **f32),
                sc.new_empty((L,), **f32), sc.new_empty((L,), dtype=torch.int32))
    if not _on_card(sc, a_l, srt, q, C, M):
        return ref.panel_update_ref(sc, a_l, srt, q, C, M, **kw)
    s_c, m = sc.shape
    L = a_l.shape[1]
    for name, t in (("sc", sc), ("a_l", a_l), ("q", q), ("C", C), ("M", M)):
        _row_major(name, t)
    _check(srt.dim() == 2 and srt.shape[0] == L, f"srt must be ({L}, s_r), got {tuple(srt.shape)}")
    _check(a_l.shape[0] == m and q.shape[0] == s_c and C.shape[0] == m
           and M.shape == (s_c, srt.shape[1]),
           f"shape mismatch: sc {tuple(sc.shape)}, a_l {tuple(a_l.shape)}, "
           f"srt {tuple(srt.shape)}, q {tuple(q.shape)}, C {tuple(C.shape)}, M {tuple(M.shape)}")
    _check(srt.stride(0) == 1 or srt.stride(1) == 1,
           f"srt needs a unit stride, got strides {srt.stride()}")
    _check(q.dtype == torch.float32, "q must be float32")
    _check(s_c > 0 and m > 0, f"empty sketch product: s_c = {s_c}, m = {m}")
    _check(0 < L <= _MAX_L, f"panel width must be in [1, {_MAX_L}], got {L}")
    dev = sc.device
    scal_f = _scalars((min_gain, run_mean, true_cols), torch.float32, dev)
    scal_i = _scalars((n_filled, free), torch.int32, dev)
    sc_a = torch.empty((s_c, L), dtype=torch.float32, device=dev)
    resid2 = torch.empty((L,), dtype=torch.float32, device=dev)
    energy = torch.empty((L,), dtype=torch.float32, device=dev)
    slots = torch.empty((L,), dtype=torch.int32, device=dev)
    panel_update_kernel(sc, a_l, srt, q, C, M, scal_f, scal_i, panel_cap=int(panel_cap),
                        sc_a=sc_a, resid2=resid2, energy=energy, slots=slots)
    LAUNCHES["panel_update"] += 1
    return C, M, sc_a, resid2, energy, slots


@_census.kernel_launch(_twoside_bound)
def twoside_sketch(sc, a, srt):
    """``M = sc·a·srt`` in fp32: (s_c, m)·(m, n)·(n, s_r) → (s_c, s_r), or
    for a batch ``a`` (B, m, n) → (B, s_c, s_r) with ``sc``/``srt`` shared.

    The three operands share float32 or bfloat16. On the card ``sc`` and
    each item of ``a`` have contiguous rows and ``srt`` a unit stride
    (usually the transposed view ``S_R.mat.T``); other layouts raise.
    """
    _check(a.dim() in (2, 3), f"a must be (m, n) or (B, m, n), got {tuple(a.shape)}")
    _check(sc.dim() == 2 and srt.dim() == 2 and sc.shape[1] == a.shape[-2]
           and srt.shape[0] == a.shape[-1],
           f"shape mismatch: sc {tuple(sc.shape)}, a {tuple(a.shape)}, srt {tuple(srt.shape)}")
    if _meta(sc, a, srt):
        shape = (sc.shape[0], srt.shape[1]) if a.dim() == 2 else (a.shape[0], sc.shape[0],
                                                                    srt.shape[1])
        return a.new_empty(shape, dtype=torch.float32)
    if not _on_card(sc, a, srt):
        return ref.twoside_sketch_ref(sc, a, srt)
    _check(sc.dtype in _DTYPES and a.dtype == sc.dtype and srt.dtype == sc.dtype,
           "sc/a/srt must share float32 or bfloat16")
    a3 = a if a.dim() == 3 else a.unsqueeze(0)
    B, m, n = a3.shape
    _check(sc.stride(1) == 1 and a3.stride(2) == 1 and 1 in srt.stride(),
           f"sc and a need contiguous rows, srt a unit stride: strides {sc.stride()}, "
           f"{a3.stride()}, {srt.stride()}")
    out = torch.empty((B, sc.shape[0], srt.shape[1]), dtype=torch.float32, device=a.device)
    if out.numel() and m and n:
        twoside_sketch_kernel(sc, a3, srt, out)
        LAUNCHES["twoside_sketch"] += 1
    else:
        out.zero_()
    return out if a.dim() == 3 else out[0]


__all__ = [
    "LAUNCHES",
    "reset_launches",
    "force_plain",
    "eager_route",
    "captured_launches",
    "add_launches",
    "kernel_route_enabled",
    "bucket_order",
    "window_orders",
    "batched_window_orders",
    "countsketch_batched",
    "countsketch_batched_fold",
    "reads_columns",
    "countsketch_apply",
    "countsketch_fold",
    "panel_score",
    "panel_update",
    "twoside_sketch",
]
