"""Kernel wrappers: argument checks, dispatch and launch counts.

Dispatch rule, the same for every wrapper:

* a tensor on the CPU takes the kernel's plain version (:mod:`.ref`);
* a tensor on a CUDA device launches the hand-written kernel, or raises when
  the arguments are outside what the kernel takes. There is no fallback.

``LAUNCHES`` counts, per kernel, the calls that launched it (a plain
integer each); :func:`reset_launches` sets them to 0. Two test hooks:
``_FORCE_KERNEL_ROUTE`` makes :func:`kernel_route_enabled` true on the CPU,
so the engine's kernel route (Route B) runs there with the plain versions;
:func:`force_plain` makes CUDA tensors take the plain versions, so a run on
the card can be compared with the kernels. Only tests and ``chip_smoke.py``
use them. Counterpart of ``repro/kernels/ops.py``.
"""

from __future__ import annotations

import contextlib

import torch

from . import ref
from .countsketch import bucket_order, countsketch_kernel
from .panel_score import panel_score_kernel
from .panel_update import panel_update_kernel
from .twoside_sketch import twoside_sketch_kernel

LAUNCHES = {"countsketch": 0, "panel_score": 0, "panel_update": 0, "twoside_sketch": 0}

# Test hook: take the kernel route on the CPU (plain versions run there).
_FORCE_KERNEL_ROUTE = False
_PLAIN = False

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


def kernel_route_enabled(t: torch.Tensor) -> bool:
    """Should engine hooks send panels down the kernel route? True for CUDA
    tensors, and on the CPU when a test forces the route."""
    return _FORCE_KERNEL_ROUTE or t.is_cuda


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


def countsketch_apply(hashes, signs, a, s: int, *, order=None, transpose_out: bool = False):
    """``S·a`` for a CountSketch ``(hashes, signs)`` with ``s`` buckets, fp32.

    ``a`` is (m, n) with any strides (a transposed view needs no copy);
    ``order`` is the precomputed :func:`bucket_order` of ``hashes``. With
    ``transpose_out`` the result is returned as the contiguous (n, s)
    transpose ``(S·a)ᵀ`` (what ``apply_t`` wants).
    """
    _check(a.dim() == 2, f"a must be 2-D, got {tuple(a.shape)}")
    m, n = a.shape
    _check(hashes.shape == (m,) and signs.shape == (m,),
           f"hashes/signs must be ({m},), got {tuple(hashes.shape)}/{tuple(signs.shape)}")
    if not _on_card(hashes, signs, a):
        out = ref.countsketch_ref(hashes, signs, a, s)
        return out.T.contiguous() if transpose_out else out
    _check(a.dtype in _DTYPES, f"a must be float32 or bfloat16, got {a.dtype}")
    _check(hashes.dtype == torch.int32 and signs.dtype == torch.float32,
           "hashes must be int32 and signs float32")
    _check(hashes.is_contiguous() and signs.is_contiguous(), "hashes/signs must be contiguous")
    # grid rows of 8 outputs along the slower output dimension (at most 65535)
    _check((n if transpose_out else s) <= 8 * 65535, f"too many outputs: s={s}, n={n}")
    perm, start = order if order is not None else bucket_order(hashes, s)
    if transpose_out:
        out = torch.empty((n, s), dtype=torch.float32, device=a.device)
        strides = (1, s)
    else:
        out = torch.empty((s, n), dtype=torch.float32, device=a.device)
        strides = (n, 1)
    if m == 0 or n == 0 or s == 0:
        return out.zero_()
    countsketch_kernel(perm, start, signs, a, out, out_strides=strides, s=s)
    LAUNCHES["countsketch"] += 1
    return out


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


def twoside_sketch(sc, a, srt):
    """``M = sc·a·srt`` in fp32: (s_c, m)·(m, n)·(n, s_r) → (s_c, s_r), or
    for a batch ``a`` (B, m, n) → (B, s_c, s_r) with ``sc``/``srt`` shared.

    The three operands share float32 or bfloat16 and may have any strides
    (``srt`` is usually the transposed view ``S_R.mat.T``).
    """
    _check(a.dim() in (2, 3), f"a must be (m, n) or (B, m, n), got {tuple(a.shape)}")
    _check(sc.dim() == 2 and srt.dim() == 2 and sc.shape[1] == a.shape[-2]
           and srt.shape[0] == a.shape[-1],
           f"shape mismatch: sc {tuple(sc.shape)}, a {tuple(a.shape)}, srt {tuple(srt.shape)}")
    if not _on_card(sc, a, srt):
        return ref.twoside_sketch_ref(sc, a, srt)
    _check(sc.dtype in _DTYPES and a.dtype == sc.dtype and srt.dtype == sc.dtype,
           "sc/a/srt must share float32 or bfloat16")
    a3 = a if a.dim() == 3 else a.unsqueeze(0)
    B, m, n = a3.shape
    _check(B <= 65535, f"batch must be at most 65535, got {B}")
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
    "kernel_route_enabled",
    "bucket_order",
    "countsketch_apply",
    "panel_score",
    "panel_update",
    "twoside_sketch",
]
