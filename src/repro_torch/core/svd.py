"""Single-pass SVD (paper §5; counterpart of ``repro/core/svd.py``).

* **Algorithm 3 (Fast SP-SVD)** — :func:`sp_svd_init` /
  :func:`sp_svd_update` / :func:`sp_svd_finalize` over L-column panels,
  and the one-shot :func:`fast_sp_svd`, on the panel engine
  (:mod:`repro_torch.stream.engine`, ``SP_SVD_OPS``);
* **Algorithm 4 (Practical SP-SVD, Tropp et al. 2017)** — the baseline,
  :func:`practical_sp_svd`.

Per panel ``A_L`` at column offset ``off``: ``C += (A_L·Ω[:, cols]ᵀ)·G_Cᵀ``,
``R[:, cols] = G_R·(Ψ·A_L)`` and ``M += (S_C·A_L)·S_R[:, cols]ᵀ``, with Ψ, Ω,
S_C and S_R OSNAP sketches and G_C, G_R Gaussian. On CUDA tensors every
OSNAP apply is kernel 1, two launches per apply (one per part): Ψ and S_C
on the panel, the Ω window on the panel's transpose (the view kernel), the
S_R window in the M fold. The engine indexes the Ω and S_R windows once
per stream, so no panel sorts. Finalize takes QR bases of C and Rᵀ, the
sketched core solve and a small SVD.

Randomness: the inits draw from a ``torch.Generator``, or take pre-drawn
:class:`SPSVDSketches` (parity tests hand the reference's across through
:func:`repro_torch.convert.spsvd_sketches`).

**A stack of N heads** (:class:`StackedSPSVDState`, the counterpart of the
reference's ``vmap(vmap(spsvd_engine_init / panel_update /
spsvd_engine_finalize))`` over its KV compressor's heads): C (N, m, c), R
(N, r, n_pad), M (N, s_c, s_r), the OSNAP sketches stacked
(:class:`~repro_torch.core.sketching.StackedOSNAPSketch`) and G_C, G_R as
(N, c, c0), (N, r, r0). Each OSNAP apply of a panel is one launch of
kernel 1 for all N heads (four per panel: Ψ, S_C, the Ω window, the S_R
fold), so the launches do not grow with N; the Gaussian products are
``torch.bmm`` (plain products the reference leaves to XLA), and finalize
takes batched QR, the batched core solve and a batched SVD. Head ``n``
computes what the per-head engine computes on ``sketches.head(n)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..stream.engine import PanelOps, PanelState, padded_n, panel_update, stream_panels, truncated_R
from .gmr import _solve_least_squares, fast_gmr_core
from .sketching import GaussianSketch, OSNAPSketch, StackedOSNAPSketch, draw_sketch

__all__ = [
    "SPSVDSketches",
    "SPSVDState",
    "SP_SVD_OPS",
    "sp_svd_sizes",
    "spsvd_engine_init",
    "spsvd_engine_finalize",
    "sp_svd_init",
    "sp_svd_update",
    "sp_svd_finalize",
    "fast_sp_svd",
    "practical_sp_svd",
    "svd_error_ratio",
    "StackedSPSVDSketches",
    "StackedSPSVDState",
    "spsvd_stacked_init",
    "spsvd_stacked_sketches",
    "spsvd_stacked_update",
    "spsvd_stacked_fold",
    "spsvd_stacked_scan",
    "spsvd_stacked_finalize",
]


def sp_svd_sizes(k: int, eps: float, gamma: float = 0.25) -> dict:
    """Algorithm 3 step 2 sketch sizes (constants per §6.3's recipe)."""
    ke = k / eps
    c = r = int(math.ceil(3 * ke))
    c0 = r0 = int(math.ceil(3 * ke ** (1.0 + gamma)))
    s = int(math.ceil(3 * k / eps**1.5))
    return dict(c=c, r=r, c0=c0, r0=r0, s_c=s, s_r=s)


@dataclasses.dataclass(frozen=True)
class SPSVDSketches:
    """The six sketching operators of Algorithm 3 step 3."""

    psi: OSNAPSketch  # (r0, m)
    g_r: GaussianSketch  # (r, r0)
    omega: OSNAPSketch  # (c0, n_pad)
    g_c: GaussianSketch  # (c, c0)
    s_c: OSNAPSketch  # (s_c, m)
    s_r: OSNAPSketch  # (s_r, n_pad)


def _svd_core_sketches(sk: SPSVDSketches):
    return sk.s_c, sk.s_r


def _svd_update_c(sk: SPSVDSketches, C, A_L, sc_a, off):
    # C += A_L·Ω̃[cols] with Ω̃[cols] = Ω[:, cols]ᵀ·G_Cᵀ (never materialised)
    a_omega = sk.omega.cols(off, A_L.shape[1]).apply_t(A_L)  # (m, c0)
    return sk, C.add_(sk.g_c.apply_t(a_omega).to(C.dtype))


def _svd_r_block(sk: SPSVDSketches, A_L, off):
    return sk.g_r.apply(sk.psi.apply(A_L))  # R[:, cols] = G_R·(Ψ·A_L)


def _svd_window_sketches(sk: SPSVDSketches):
    return (sk.omega,)


SP_SVD_OPS = PanelOps(
    name="sp_svd",
    core_sketches=_svd_core_sketches,
    update_c=_svd_update_c,
    r_block=_svd_r_block,
    window_sketches=_svd_window_sketches,
)

SPSVDState = PanelState


def spsvd_engine_init(gen: Optional[torch.Generator], m: int, n: int, *, sizes: dict,
                      dtype=torch.float32, osnap_p: int = 2, panel: Optional[int] = None,
                      sketches: Optional[SPSVDSketches] = None,
                      device: DeviceLike = None) -> SPSVDState:
    """Algorithm 3 state with explicit ``sizes``: the six sketches (drawn
    from ``gen`` on ``device`` in the reference's order ψ, G_R, Ω, G_C, S_C,
    S_R, or ``sketches``) and zero accumulators. ``panel`` pads Ω, S_R and
    ``R`` to whole panels, so a ragged last panel is zero-padded exactly.
    ``device=None`` means CUDA (raises without it)."""
    dev = resolve_device(device)
    c, r, c0, r0, s_c, s_r = (sizes[x] for x in ("c", "r", "c0", "r0", "s_c", "s_r"))
    n_pad = padded_n(n, panel) if panel else n
    if sketches is None:
        if gen is None:
            raise ValueError("pass a generator or pre-drawn `sketches`")
        sketches = SPSVDSketches(
            psi=OSNAPSketch.draw(gen, r0, m, p=osnap_p, dtype=dtype),
            g_r=GaussianSketch.draw(gen, r, r0, dtype=dtype),
            omega=OSNAPSketch.draw(gen, c0, n, p=osnap_p, dtype=dtype),
            g_c=GaussianSketch.draw(gen, c, c0, dtype=dtype),
            s_c=OSNAPSketch.draw(gen, s_c, m, p=osnap_p, dtype=dtype),
            s_r=OSNAPSketch.draw(gen, s_r, n, p=osnap_p, dtype=dtype),
        )
    sk = dataclasses.replace(sketches, omega=sketches.omega.pad_cols(n_pad),
                             s_r=sketches.s_r.pad_cols(n_pad))
    return SPSVDState(
        C=torch.zeros((m, c), dtype=dtype, device=dev),
        R=torch.zeros((r, n_pad), dtype=dtype, device=dev),
        M=torch.zeros((s_c, s_r), dtype=dtype, device=dev),
        offset=0,
        ctx=sk,
        ops=SP_SVD_OPS,
        n=n,
    )


def sp_svd_init(gen: Optional[torch.Generator], m: int, n: int, *, k: Optional[int] = None,
                eps: float = 0.5, sizes: Optional[dict] = None, dtype=torch.float32,
                osnap_p: int = 2, panel: Optional[int] = None,
                sketches: Optional[SPSVDSketches] = None,
                device: DeviceLike = None) -> SPSVDState:
    """:func:`spsvd_engine_init` with the paper's k/eps sizing
    (:func:`sp_svd_sizes`) when explicit ``sizes`` are not given."""
    if sizes is None:
        if k is None:
            raise ValueError("pass either `k` (+eps) or explicit `sizes`")
        sizes = sp_svd_sizes(k, eps)
    return spsvd_engine_init(gen, m, n, sizes=sizes, dtype=dtype, osnap_p=osnap_p, panel=panel,
                             sketches=sketches, device=device)


def sp_svd_update(state: SPSVDState, A_L: torch.Tensor) -> SPSVDState:
    """Consume one L-column panel (Algorithm 3 steps 6–8)."""
    return panel_update(state, A_L)


def spsvd_engine_finalize(state: SPSVDState, k: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Algorithm 3 steps 10–13: QR bases, the sketched core solve, a small
    SVD. Returns ``(U, Σ, V)`` with ``A ≈ U diag(Σ) Vᵀ``, of rank c/r, or
    ``k`` when given. U and V are unique only up to the signs of their
    columns; ``U diag(Σ) Vᵀ`` is unique."""
    sk = state.ctx
    R = truncated_R(state)
    dt = torch.promote_types(state.C.dtype, torch.float32)
    U_C, _ = torch.linalg.qr(state.C.to(dt))  # (m, c)
    V_R, _ = torch.linalg.qr(R.T.to(dt))  # (n, r)
    ScU = sk.s_c.apply(U_C.to(state.C.dtype)).to(dt)  # (s_c, c)
    SrV = sk.s_r.apply(V_R.to(state.C.dtype)).to(dt)  # (s_r, r)
    N = fast_gmr_core(ScU, state.M.to(dt), SrV.T)  # (S_C U_C)† M (V_Rᵀ S_Rᵀ)†
    U_N, S, V_Nt = torch.linalg.svd(N, full_matrices=False)
    U = U_C @ U_N
    V = V_R @ V_Nt.T
    if k is not None:
        U, S, V = U[:, :k], S[:k], V[:, :k]
    return U, S, V


def sp_svd_finalize(state: SPSVDState, k: Optional[int] = None):
    """The classic Algorithm-3 name of :func:`spsvd_engine_finalize`."""
    return spsvd_engine_finalize(state, k=k)


def fast_sp_svd(gen: Optional[torch.Generator], A: torch.Tensor, *, k: Optional[int] = None,
                eps: float = 0.5, sizes: Optional[dict] = None, panel: int = 512,
                fixed_rank: Optional[int] = None, route: str = "chunk",
                sketches: Optional[SPSVDSketches] = None):
    """One-shot Algorithm 3: stream ``A`` through the engine in ``panel``-wide
    panels on ``A``'s device (``route`` as in
    :func:`~repro_torch.stream.engine.stream_panels`; ``SP_SVD_OPS`` has no
    chunk hooks, so both routes run the per-panel body)."""
    m, n = A.shape
    state = sp_svd_init(gen, m, n, k=k, eps=eps, sizes=sizes, dtype=A.dtype, panel=panel,
                        sketches=sketches, device=A.device)
    state = stream_panels(state, A, panel, route=route)
    return sp_svd_finalize(state, k=fixed_rank)


def practical_sp_svd(gen: Optional[torch.Generator], A: torch.Tensor, *, c: int, r: int,
                     sketch: str = "gaussian", fixed_rank: Optional[int] = None,
                     sketches=None):
    """Algorithm 4 (Tropp et al. 2017), the baseline: ``C = A Ω̃``,
    ``R = Ψ̃ A``, ``N = (Ψ̃ U_C)† (R V_R)`` — single pass, but the core is
    not a GMR solution (§5.3). ``sketches=(Ψ̃, Ω̃ᵀ)`` (r × m, c × n) injects
    pre-drawn operators; otherwise both are drawn from ``gen``."""
    m, n = A.shape
    if sketches is None:
        psi = draw_sketch(gen, sketch, r, m, dtype=A.dtype)
        omega = draw_sketch(gen, sketch, c, n, dtype=A.dtype)
    else:
        psi, omega = sketches
    C = omega.apply_t(A)  # A Ω̃ (m, c)
    R = psi.apply(A)  # Ψ̃ A (r, n)
    dt = torch.promote_types(A.dtype, torch.float32)
    U_C, _ = torch.linalg.qr(C.to(dt))
    V_R, _ = torch.linalg.qr(R.T.to(dt))
    PsiU = psi.apply(U_C.to(A.dtype)).to(dt)  # (r, c)
    N = _solve_least_squares(PsiU, R.to(dt) @ V_R)  # (c, r)
    U_N, S, V_Nt = torch.linalg.svd(N, full_matrices=False)
    U = U_C @ U_N
    V = V_R @ V_Nt.T
    if fixed_rank is not None:
        U, S, V = U[:, :fixed_rank], S[:fixed_rank], V[:, :fixed_rank]
    return U, S, V


def svd_error_ratio(A: torch.Tensor, U, S, V, k: int) -> torch.Tensor:
    """§6.3 metric: ``‖A − UΣVᵀ‖_F / ‖A − A_k‖_F − 1`` (can be negative)."""
    dt = torch.promote_types(A.dtype, torch.float32)
    approx = (U * S[None, :]) @ V.T
    num = torch.linalg.norm(A.to(dt) - approx.to(dt))
    sv = torch.linalg.svdvals(A.to(dt))
    den = torch.sqrt(torch.sum(sv[k:] ** 2))
    return num / torch.clamp(den, min=torch.finfo(dt).tiny) - 1.0


# ---------------------------------------------------------------------------
# A stack of N heads: the reference's vmap over per-head engines
# ---------------------------------------------------------------------------

OSNAP_FIELDS = ("psi", "omega", "s_c", "s_r")


@dataclasses.dataclass(frozen=True)
class StackedSPSVDSketches:
    """The six operators of Algorithm 3 for N heads: OSNAPs stacked, the
    Gaussians as (N, rows, cols) tensors."""

    psi: StackedOSNAPSketch  # (r0, m) per head
    g_r: torch.Tensor  # (N, r, r0)
    omega: StackedOSNAPSketch  # (c0, n_pad)
    g_c: torch.Tensor  # (N, c, c0)
    s_c: StackedOSNAPSketch  # (s_c, m)
    s_r: StackedOSNAPSketch  # (s_r, n_pad)

    def head(self, i: int) -> SPSVDSketches:
        return SPSVDSketches(psi=self.psi.head(i), g_r=GaussianSketch(self.g_r[i]),
                             omega=self.omega.head(i), g_c=GaussianSketch(self.g_c[i]),
                             s_c=self.s_c.head(i), s_r=self.s_r.head(i))

    def items(self, lo: int, hi: int) -> "StackedSPSVDSketches":
        """Heads ``[lo, hi)`` as views, with the window orders built so far."""
        return StackedSPSVDSketches(**{f: getattr(self, f).items(lo, hi) for f in OSNAP_FIELDS},
                                    g_r=self.g_r[lo:hi], g_c=self.g_c[lo:hi])

    def select(self, heads: torch.Tensor) -> "StackedSPSVDSketches":
        """The heads ``heads`` (a 1-D index tensor), in its order, copied:
        their hashes, signs, Gaussian factors and window orders built so far
        (a rank's block of a stack drawn whole)."""
        return StackedSPSVDSketches(**{f: getattr(self, f).select(heads) for f in OSNAP_FIELDS},
                                    g_r=self.g_r[heads.to(self.g_r.device)],
                                    g_c=self.g_c[heads.to(self.g_c.device)])


@dataclasses.dataclass
class StackedSPSVDState:
    """Algorithm 3's accumulators for N heads, updated in place; ``offset``
    (a host int) counts the columns each head has consumed through
    :func:`spsvd_stacked_update` (:func:`spsvd_stacked_fold` takes its
    offset on the device and leaves this one), ``n`` is the true column
    count."""

    C: torch.Tensor  # (N, m, c)
    R: torch.Tensor  # (N, r, n_pad)
    M: torch.Tensor  # (N, s_c, s_r)
    offset: int
    n: int
    sk: StackedSPSVDSketches

    def items(self, lo: int, hi: int) -> "StackedSPSVDState":
        """Heads ``[lo, hi)``: a state whose accumulators are views of these
        (a panel folded into it lands here) with its own offset."""
        return StackedSPSVDState(C=self.C[lo:hi], R=self.R[lo:hi], M=self.M[lo:hi],
                                 offset=self.offset, n=self.n, sk=self.sk.items(lo, hi))

    def head(self, i: int) -> SPSVDState:
        """Head ``i`` as a per-head engine state (views of these accumulators)."""
        return SPSVDState(C=self.C[i], R=self.R[i], M=self.M[i], offset=self.offset,
                          ctx=self.sk.head(i), ops=SP_SVD_OPS, n=self.n)


def spsvd_stacked_sketches(gen: torch.Generator, N: int, m: int, n: int, *, sizes: dict,
                           dtype=torch.float32, osnap_p: int = 2) -> StackedSPSVDSketches:
    """The stacked sketches of N heads drawn from ``gen`` (on its device) in
    the order ψ, G_R, Ω, G_C, S_C, S_R, each for all N heads."""
    if gen is None:
        raise ValueError("pass a generator or pre-drawn `sketches`")
    c, r, c0, r0, s_c, s_r = (sizes[x] for x in ("c", "r", "c0", "r0", "s_c", "s_r"))
    gauss = lambda rows, cols: (torch.randn((N, rows, cols), generator=gen, device=gen.device,  # noqa: E731
                                            dtype=dtype) * (1.0 / math.sqrt(rows)))
    osnap = lambda s_, m_: StackedOSNAPSketch.draw(gen, N, s_, m_, p=osnap_p, dtype=dtype)  # noqa: E731
    psi, g_r = osnap(r0, m), gauss(r, r0)
    omega, g_c = osnap(c0, n), gauss(c, c0)
    return StackedSPSVDSketches(psi=psi, g_r=g_r, omega=omega, g_c=g_c, s_c=osnap(s_c, m),
                                s_r=osnap(s_r, n))


def spsvd_stacked_init(gen: Optional[torch.Generator], N: int, m: int, n: int, *, sizes: dict,
                       dtype=torch.float32, osnap_p: int = 2, panel: Optional[int] = None,
                       sketches: Optional[StackedSPSVDSketches] = None,
                       device: DeviceLike = None) -> StackedSPSVDState:
    """:func:`spsvd_engine_init` for N heads at once: zero accumulators and
    the stacked sketches (``sketches``, or :func:`spsvd_stacked_sketches`
    drawn from ``gen``). ``panel`` pads Ω, S_R and R to whole panels.
    ``device=None`` means CUDA (raises without it)."""
    dev = resolve_device(device)
    c, r, s_c, s_r = (sizes[x] for x in ("c", "r", "s_c", "s_r"))
    n_pad = padded_n(n, panel) if panel else n
    if sketches is None:
        sketches = spsvd_stacked_sketches(gen, N, m, n, sizes=sizes, dtype=dtype, osnap_p=osnap_p)
    sk = dataclasses.replace(sketches, omega=sketches.omega.pad_cols(n_pad),
                             s_r=sketches.s_r.pad_cols(n_pad))
    return StackedSPSVDState(
        C=torch.zeros((N, m, c), dtype=dtype, device=dev),
        R=torch.zeros((N, r, n_pad), dtype=dtype, device=dev),
        M=torch.zeros((N, s_c, s_r), dtype=dtype, device=dev),
        offset=0, n=n, sk=sk)


def _stacked_panel(state: StackedSPSVDState, A_L: torch.Tensor, s_r, omega) -> torch.Tensor:
    # one panel's M and C folds through the S_R and Ω windows, in the
    # per-head panel_update's order; returns R's new columns G_R (Ψ A_L)
    sk = state.sk
    sc_a = sk.s_c.apply(A_L)  # (N, s_c, L)
    s_r.fold_t(sc_a, state.M)
    a_omega = omega.apply_t(A_L)  # (N, m, c0)
    state.C.add_(torch.bmm(a_omega, sk.g_c.transpose(1, 2)).to(state.C.dtype))
    return torch.bmm(sk.g_r, sk.psi.apply(A_L)).to(state.R.dtype)


def spsvd_stacked_update(state: StackedSPSVDState, A_L: torch.Tensor) -> StackedSPSVDState:
    """Consume one panel ``A_L`` (N, m, L) of every head at ``state.offset``
    (the per-head :func:`~repro_torch.stream.engine.panel_update`'s steps, in
    its order): ``M += (S_C A_L)·S_R[:, cols]ᵀ``, ``C += (A_L Ω[:, cols]ᵀ)
    G_Cᵀ``, ``R[:, cols] = G_R (Ψ A_L)``."""
    sk, off, L = state.sk, state.offset, A_L.shape[2]
    state.R[:, :, off : off + L] = _stacked_panel(state, A_L, sk.s_r.cols(off, L),
                                                  sk.omega.cols(off, L))
    state.offset = off + L
    return state


def spsvd_stacked_fold(state: StackedSPSVDState, A_L: torch.Tensor, offset: torch.Tensor,
                       base: int) -> StackedSPSVDState:
    """:func:`spsvd_stacked_update` at a device column offset ``offset`` (a
    0-d int, on the grid of ``L``-wide windows from ``base`` that
    :meth:`~repro_torch.core.sketching.StackedOSNAPSketch.index_windows`
    built for Ω and S_R): the windows are gathered and R's columns written on
    the device (:meth:`~repro_torch.core.sketching.StackedOSNAPSketch.window_at`),
    so no host value is read and one captured CUDA graph folds at every
    offset. ``state.offset`` is not read or advanced: the caller keeps the
    offset (the compressed KV cache's ``eng_len``)."""
    sk, L = state.sk, A_L.shape[2]
    cols = offset + torch.arange(L, device=A_L.device)
    state.R.index_copy_(2, cols, _stacked_panel(state, A_L, sk.s_r.window_at(offset, L, base),
                                                sk.omega.window_at(offset, L, base)))
    return state


def spsvd_stacked_scan(state: StackedSPSVDState, A: torch.Tensor, num_panels: int,
                       panel: int) -> StackedSPSVDState:
    """``num_panels`` panels of the full stacked operand ``A`` (N, m, ≥
    offset + num_panels·panel) at the state's offset (the counterpart of
    :func:`~repro_torch.stream.engine.scan_panels`). The Ω and S_R windows
    of the panel grid are indexed once, before the first panel."""
    base = state.offset % panel
    state.sk.omega.index_windows(panel, base)
    state.sk.s_r.index_windows(panel, base)
    for _ in range(num_panels):
        off = state.offset
        spsvd_stacked_update(state, A[:, :, off : off + panel])
    return state


def spsvd_stacked_finalize(state: StackedSPSVDState, k: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`spsvd_engine_finalize` of every head: ``(U (N, m, k), Σ (N, k),
    V (N, n, k))``, through batched QR, the batched sketched core solve and
    a batched SVD."""
    sk = state.sk
    R = state.R[:, :, : state.n]
    dt = torch.promote_types(state.C.dtype, torch.float32)
    U_C, _ = torch.linalg.qr(state.C.to(dt))  # (N, m, c)
    V_R, _ = torch.linalg.qr(R.transpose(1, 2).to(dt))  # (N, n, r)
    ScU = sk.s_c.apply(U_C.to(state.C.dtype)).to(dt)  # (N, s_c, c)
    SrV = sk.s_r.apply(V_R.to(state.C.dtype)).to(dt)  # (N, s_r, r)
    core = fast_gmr_core(ScU, state.M.to(dt), SrV.transpose(1, 2))
    U_N, S, V_Nt = torch.linalg.svd(core, full_matrices=False)
    U = U_C @ U_N
    V = V_R @ V_Nt.transpose(1, 2)
    if k is not None:
        U, S, V = U[..., :k], S[..., :k], V[..., :k]
    return U, S, V
