"""Streaming low-rank KV-cache compression via Fast SP-SVD (paper Alg. 3;
counterpart of ``repro/serve/kv_compress.py``).

The K (and V) history of an attention head is a tall matrix H ∈ R^{S×d}.
Prefill streams Hᵀ through Algorithm 3's panel loop (one pass) and keeps
rank-r factors ``H ≈ V_s Σ Uᵀ`` (V_s ∈ R^{S×r}, U ∈ R^{d×r}); decode
attends in factor space (:func:`lowrank_decode_attention`).

The reference's memory model says (S+d)·r against S·d floats per head,
"d/r×"; counted honestly (the engine state the decode path carries, its
sketches and the recent window), the compressed cache is larger than the
dense one at head_dim 64 (``PERF.md`` §6).

A head batch runs as one stacked Algorithm-3 state over all B·KV heads
(:func:`~repro_torch.core.svd.spsvd_stacked_init`, the counterpart of the
reference's ``vmap`` over (batch, kv-head)): every OSNAP apply of a panel
is one launch of kernel 1 for the whole batch. Adaptive per-head rank
(``KVCompressionConfig(adaptive=True)``) spends the shared ``KV·rank``
budget per request greedily on the heads with the heaviest spectra, as
:func:`~repro_torch.stream.adaptive.allocate_shared_budget` does.

Randomness: the engines draw their sketches from a ``torch.Generator``, or
take pre-drawn stacked sketches (parity tests hand the reference's across
with :func:`repro_torch.convert.stacked_spsvd_sketches`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core.svd import (StackedSPSVDSketches, spsvd_engine_finalize, spsvd_engine_init,
                        spsvd_stacked_finalize, spsvd_stacked_init, spsvd_stacked_scan,
                        spsvd_stacked_sketches, spsvd_stacked_update)
from ..device import DeviceLike
from ..obs.metrics import MetricsRegistry, default_registry
from ..obs.spans import span
from ..stream.engine import stream_panels

__all__ = ["KVCompressionConfig", "LowRankKV", "compress_history", "compress_head_batch",
           "lowrank_decode_attention", "compression_error"]


@dataclasses.dataclass(frozen=True)
class KVCompressionConfig:
    """Static configuration of the KV compressor.

    ``rank``/``oversample``/``panel`` govern prefill compression; the
    remaining fields govern the decode-native path
    (:mod:`repro_torch.serve.kv_cache`) and adaptive per-head rank.
    """

    rank: int = 16
    oversample: int = 4  # c = r = oversample·rank for the Alg. 3 sketches
    panel: int = 1024  # prefill streaming panel (tokens)
    decode_panel: int = 64  # decode-native fold width (generated tokens)
    refresh_every: int = 256  # refactorize after this many folded tokens
    adaptive: bool = False  # per-head rank from a shared KV·rank budget
    min_rank: int = 4  # adaptive floor per head
    max_rank: Optional[int] = None  # adaptive cap per head (default 2·rank)

    def __post_init__(self):
        """Validate the decode/adaptive schedule at construction time."""
        if self.refresh_every % self.decode_panel:
            raise ValueError(
                f"refresh_every={self.refresh_every} must be a multiple of "
                f"decode_panel={self.decode_panel} (refresh fires on fold boundaries)"
            )
        if self.adaptive and self.min_rank > self.rank:
            raise ValueError(
                f"adaptive floor min_rank={self.min_rank} exceeds the per-head "
                f"budget share rank={self.rank}"
            )


@dataclasses.dataclass
class LowRankKV:
    """Factors per head (batch): H ≈ V_s diag(sigma) Uᵀ."""

    v_s: torch.Tensor  # (..., S, r)
    sigma: torch.Tensor  # (..., r)
    u: torch.Tensor  # (..., d, r)


def _sizes(d: int, kc: KVCompressionConfig) -> dict:
    # c is capped by the source dim d, but the GMR sketches stay strictly
    # larger than c (a square sketch destroys the core solve)
    c = min(d, kc.oversample * kc.rank)
    return dict(c=c, r=c, c0=2 * c, r0=2 * c, s_c=3 * c, s_r=3 * c)


def _fac_width(d: int, kc: KVCompressionConfig) -> int:
    # stored factor width: the uniform rank, or the adaptive cap (the
    # budget is enforced by masking sigma, see _allocate_ranks)
    c = _sizes(d, kc)["c"]
    if not kc.adaptive:
        return min(c, kc.rank)
    cap = kc.max_rank if kc.max_rank is not None else 2 * kc.rank
    return min(c, cap)


# OSNAP with p = 4: at KV head dims the inner S_C/S_R must embed all of R^d;
# p = 2 leaves ~10% odds of a double collision annihilating a direction
OSNAP_P = 4


def _engine_init(gen, d: int, n_cols: int, kc: KVCompressionConfig, *, panel=None,
                 sketches=None, device: DeviceLike = None):
    return spsvd_engine_init(gen, d, n_cols, sizes=_sizes(d, kc), dtype=torch.float32,
                             osnap_p=OSNAP_P, panel=panel, sketches=sketches, device=device)


def _stacked_init(gen, N: int, d: int, n_cols: int, kc: KVCompressionConfig, *,
                  sketches: Optional[StackedSPSVDSketches] = None, device: DeviceLike = None):
    return spsvd_stacked_init(gen, N, d, n_cols, sizes=_sizes(d, kc), dtype=torch.float32,
                              osnap_p=OSNAP_P, sketches=sketches, device=device)


def _stacked_sketches(gen, N: int, d: int, n_cols: int,
                      kc: KVCompressionConfig) -> StackedSPSVDSketches:
    """The sketches :func:`_stacked_init` would draw for N heads, alone."""
    return spsvd_stacked_sketches(gen, N, d, n_cols, sizes=_sizes(d, kc), dtype=torch.float32,
                                  osnap_p=OSNAP_P)


def _stream_stack(state, hist_T: torch.Tensor, length: int, kc: KVCompressionConfig):
    """Scan the whole panels of ``hist_T`` (N, d, ≥ length) from column 0,
    then fold the ragged tail ``[n_full·panel, length)`` as one exact panel
    of its own width (the reference's ``_compress_core``)."""
    panel = min(kc.panel, length)
    n_full = length // panel
    if n_full:
        spsvd_stacked_scan(state, hist_T, n_full, panel)
        state.sk.omega._windows.pop((panel, 0), None)  # the prefill grid is done with
        state.sk.s_r._windows.pop((panel, 0), None)
    if length % panel:
        spsvd_stacked_update(state, hist_T[:, :, n_full * panel : length])
    return state


def compress_history(gen: Optional[torch.Generator], hist: torch.Tensor,
                     kc: KVCompressionConfig, *, sketches=None) -> LowRankKV:
    """hist: (S, d), one head's K or V history → rank-r factors, one pass:
    ``histᵀ`` (d, S) through the per-head engine's :func:`stream_panels`
    (ragged tail zero-padded), finalized at the stored factor width.
    ``sketches`` are the engine's pre-drawn :class:`~repro_torch.core.svd.SPSVDSketches`."""
    S, d = hist.shape
    panel = min(kc.panel, S)
    state = _engine_init(gen, d, S, kc, panel=panel, sketches=sketches, device=hist.device)
    with span("serve/kv_compress/prefill"):
        state = stream_panels(state, hist.T.float(), panel)
    with span("serve/kv_compress/finalize"):
        U, sig, V = spsvd_engine_finalize(state, k=_fac_width(d, kc))
    return LowRankKV(v_s=V, sigma=sig, u=U)


def _allocate_ranks(sigma: torch.Tensor, kc: KVCompressionConfig):
    """The shared budget ``KV·rank`` of each request spent on the σ²
    marginals (descending per head): :func:`allocate_shared_budget` for
    every request at once (ties to the lower flat index, dead marginals
    never bought). Returns the masked sigma and the (B, KV) ranks."""
    B, KV, fw = sigma.shape
    floor, cap = min(kc.min_rank, fw), fw
    extra = KV * kc.rank - KV * floor
    if extra < 0:
        raise ValueError(f"budget {KV * kc.rank} cannot cover floor {floor} x {KV} heads")
    alloc = torch.full((B, KV), floor, dtype=torch.int32, device=sigma.device)
    W = cap - floor
    if W and extra:
        window = (sigma * sigma)[:, :, floor:cap].reshape(B, KV * W)
        # the best marginals first, ties to the lower flat (head-major) index
        vals, idx = torch.sort(window, dim=-1, descending=True, stable=True)
        k = min(extra, KV * W)
        picks = (vals[:, :k] > 0).to(torch.int32)  # dead marginals are never bought
        alloc.scatter_add_(1, idx[:, :k] // W, picks)
    keep = torch.arange(fw, device=sigma.device) < alloc[:, :, None]
    return torch.where(keep, sigma, torch.zeros((), device=sigma.device)), alloc


def _factors(U, sig, V, B: int, KV: int) -> LowRankKV:
    """Stacked (B·KV, ...) factors as (B, KV, ...)."""
    return LowRankKV(v_s=V.reshape(B, KV, *V.shape[1:]), sigma=sig.reshape(B, KV, -1),
                     u=U.reshape(B, KV, *U.shape[1:]))


def compress_head_batch(gen: Optional[torch.Generator], hist: torch.Tensor,
                        kc: KVCompressionConfig, *, registry: Optional[MetricsRegistry] = None,
                        sketches: Optional[StackedSPSVDSketches] = None) -> LowRankKV:
    """hist: (B, KV, S, d) → factors (B, KV, ...), one stacked engine over
    the B·KV heads (row-major over (batch, kv-head)), so each OSNAP apply of
    a panel is one launch of kernel 1 whatever B·KV is. With
    ``kc.adaptive`` each head's rank comes from its request's shared
    ``KV·rank`` budget by zeroing the tail of its ``sigma`` (factors stored
    at the ``max_rank`` width). With an enabled registry (``registry=`` or
    the process default) the ``serve/kv_rel_err`` histogram (one error per
    head), ``serve/kv_compression_ratio``, ``serve/kv_heads_compressed``
    and, adaptive, ``serve/kv_head_rank`` are recorded with one transfer."""
    reg = registry if registry is not None else default_registry()
    B, KV, S, d = hist.shape
    ranks = None
    with span("serve/kv_compress/head_batch", reg):
        state = _stacked_init(gen, B * KV, d, S, kc, sketches=sketches, device=hist.device)
        _stream_stack(state, hist.reshape(B * KV, S, d).transpose(1, 2).float(), S, kc)
        fac = _factors(*spsvd_stacked_finalize(state, k=_fac_width(d, kc)), B, KV)
        if kc.adaptive:
            sigma, ranks = _allocate_ranks(fac.sigma, kc)
            fac = LowRankKV(v_s=fac.v_s, sigma=sigma, u=fac.u)
    if reg.enabled:
        r = fac.sigma.shape[-1]
        reg.record_kv_compression(compression_error(hist, fac), ratio=(S * d) / ((S + d + 1) * r),
                                  ranks=ranks)
    return fac


def lowrank_decode_attention(q: torch.Tensor, k_fac: LowRankKV, v_fac: LowRankKV,
                             length: int) -> torch.Tensor:
    """q: (B, KV, G, d) grouped queries; factors (B, KV, ...). Returns (B, KV, G, d)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    uq = torch.einsum("bkdr,bkgd->bkgr", k_fac.u, q.float()) * k_fac.sigma[:, :, None, :]
    s = torch.einsum("bksr,bkgr->bkgs", k_fac.v_s, uq) * scale  # (B, KV, G, S)
    mask = torch.arange(s.shape[-1], device=q.device) < length
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    pv = torch.einsum("bkgs,bksr->bkgr", p, v_fac.v_s) * v_fac.sigma[:, :, None, :]
    return torch.einsum("bkgr,bkdr->bkgd", pv, v_fac.u)


def compression_error(hist: torch.Tensor, fac: LowRankKV) -> torch.Tensor:
    """Relative Frobenius reconstruction error of each head's factors:
    ``hist`` (..., S, d) against ``fac`` (...): a 0-dim tensor for one head,
    (...) for a batch."""
    rec = (fac.v_s * fac.sigma[..., None, :]) @ fac.u.transpose(-1, -2)
    h = hist.float()
    num = torch.linalg.vector_norm(h - rec, dim=(-2, -1))
    return num / torch.clamp(torch.linalg.vector_norm(h, dim=(-2, -1)), min=1e-30)

