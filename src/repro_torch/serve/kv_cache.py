"""Decode-native compressed KV cache: the panel engine carried through
decode (counterpart of ``repro/serve/kv_cache.py``).

Each converted attention layer's cache is a :class:`CompressedKV` holding,
for its B·KV heads (row-major over (batch, kv-head)):

* the stacked Algorithm-3 engine state
  (:class:`~repro_torch.core.svd.StackedSPSVDState`) that has consumed every
  token up to ``eng_len``;
* the last finalized factors ``H ≈ V_s Σ Uᵀ`` covering ``fac_len`` tokens;
* a dense *recent* window ``(B, refresh_every, KV, hd)`` holding the
  tokens newer than ``fac_len`` exactly.

Every decoded token is appended to the recent window; once
``decode_panel`` tokens are pending past ``eng_len`` they are folded into
the engine as one panel of every head (one launch of kernel 1 per OSNAP
apply for the layer's whole head batch), and once ``refresh_every`` tokens
have accumulated past ``fac_len`` the engine is refactorized and the recent
window reset. Attention is exact over the recent window and rank-r over
the prefix, with one joint softmax across both score blocks.

The reference gates the fold and the refresh with ``lax.cond`` on device
ints inside its one compiled step. The port keeps ``length``, ``eng_len``
and ``fac_len`` as 0-d int32 tensors on the device too: the recent slot,
the fold's window (its start ``eng_len − fac_len`` in the recent window,
its engine columns at ``eng_len``) and the attention masks are read there.
Whether a step folds or refreshes depends only on how many tokens were
decoded, so the host knows it in advance (:func:`decode_schedule`) and
tells each step its phase; it reads no value back. Every tensor updates in
place (the refreshed factors are written into the old ones), so a decode
step captured in a CUDA graph stays valid: ``generate`` replays one graph
for the plain steps and one for the folds (kernel 1's stacked launches
inside it), and runs the refresh steps eagerly, on the card — the
finalize's ``torch.linalg.svd`` waits for the host.

A scanned segment's layers (the reference's ``n_repeat`` axis) convert
together as one stack of ``n_repeat·B·KV`` heads; each layer's cache then
holds views of its heads (``StackedSPSVDState.items``), and the window
orders of the decode folds are built once per cache, on the grid of
``decode_panel`` windows that starts at the prompt's length.

Under a mesh (:func:`~repro_torch.distributed.activation_sharding`) a
rank's cache holds its rows of the batch and its KV heads: ``B/d`` and
``KV/m`` of them. Every rank draws the sketches of the whole stack of
``R·B·KV`` heads (or takes them whole through ``sketches=``) and keeps its
block, so its generator advances as the one-rank run's does and each of
its heads gets that run's sketch; kernel 1's stacked launch then runs on
the rank's ``R·(B/d)·(KV/m)`` heads. Adaptive rank spends each request's
``KV·rank`` budget over all its KV heads: at model axis ``m > 1`` σ is
gathered over the model axis, allocated whole, and each rank keeps its
heads' ranks, at conversion and at every refresh. The data axis needs
nothing: the budget is per request.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core.svd import (StackedSPSVDSketches, StackedSPSVDState, spsvd_stacked_finalize,
                        spsvd_stacked_fold)
from ..device import DeviceLike, resolve_device
from ..distributed.sharding import dp_index, gather_tp, seq_group, tp_index
from ..models.blocks import FOLD, PLAIN, REFRESH
from ..models.config import ATTN, ModelConfig
from ..models.transformer import segments
from ..obs.metrics import MetricsRegistry, default_registry
from ..obs.spans import span
from .kv_compress import (KVCompressionConfig, LowRankKV, _allocate_ranks, _fac_width, _factors,
                          _stacked_init, _stacked_sketches, _stream_stack)

__all__ = ["CompressedKV", "cache_nbytes", "compress_prefill_cache", "decode_schedule",
           "init_compressed_kv"]


@dataclasses.dataclass
class CompressedKV:
    """One layer's compressed KV cache.

    Invariants: ``fac_len <= eng_len <= length``; tokens ``[0, fac_len)``
    are represented by ``k_fac``/``v_fac``; tokens ``[fac_len, length)``
    sit densely in ``recent_*`` at slot ``pos - fac_len``; tokens
    ``[0, eng_len)`` have been folded into ``k_eng``/``v_eng``;
    ``eng_len - fac_len`` is a multiple of ``decode_panel`` below
    ``refresh_every``. The engines' own ``offset`` stays where the
    conversion left it: decode folds at ``eng_len``.
    """

    k_eng: StackedSPSVDState  # B·KV heads
    v_eng: StackedSPSVDState
    k_fac: LowRankKV  # v_s (B, KV, n_max, fw), sigma (B, KV, fw), u (B, KV, hd, fw)
    v_fac: LowRankKV
    recent_k: torch.Tensor  # (B, refresh_every, KV, hd), model dtype
    recent_v: torch.Tensor
    fac_len: torch.Tensor  # () int32 — tokens covered by the factors
    eng_len: torch.Tensor  # () int32 — tokens folded into the engines
    base: int  # the column where the folds' window grid starts (the prompt's end)
    kc: KVCompressionConfig

    def append_attend(self, q, k, v, length: torch.Tensor, phase: str = PLAIN):
        """Append one decoded token and attend against the full history.

        ``q``: (B, 1, H, hd) RoPE'd queries; ``k``/``v``: (B, 1, KV, hd)
        the new token's projections; ``length``: tokens already cached (a
        0-d int on the device); ``phase``: :data:`PLAIN`, :data:`FOLD`
        (``decode_panel`` tokens are pending: fold them) or :data:`REFRESH`
        (fold, then refactorize), from :func:`decode_schedule`. Returns
        ``o`` (B, 1, H, hd), the contract of
        :func:`~repro_torch.models.attention.decode_attention`; the cache is
        updated in place.
        """
        slot = (length - self.fac_len).reshape(1).long()
        self.recent_k.index_copy_(1, slot, k.to(self.recent_k.dtype))
        self.recent_v.index_copy_(1, slot, v.to(self.recent_v.dtype))
        if phase != PLAIN:
            self._fold(refresh=phase == REFRESH)
        return _attend(self, q, length + 1)

    def _fold(self, refresh: bool) -> None:
        # fold the decode_panel pending tokens [eng_len, eng_len + dp) into
        # both engines, every head at once; then, at a refresh step,
        # refactorize (refresh_every tokens past the factors)
        dp = self.kc.decode_panel
        B, _, KV, hd = self.recent_k.shape
        win = (self.eng_len - self.fac_len) + torch.arange(dp, device=self.recent_k.device)
        for recent, eng in ((self.recent_k, self.k_eng), (self.recent_v, self.v_eng)):
            A_L = recent.index_select(1, win).permute(0, 2, 3, 1).reshape(B * KV, hd, dp)
            spsvd_stacked_fold(eng, A_L.float(), self.eng_len, self.base)
        self.eng_len.add_(dp)
        if refresh:
            self._refresh()

    def _refresh(self) -> None:
        # the new factors, written over the old ones, cover everything the
        # engines have seen; the recent window restarts empty at the new fac_len
        fw = self.k_fac.sigma.shape[-1]
        B, _, KV, _ = self.recent_k.shape
        for eng, fac in ((self.k_eng, self.k_fac), (self.v_eng, self.v_fac)):
            new = _finalize_heads(eng, self.kc, fw, B, KV)
            for name in ("v_s", "sigma", "u"):
                getattr(fac, name).copy_(getattr(new, name))
        self.recent_k.zero_()
        self.recent_v.zero_()
        self.fac_len.copy_(self.eng_len)


def decode_schedule(kc: Optional[KVCompressionConfig], n_steps: int) -> list:
    """Each of ``n_steps`` decode steps from a freshly converted cache
    (``fac_len = eng_len =`` the prompt's length) as ``(phase, window)``:
    the reference's two ``lax.cond`` gates, decided on the host from the
    step index alone. Step ``j`` appends the ``j+1``-th decoded token; it
    folds when ``decode_panel`` tokens are pending, ``window`` then being
    the fold's start ``eng_len − fac_len`` in the recent window, and
    refreshes when the fold brings ``refresh_every`` tokens past the
    factors. ``kc=None`` (no compressed layer): every step plain."""
    out = []
    for j in range(n_steps):
        n = j + 1  # tokens appended after this step
        if kc is None or n % kc.decode_panel:
            out.append((PLAIN, None))
            continue
        window = (n - kc.decode_panel) % kc.refresh_every
        out.append((REFRESH if n % kc.refresh_every == 0 else FOLD, window))
    return out


def _finalize_heads(eng: StackedSPSVDState, kc: KVCompressionConfig, fw: int, B: int,
                    KV: int) -> LowRankKV:
    # Algorithm-3 finalize of every head at the stored factor width; rows of
    # V past eng_len are zero (QR of zero rows) and masked by fac_len anyway
    fac = _factors(*spsvd_stacked_finalize(eng, k=fw), B, KV)
    if kc.adaptive:
        fac = LowRankKV(v_s=fac.v_s, sigma=_allocate(fac.sigma, kc)[0], u=fac.u)
    return fac


def _allocate(sigma: torch.Tensor, kc: KVCompressionConfig):
    """:func:`~repro_torch.serve.kv_compress._allocate_ranks` of this rank's
    heads' σ (rows, KV/m, fw) over each request's whole set of KV heads: σ
    gathered over the model axis, the budget spent on all of it, this
    rank's block of the masked σ and of the ranks kept."""
    index, _ = tp_index()
    KV = sigma.shape[1]
    masked, alloc = _allocate_ranks(gather_tp(sigma, 1), kc)
    return masked[:, index * KV:(index + 1) * KV], alloc[:, index * KV:(index + 1) * KV]


def _rank_sketches(gen, R: int, B: int, KV: int, hd: int, n_max: int, kc: KVCompressionConfig,
                   sketches: Optional[StackedSPSVDSketches]) -> Optional[StackedSPSVDSketches]:
    """The sketches of this rank's ``R·B·KV`` heads (its ``B`` rows and
    ``KV`` heads) of the whole stack of ``R·(B·d)·(KV·m)`` heads, row-major
    over (repeat, batch, KV head): drawn whole from ``gen`` (or ``sketches``,
    whole) and selected. Outside a mesh, ``sketches`` as given (``None``:
    :func:`~repro_torch.serve.kv_compress._stacked_init` draws them)."""
    di, d = dp_index()
    mi, m = tp_index()
    if d == 1 and m == 1:
        return sketches
    if sketches is None:
        sketches = _stacked_sketches(gen, R * B * d * KV * m, hd, n_max, kc)
    dev = sketches.g_r.device
    r = torch.arange(R, device=dev)[:, None, None]
    b = di * B + torch.arange(B, device=dev)[None, :, None]
    k = mi * KV + torch.arange(KV, device=dev)[None, None, :]
    return sketches.select(((r * (B * d) + b) * (KV * m) + k).reshape(-1))


def _attend(cache: CompressedKV, q, new_len: torch.Tensor):
    # one softmax over the rank-r factor scores (positions below fac_len)
    # and the exact recent scores (positions in [fac_len, new_len)), fp32,
    # cast back to the query's dtype
    B, _, H, hd = q.shape
    W, KV = cache.recent_k.shape[1], cache.recent_k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd).float()
    neg = torch.full((), -1e30, device=q.device)
    kf, vf = cache.k_fac, cache.v_fac
    uq = torch.einsum("bkdr,bkgd->bkgr", kf.u, qg) * kf.sigma[:, :, None, :]
    s_fac = torch.einsum("bksr,bkgr->bkgs", kf.v_s, uq) * scale  # (B, KV, G, n_max)
    n_max = s_fac.shape[-1]
    s_fac = torch.where(torch.arange(n_max, device=q.device) < cache.fac_len, s_fac, neg)
    s_rec = torch.einsum("bkgd,bwkd->bkgw", qg, cache.recent_k.float()) * scale  # (B, KV, G, W)
    s_rec = torch.where(torch.arange(W, device=q.device) < new_len - cache.fac_len, s_rec, neg)
    p = torch.softmax(torch.cat([s_fac, s_rec], dim=-1), dim=-1)
    p_fac, p_rec = p[..., :n_max], p[..., n_max:]
    pv = torch.einsum("bkgs,bksr->bkgr", p_fac, vf.v_s) * vf.sigma[:, :, None, :]
    o = torch.einsum("bkgr,bkdr->bkgd", pv, vf.u)
    o = o + torch.einsum("bkgw,bwkd->bkgd", p_rec, cache.recent_v.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def init_compressed_kv(gen: Optional[torch.Generator], kc: KVCompressionConfig, *, batch: int,
                       n_kv_heads: int, head_dim: int, n_max: int, dtype=torch.float32,
                       sketches: Optional[tuple] = None,
                       device: DeviceLike = None) -> CompressedKV:
    """A fresh empty compressed cache for ``n_max`` tokens: the K engines'
    sketches drawn first, then the V engines' (or ``sketches=(k, v)``
    stacked sketches, heads row-major over (batch, kv-head))."""
    dev = resolve_device(device)
    N = batch * n_kv_heads
    fw = _fac_width(head_dim, kc)
    eng = [_stacked_init(gen, N, head_dim, n_max, kc, device=dev,
                         sketches=None if sketches is None else sketches[half])
           for half in range(2)]
    for e in eng:
        e.sk.omega.index_windows(kc.decode_panel)
        e.sk.s_r.index_windows(kc.decode_panel)
    zero = lambda: LowRankKV(  # noqa: E731
        v_s=torch.zeros((batch, n_kv_heads, n_max, fw), device=dev),
        sigma=torch.zeros((batch, n_kv_heads, fw), device=dev),
        u=torch.zeros((batch, n_kv_heads, head_dim, fw), device=dev))
    recent = lambda: torch.zeros((batch, kc.refresh_every, n_kv_heads, head_dim),  # noqa: E731
                                 dtype=dtype, device=dev)
    count = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
    return CompressedKV(k_eng=eng[0], v_eng=eng[1], k_fac=zero(), v_fac=zero(),
                        recent_k=recent(), recent_v=recent(), fac_len=count(), eng_len=count(),
                        base=0, kc=kc)


def _convert_stack(gen, dense_layers: list, prompt_len: int, kc: KVCompressionConfig,
                   sketches: Optional[tuple]) -> list:
    """Dense ATTN caches of R layers (each K/V (B, n_max, KV, hd), this
    rank's block under a mesh) → one :class:`CompressedKV` per layer, all
    R·B·KV heads streamed as one stack: the first ``prompt_len`` tokens
    scanned and factorized, the engines' column domain the whole ``n_max``,
    so decode keeps appending."""
    R = len(dense_layers)
    B, n_max, KV, hd = dense_layers[0]["k"].shape
    H = B * KV
    fw = _fac_width(hd, kc)
    halves = []
    for half, name in enumerate(("k", "v")):
        hist = torch.stack([c[name] for c in dense_layers])  # (R, B, n_max, KV, hd)
        hist_T = hist.permute(0, 1, 3, 4, 2).reshape(R * H, hd, n_max).float()
        sk = _rank_sketches(gen, R, B, KV, hd, n_max, kc,
                            None if sketches is None else sketches[half])
        state = _stacked_init(gen, R * H, hd, n_max, kc, device=hist.device, sketches=sk)
        _stream_stack(state, hist_T, prompt_len, kc)
        del hist, hist_T
        U, sig, V = spsvd_stacked_finalize(state, k=fw)
        fac = _factors(U, sig, V, R * B, KV)
        if kc.adaptive:
            fac = LowRankKV(v_s=fac.v_s, sigma=_allocate(fac.sigma, kc)[0], u=fac.u)
        # the decode folds' windows: one grid per cache, from the prompt's end
        state.sk.omega.index_windows(kc.decode_panel, prompt_len)
        state.sk.s_r.index_windows(kc.decode_panel, prompt_len)
        halves.append((state, fac))
    out = []
    dt, dev = dense_layers[0]["k"].dtype, dense_layers[0]["k"].device
    for r in range(R):
        views = [(st.items(r * H, (r + 1) * H),
                  LowRankKV(v_s=f.v_s[r * B : (r + 1) * B], sigma=f.sigma[r * B : (r + 1) * B],
                            u=f.u[r * B : (r + 1) * B]))
                 for st, f in halves]
        recent = [torch.zeros((B, kc.refresh_every, KV, hd), dtype=dt, device=dev)
                  for _ in range(2)]
        count = [torch.full((), prompt_len, dtype=torch.int32, device=dev) for _ in range(2)]
        out.append(CompressedKV(k_eng=views[0][0], v_eng=views[1][0], k_fac=views[0][1],
                                v_fac=views[1][1], recent_k=recent[0], recent_v=recent[1],
                                fac_len=count[0], eng_len=count[1], base=prompt_len, kc=kc))
    return out


def compress_prefill_cache(gen: Optional[torch.Generator], cfg: ModelConfig, cache: dict,
                           kc: KVCompressionConfig, *,
                           registry: Optional[MetricsRegistry] = None,
                           sketches: Optional[dict] = None) -> dict:
    """Convert every global-attention (``ATTN``) layer cache of a prefilled
    cache to :class:`CompressedKV`; other mixers' caches pass through, the
    same objects, as the reference's: local rings, MLA latents, Mamba-2
    states, cross K/V and ``SHARED_ATTN`` K/V (zamba2 and mamba2 convert no
    layer).

    The layers of one segment position (a scanned segment's ``n_repeat``
    layers) convert as one stack of heads; stacks go in segment order,
    positions in turn, each drawing its K then its V sketches from ``gen``,
    or taking ``sketches[i] = (k, v)`` (stacked over repeats, batch and
    kv-heads, row-major; the whole batch's and heads' under a mesh, of
    which each rank keeps its block), ``i`` the reference's flat position
    (one per segment position). Returns a new cache dict; the old dense
    caches of converted layers are no longer referenced from it.
    """
    if seq_group() is not None:
        raise NotImplementedError("a compressed cache under the sequence-sharded layout is an "
                                  "open item of ROADMAP.md §1: the dense cache takes seq_shard")
    reg = registry if registry is not None else default_registry()
    prompt_len = int(cache["length"])  # read once, before decode: the engines' column grid
    layers = list(cache["layers"])
    n_conv = 0
    with span("serve/kv_cache/convert", reg):
        li, first = 0, 0
        for seg in segments(cfg):
            for pos, spec in enumerate(seg.unit):
                if spec.mixer == ATTN:
                    idx = [first + rep * len(seg.unit) + pos for rep in range(seg.n_repeat)]
                    conv = _convert_stack(gen, [layers[i] for i in idx], prompt_len, kc,
                                          None if sketches is None else sketches[li])
                    for i, c in zip(idx, conv):
                        layers[i] = c
                    n_conv += len(idx)
                li += 1
            first += seg.n_repeat * len(seg.unit)
    out = {"layers": layers, "length": cache["length"]}
    if reg.enabled:
        reg.inc("serve/kv_layers_converted", n_conv)
        reg.set_gauge("serve/kv_cache_bytes", cache_nbytes(out))
    return out


def _leaves(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            if not f.name.startswith("_"):  # derived indexes (bucket orders) are not state
                yield from _leaves(getattr(x, f.name))


def cache_nbytes(cache) -> int:
    """Bytes of every tensor of a cache: for a :class:`CompressedKV` the
    carried engine state (accumulators and sketches) and the recent window
    as well as the factors — honest accounting, as the reference's. The
    bucket orders built from the sketches are left out (derived, not
    state)."""
    return sum(t.numel() * t.element_size() for t in _leaves(cache))
