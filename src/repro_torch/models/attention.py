"""Attention forward passes: GQA with RoPE'd inputs, full-causal and
sliding-window (counterpart of ``repro/models/attention.py``).

* :func:`flash_attention` — the prefill forward. On a CUDA tensor it calls
  ``torch.nn.functional.scaled_dot_product_attention`` (the reference
  computes attention in plain XLA, outside any Pallas kernel); on the CPU,
  or inside :func:`plain_attention`, it runs :func:`flash_attention_plain`,
  the reference's block-online-softmax evaluation restated in plain
  PyTorch, which the tests hold against the reference and
  ``chip_smoke.py`` holds SDPA against on the card.
* :func:`attention_train` — the training forward, by the reference's
  ``impl``: on a CUDA tensor both impls are SDPA, whose backward autograd
  takes; on the CPU, or inside :func:`plain_attention`, ``"custom_vjp"``
  is :func:`flash_attention_vjp` (the reference's flash forward, which
  saves only q, k, v, the output and the log-sum-exp, and its blockwise
  backward, ``_flash_fwd_impl`` / ``_flash_bwd_impl``, as a
  ``torch.autograd.Function``) and ``"scan_ad"`` autograd through
  :func:`flash_attention_plain`.
* :func:`decode_attention` — one query against a cache with a length mask,
  fp32 softmax, as the reference; against a sequence-sharded cache, the
  rank's block combined over the data axes.
* :func:`cross_attention` — queries against modality K/V, no mask (the
  reference's ``_cross_attend`` core): SDPA on a CUDA tensor,
  :func:`cross_attention_plain`, the reference's einsums, on the CPU or
  inside :func:`plain_attention`.

A ``meta`` tensor takes the card's route: the cuDNN SDPA op the card
dispatches, called directly (a census of a dry run counts one fused op,
never the (B, H, S, S) scores of SDPA's math route).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.distributed as dist

NEG_INF = -1e30

_PLAIN = False


@contextlib.contextmanager
def plain_attention():
    """Within the block, CUDA tensors take the plain paths too
    (:func:`flash_attention_plain`, :func:`cross_attention_plain`)."""
    global _PLAIN
    prev, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = prev


def _block_pairs(nbq: int, window_blocks: Optional[int]):
    """The lower-triangle (i, j) block pairs (window-restricted), in the
    reference's order, with the first and last pair of each query block."""
    pairs = []
    for i in range(nbq):
        j_lo = 0 if window_blocks is None else max(0, i - window_blocks)
        for j in range(j_lo, i + 1):
            pairs.append((i, j, j == j_lo, j == i))
    return pairs


def flash_attention_plain(q, k, v, *, window: Optional[int] = None, chunk: int = 512):
    """The reference's block-triangular online-softmax attention.

    q: (B, S, H, D); k, v: (B, S, KV, D) with H % KV == 0 (query heads
    grouped per KV head, KV never repeated). Scores and the running
    max/sum in fp32, ``p`` cast to ``v``'s dtype for the value product, as
    the reference. Returns (B, S, H, Dv) in q's dtype.
    """
    B, S, H, D = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    Sp = S + pad
    wb = None if window is None else (window + c - 1) // c
    qg = q.reshape(B, Sp, KV, G, D)
    out = torch.zeros((B, Sp, H, Dv), dtype=torch.float32, device=q.device)
    ar = torch.arange(c, device=q.device)
    m = l = acc = None
    for i, j, new, last in _block_pairs(Sp // c, wb):
        qi = qg[:, i * c : (i + 1) * c]
        kj = k[:, j * c : (j + 1) * c]
        vj = v[:, j * c : (j + 1) * c]
        s = torch.einsum("bqkgd,bpkd->bkgqp", qi, kj).float() * scale
        qpos, kpos = i * c + ar, j * c + ar
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        mask &= (kpos < S)[None, :]
        s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
        if new:  # the stats restart at each query block's first kv block
            m = torch.full((B, KV, G, c), NEG_INF, device=q.device)
            l = torch.zeros((B, KV, G, c), device=q.device)
            acc = torch.zeros((B, KV, G, c, Dv), device=q.device)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgqp,bpkd->bkgqd", p.to(v.dtype), vj).float()
        acc = acc * alpha[..., None] + pv
        m = m_new
        if last:
            blk = acc / torch.clamp(l, min=1e-37)[..., None]
            out[:, i * c : (i + 1) * c] = blk.permute(0, 3, 1, 2, 4).reshape(B, c, H, Dv)
    return out[:, :S].to(q.dtype)


def _on_card(q) -> bool:
    # the card's route: CUDA, or ``meta`` (a census counts the card's ops)
    return (q.is_cuda or q.is_meta) and not _PLAIN


def _sdpa_op(qt, kt, vt, *, mask=None, causal=False):
    """SDPA on (B, H, S, D) operands, GQA through ``enable_gqa`` (KV heads
    not repeated). On ``meta`` the cuDNN op the card dispatches, called
    directly: ``scaled_dot_product_attention`` would take its math route
    there and build the (B, H, S, S) scores."""
    gqa = qt.shape[1] != kt.shape[1]
    if qt.is_meta:
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (qt, kt, vt))
        return torch.ops.aten._scaled_dot_product_cudnn_attention(
            qt, kt, vt, mask, grad, 0.0, causal, False)[0]
    return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                            is_causal=causal, enable_gqa=gqa)


def _sdpa(q, k, v, window: Optional[int]):
    # SDPA wants (B, H, S, D)
    S = q.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        o = _sdpa_op(qt, kt, vt, causal=True)
    else:
        pos = torch.arange(S, device=q.device)
        diff = pos[:, None] - pos[None, :]
        o = _sdpa_op(qt, kt, vt, mask=(diff >= 0) & (diff < window))
    return o.transpose(1, 2)


def flash_attention(q, k, v, *, window: Optional[int] = None, chunk: int = 512):
    """Causal (optionally sliding-window) attention, (B, S, H, D) in and out:
    SDPA on a CUDA tensor, :func:`flash_attention_plain` on the CPU or
    inside :func:`plain_attention`."""
    if _on_card(q):
        return _sdpa(q, k, v, window)
    return flash_attention_plain(q, k, v, window=window, chunk=chunk)


def _pad_qkv(q, k, v, c: int):
    pad = (-q.shape[1]) % c
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    return q, k, v, pad


def _pair_mask(i: int, j: int, c: int, S: int, window: Optional[int], device):
    ar = torch.arange(c, device=device)
    qpos, kpos = i * c + ar, j * c + ar
    mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask & (kpos < S)[None, :]


def _flash_fwd_impl(q, k, v, window: Optional[int], chunk: int):
    """The flash forward with its log-sum-exp: out (B, S, H, Dv) in q's
    dtype, lse (B, KV, G, S) fp32 (the reference's ``_flash_fwd_impl``)."""
    B, S0, H, D = q.shape
    c = min(chunk, S0)
    q, k, v, pad = _pad_qkv(q, k, v, c)
    Sp = S0 + pad
    KV, Dv = k.shape[2], v.shape[3]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    wb = None if window is None else (window + c - 1) // c
    qg = q.reshape(B, Sp, KV, G, D)
    out = torch.zeros((B, Sp, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.zeros((B, KV, G, Sp), dtype=torch.float32, device=q.device)
    m = l = acc = None
    for i, j, new, last in _block_pairs(Sp // c, wb):
        qi, kj, vj = qg[:, i * c : (i + 1) * c], k[:, j * c : (j + 1) * c], v[:, j * c : (j + 1) * c]
        s = torch.einsum("bqkgd,bpkd->bkgqp", qi, kj).float() * scale
        s = torch.where(_pair_mask(i, j, c, S0, window, q.device), s,
                        torch.full((), NEG_INF, device=s.device))
        if new:
            m = torch.full((B, KV, G, c), NEG_INF, device=q.device)
            l = torch.zeros((B, KV, G, c), device=q.device)
            acc = torch.zeros((B, KV, G, c, Dv), device=q.device)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgqp,bpkd->bkgqd", p.to(v.dtype), vj).float()
        acc = acc * alpha[..., None] + pv
        m = m_new
        if last:
            blk = acc / torch.clamp(l, min=1e-37)[..., None]
            out[:, i * c : (i + 1) * c] = blk.permute(0, 3, 1, 2, 4).reshape(B, c, H, Dv).to(out.dtype)
            lse[..., i * c : (i + 1) * c] = m + torch.log(torch.clamp(l, min=1e-37))
    return out[:, :S0], lse[..., :S0]


def _flash_bwd_impl(q, k, v, out, lse, dout, window: Optional[int], chunk: int):
    """The reference's ``_flash_bwd_impl``: p recomputed per block pair from
    the saved lse; dq, dk, dv accumulated in fp32, returned in the inputs'
    dtypes."""
    B, S0, H, D = q.shape
    c = min(chunk, S0)
    q, k, v, pad = _pad_qkv(q, k, v, c)
    Sp = S0 + pad
    KV, Dv = k.shape[2], v.shape[3]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    wb = None if window is None else (window + c - 1) // c
    if pad:
        out, dout = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (out, dout))
        lse = torch.nn.functional.pad(lse, (0, pad))
    qg = q.reshape(B, Sp, KV, G, D)
    dog = dout.reshape(B, Sp, KV, G, Dv)
    Dvec = torch.einsum("bskgd,bskgd->bkgs", dog.float(), out.reshape(B, Sp, KV, G, Dv).float())
    dq = torch.zeros((B, Sp, KV, G, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Sp, KV, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, Sp, KV, Dv), dtype=torch.float32, device=q.device)
    for i, j, _, _ in _block_pairs(Sp // c, wb):
        qs, ks = slice(i * c, (i + 1) * c), slice(j * c, (j + 1) * c)
        qi, kj, vj, doi = qg[:, qs], k[:, ks], v[:, ks], dog[:, qs]
        s = torch.einsum("bqkgd,bpkd->bkgqp", qi, kj).float() * scale
        s = torch.where(_pair_mask(i, j, c, S0, window, q.device), s,
                        torch.full((), NEG_INF, device=s.device))
        p = torch.exp(s - lse[..., qs, None])
        dp = torch.einsum("bqkgd,bpkd->bkgqp", doi, vj).float()
        ds = p * (dp - Dvec[..., qs, None]) * scale
        dv[:, ks] += torch.einsum("bkgqp,bqkgd->bpkd", p.to(doi.dtype), doi).float()
        dq[:, qs] += torch.einsum("bkgqp,bpkd->bqkgd", ds.to(kj.dtype), kj).float()
        dk[:, ks] += torch.einsum("bkgqp,bqkgd->bpkd", ds.to(qi.dtype), qi).float()
    return (dq.reshape(B, Sp, H, D)[:, :S0].to(q.dtype), dk[:, :S0].to(k.dtype),
            dv[:, :S0].to(v.dtype))


class _FlashVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, chunk):
        out, lse = _flash_fwd_impl(q, k, v, window, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.chunk = window, chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd_impl(q, k, v, out, lse, dout, ctx.window, ctx.chunk), None, None)


def flash_attention_vjp(q, k, v, window: Optional[int] = None, chunk: int = 512):
    """Causal (windowed) attention whose backward is the flash backward: the
    reference's ``custom_vjp`` route, in plain PyTorch (the CPU's route of
    :func:`attention_train`)."""
    return _FlashVJP.apply(q, k, v, window, chunk)


def attention_train(q, k, v, *, window: Optional[int] = None, chunk: int = 512,
                    impl: str = "scan_ad"):
    """The training attention (B, S, H, D) in and out: SDPA and its backward
    on a CUDA tensor (either ``impl``); on the CPU or inside
    :func:`plain_attention`, :func:`flash_attention_vjp` for
    ``impl="custom_vjp"``, else autograd through :func:`flash_attention_plain`."""
    if _on_card(q):
        return _sdpa(q, k, v, window)
    if impl == "custom_vjp":
        return flash_attention_vjp(q, k, v, window, chunk)
    return flash_attention_plain(q, k, v, window=window, chunk=chunk)


def decode_attention(q, k_cache, v_cache, length, *, window: Optional[int] = None,
                     start=0, group=None):
    """One-token attention against a cache.

    q: (B, 1, H, D); caches: (B, Smax, KV, D); ``length`` tokens valid (a
    0-d int on the device, or a number): the mask is formed on the device,
    so nothing is read back. fp32 softmax; the value product in the cache's
    dtype.

    A sequence-sharded cache (``group``, the data axes' group of
    :func:`~repro_torch.distributed.sharding.seq_cut`): the caches are this
    rank's block of the positions, its first slot at global position
    ``start``, and the mask reads global positions. The ranks combine as
    the reference's partitioner does for its sharded softmax: the fp32 row
    max all-reduced (MAX), the row sum of ``exp(s − max)`` all-reduced
    (SUM), each rank's normalised ``p`` cast to v's dtype for its partial
    value product, kept in fp32 (:func:`_partial_values`), the partial
    outputs summed (SUM) and cast to v's dtype: three small collectives,
    (B, KV, G) and (B, KV, G, D). A block that is wholly masked gives 0
    (its ``exp`` underflows against the finite global max). Only the order
    of the sums differs from one rank's.
    """
    B, _, H, D = q.shape
    KV, Dv, Smax = k_cache.shape[2], v_cache.shape[3], k_cache.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bpkd->bkgp", qg, k_cache).float() * scale
    pos = torch.arange(Smax, device=q.device)
    if start:  # a sequence-sharded block's global positions
        pos = pos + start
    mask = pos < length
    if window is not None:
        mask &= pos >= (length - window)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    if group is None:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgp,bpkd->bkgd", p.to(v_cache.dtype), v_cache)
        return o.reshape(B, 1, H, Dv)
    m = s.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(s - m)
    total = e.sum(dim=-1, keepdim=True)
    dist.all_reduce(total, group=group)
    o = _partial_values((e / total).to(v_cache.dtype), v_cache)
    dist.all_reduce(o, group=group)
    return o.to(v_cache.dtype).reshape(B, 1, H, Dv)


def _partial_values(p, v):
    """``p`` (B, KV, G, P) in v's dtype times ``v`` (B, P, KV, D), summed
    over the positions in fp32: (B, KV, G, D) fp32. A bf16 product keeps its
    fp32 sums (one ``bmm`` with an fp32 output on the card, the same
    products upcast on the CPU), so the only rounding to v's dtype is the
    one after the combine, as one rank's product rounds once."""
    B, KV, G, P = p.shape
    pb = p.reshape(B * KV, G, P)
    vt = v.permute(0, 2, 1, 3).reshape(B * KV, P, v.shape[-1])
    if v.dtype == torch.float32:
        o = torch.bmm(pb, vt)
    elif v.device.type == "cpu":
        o = torch.bmm(pb.float(), vt.float())
    else:
        o = torch.bmm(pb, vt, out_dtype=torch.float32)
    return o.reshape(B, KV, G, -1)


def cross_attention_plain(q, k, v):
    """The reference's cross-attention core: q (B, S, H, D) against k, v
    (B, P, KV, D), query head h reading kv head h // (H/KV); fp32 scores
    and softmax, ``p`` cast to v's dtype for the value product. Returns
    (B, S, H, D) in v's dtype."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, D)
    s = torch.einsum("bqkgd,bpkd->bkgqp", qg, k).float() / math.sqrt(D)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqp,bpkd->bqkgd", p.to(v.dtype), v).reshape(B, S, H, D)


def cross_attention(q, k, v):
    """Unmasked attention of q (B, S, H, D) over k, v (B, P, KV, D): SDPA
    on a CUDA tensor (GQA through ``enable_gqa``, the same head grouping),
    :func:`cross_attention_plain` on the CPU or inside
    :func:`plain_attention`."""
    if _on_card(q):
        return _sdpa_op(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    return cross_attention_plain(q, k, v)


__all__ = ["NEG_INF", "attention_train", "cross_attention", "cross_attention_plain",
           "decode_attention", "flash_attention", "flash_attention_plain", "flash_attention_vjp",
           "plain_attention"]
