"""Mamba-2 SSD (state-space duality) mixer — mamba2-1.3b and zamba2's
backbone (counterpart of ``repro/models/ssm.py``).

Chunked SSD (Dao & Gu 2024, arXiv:2405.21060): within a chunk of Q tokens
the quadratic term ``(C Bᵀ ⊙ L) · X`` with the decay matrix
``L[i, j] = exp(cum_i − cum_j)`` for i ≥ j, across chunks the linear
recurrence over per-chunk states ``S_c ∈ R^{N×P}`` per head. Decode
carries the conv windows and the SSM state: O(1) per token.

The projections are separate matrices (``w_z``, ``w_x``, ``w_bc``,
``w_dt``, ``w_out``) and the depthwise conv is split into an x part and a
B/C part, as the reference stores them. Shapes: x (B, S, D); the inner
width ``d_inner = expand·D`` splits into H heads of P; B and C have G
groups of state size N, head h reading group ``h // (H/G)`` (the
reference's ``jnp.repeat``, which is ``repeat_interleave``).

The reference materialises the (B, nc, Q, Q, H) decay matrix, its
exponential, the head-repeated ``CB`` and their product; at mamba2-1.3b's
full width (B = 8, S = 2048, Q = 256) each is 1 GiB in fp32. The port
holds one such tensor, laid out contiguous (B, nc, H, Q, Q) for a batched
product (which then needs no copy of it): the decay masked to −inf above
the diagonal and exponentiated in place (exp(−inf) = 0, where the
reference takes the exp first and then drops the entries, some of them
inf), then multiplied in place by ``CB`` broadcast over each group's
heads. Under autograd (grad enabled and an input that requires grad) the
exp and the product are taken out of place, since the exp's backward
reads its output: two such tensors, saved for the backward. The products
are the reference's, dtype promotions included: ``CB`` in the parameter
dtype, everything after it in fp32, ``y`` cast back to ``x``'s dtype
before the gated RMSNorm.

``torch.nn.functional.softplus`` returns x itself above x = 20 where
``jax.nn.softplus`` returns log(1 + eˣ); the two differ there by
log(1 + e⁻ˣ) < 2.1e-9, below half an fp32 ulp of 20 (9.5e-7), so they
round to the same fp32 value.

Under tensor parallelism (:func:`repro_torch.distributed.activation_sharding`)
a rank runs its ``H/m`` SSM heads, as the reference's layout places them:
it holds the columns of ``w_z`` and ``w_x``, the channels of ``conv_x_*``
and ``norm_scale``, and the states of its heads (``conv_x``'s channels,
the SSM state's heads). ``bc`` and ``dt`` come whole from the whole
``w_bc``, ``w_dt``, ``conv_bc_*`` and ``dt_bias``; the rank's heads read
the one B/C group (``check_tp`` admits ``ssm_groups = 1`` at a model axis
above 1) and their part of ``dt``, ``A`` and ``D``, all through
``copy_to_tp``, so every
whole leaf's gradient is summed over the model axis once (its input
``x`` goes through ``copy_to_tp`` only on the way to ``w_z`` and
``w_x``). The gated RMSNorm normalises over the whole ``d_inner``: its sum
of squares is summed over the model axis (``sum_over_tp``). The normed
``y`` is gathered over the model axis (``gather_from_tp``, 2·B·S·d_inner
bytes a layer in bf16) and every rank multiplies it by the whole
``w_out``: the product is one rank's bit for bit and ``w_out``'s gradient
is whole with no sum. Multiplying the rank's rows of ``w_out`` and summing
the partial outputs would move half the bytes, but it rounds two partial
products to the model dtype where one rank rounds once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import copy_to_tp, gather_from_tp, sum_over_tp, tp_index
from .config import ModelConfig
from .layers import init_scale, param, rmsnorm

__all__ = ["Mamba2", "init_mamba2_state", "mamba2_decode", "mamba2_forward", "ssd_chunked",
           "ssm_dims"]


def ssm_dims(cfg: ModelConfig) -> tuple:
    """A Mamba-2 mixer's whole ``(d_inner, heads H, head dim P, groups G,
    state N)``, as the reference's ``_dims``."""
    d_in = cfg.d_inner
    H = cfg.ssm_heads or d_in // cfg.ssm_head_dim
    return d_in, H, d_in // H, cfg.ssm_groups, cfg.ssm_state


class Mamba2(nn.Module):
    """One Mamba-2 mixer's parameters under the reference's names: the
    matrices and conv leaves in the parameter dtype, ``dt_bias``, ``a_log``
    and ``d_skip`` in fp32 beside them (the reference's ``init_mamba2``,
    whose distribution it draws, not its bits)."""

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        D, dt = cfg.d_model, cfg.param_dtype
        d_in, H, P, G, N = ssm_dims(cfg)
        K = cfg.ssm_conv
        f32 = dict(dtype=torch.float32, device=device)
        # dt log-uniform in [0.001, 0.1], stored as softplus⁻¹(dt)
        u = torch.empty((H,), **f32).uniform_(generator=gen)
        step = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        self.w_z = param(gen, (D, d_in), dt, device, init_scale(D))
        self.w_x = param(gen, (D, d_in), dt, device, init_scale(D))
        self.w_bc = param(gen, (D, 2 * G * N), dt, device, init_scale(D))
        self.w_dt = param(gen, (D, H), dt, device, init_scale(D))
        self.conv_x_w = param(gen, (K, d_in), dt, device, 0.3)
        self.conv_x_b = nn.Parameter(torch.zeros((d_in,), dtype=dt, device=device))
        self.conv_bc_w = param(gen, (K, 2 * G * N), dt, device, 0.3)
        self.conv_bc_b = nn.Parameter(torch.zeros((2 * G * N,), dtype=dt, device=device))
        self.dt_bias = nn.Parameter(step + torch.log(-torch.expm1(-step)))
        self.a_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, H, **f32)))
        self.d_skip = nn.Parameter(torch.ones((H,), **f32))
        self.norm_scale = nn.Parameter(torch.ones((d_in,), dtype=dt, device=device))
        self.w_out = param(gen, (d_in, D), dt, device, init_scale(d_in))


def _causal_conv(u, w, b, state=None):
    """Depthwise causal conv of kernel K over u (B, S, C); ``state``
    (B, K − 1, C) holds the inputs before u (zeros when ``None``). Returns
    the SiLU of the conv and the last K − 1 inputs (the pre-conv window)."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((u.shape[0], K - 1, u.shape[-1]), dtype=u.dtype, device=u.device)
    up = torch.cat([state, u], dim=1)  # (B, S + K − 1, C)
    S = u.shape[1]
    out = up[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + up[:, i : i + S] * w[i]
    new_state = up[:, S:].clone() if K > 1 else None  # a copy: the window alone stays alive
    return F.silu(out + b), new_state


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan from a zero state.

    xh: (B, S, H, P) inputs; dt: (B, S, H) fp32 step sizes; A: (H,) fp32
    (< 0); Bm, Cm: (B, S, G, N). Returns y (B, S, H, P) fp32 and the final
    state (B, H, N, P) fp32. A ragged S is padded to whole chunks with
    dt = 0 (no decay, no input), so the final state is the unpadded one.
    """
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        xh, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xh, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    Sp = S + pad
    nc, rep = Sp // Q, H // G

    xh = xh.reshape(Bsz, nc, Q, H, P)
    dt = dt.reshape(Bsz, nc, Q, H)
    Bm = Bm.reshape(Bsz, nc, Q, G, N)
    Cm = Cm.reshape(Bsz, nc, Q, G, N)

    cum = torch.cumsum(dt * A, dim=2)  # (B, nc, Q, H) within-chunk log decay
    total = cum[:, :, -1]  # (B, nc, H)
    xdt = xh.float() * dt[..., None]  # (B, nc, Q, H, P)

    # -- intra-chunk (quadratic): L[i, j] = exp(cum_i − cum_j), i ≥ j --
    cum_h = cum.permute(0, 1, 3, 2).contiguous()  # (B, nc, H, Q): L comes out contiguous
    L = cum_h[..., :, None] - cum_h[..., None, :]  # (B, nc, H, Q, Q)
    upper = torch.ones((Q, Q), dtype=torch.bool, device=L.device).triu_(1)
    CB = torch.matmul(Cm.permute(0, 1, 3, 2, 4), Bm.permute(0, 1, 3, 4, 2))  # (B, nc, G, Q, Q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xh, dt, A, Bm, Cm)):
        # autograd saves the exp's output for its backward: no in-place product on it
        E = L.masked_fill_(upper, float("-inf")).exp()
        L = (E.view(Bsz, nc, G, rep, Q, Q) * CB[:, :, :, None]).view(Bsz, nc, H, Q, Q)
        del E
    else:
        L.masked_fill_(upper, float("-inf")).exp_()
        L.view(Bsz, nc, G, rep, Q, Q).mul_(CB[:, :, :, None])
    del CB
    y = torch.matmul(L, xdt.permute(0, 1, 3, 2, 4))  # (B, nc, H, Q, P)
    del L

    # -- per-chunk states: S_c = Σ_j exp(total − cum_j) B_j ⊗ (x_j dt_j) --
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # (B, nc, Q, H)
    X = (xdt * decay_to_end[..., None]).reshape(Bsz, nc, Q, G, rep * P)
    S_local = torch.matmul(Bm.float().permute(0, 1, 3, 4, 2), X.permute(0, 1, 3, 2, 4))
    S_local = S_local.reshape(Bsz, nc, G, N, rep, P).permute(0, 1, 2, 4, 3, 5)
    S_local = S_local.reshape(Bsz, nc, H, N, P)

    # -- inter-chunk recurrence: S = exp(total_c)·S_prev + S_local --
    decay_chunk = torch.exp(total)  # (B, nc, H)
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=xh.device)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * decay_chunk[:, c, :, None, None] + S_local[:, c]
    S_prevs = torch.stack(prevs, dim=1)  # (B, nc, H, N, P): the state entering each chunk

    # -- inter-chunk output: y_j += C_j · (exp(cum_j) ⊙ S_prev) --
    Crep = Cm.float().repeat_interleave(rep, dim=3) * torch.exp(cum)[..., None]  # (B, nc, Q, H, N)
    y = y + torch.matmul(Crep.permute(0, 1, 3, 2, 4), S_prevs)
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, Sp, H, P)[:, :S]
    return y, state


def _project(p: Mamba2, x):
    # this rank's z and x columns; bc and dt_raw whole
    xt = copy_to_tp(x)
    return xt @ p.w_z, xt @ p.w_x, x @ p.w_bc, x @ p.w_dt


def _rank_heads(p: Mamba2, Hr: int, bc, dt):
    """B and C from the whole ``bc`` (…, 2GN), and this rank's ``Hr`` heads'
    part of the whole ``dt`` (…, H), ``A`` and ``D`` (all of them at model
    axis 1; above it the one group, G = 1, is every rank's)."""
    A, D = -torch.exp(p.a_log), p.d_skip
    index, m = tp_index()
    if m > 1:
        bc, dt, A, D = copy_to_tp(bc), copy_to_tp(dt), copy_to_tp(A), copy_to_tp(D)
        heads = slice(index * Hr, (index + 1) * Hr)
        dt, A, D = dt[..., heads], A[heads], D[heads]
    half = bc.shape[-1] // 2
    return bc[..., :half], bc[..., half:], dt, A, D


def _gated_norm(scale, y, eps: float):
    # RMSNorm over the whole d_inner; a rank holds its channels, so the sum
    # of squares is summed over the model axis
    m = tp_index()[1]
    if m == 1:
        return rmsnorm(scale, y, eps)
    yf = y.float()
    var = sum_over_tp(torch.sum(yf * yf, dim=-1, keepdim=True)) / (y.shape[-1] * m)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _gated_out(p: Mamba2, y, xh, z, D, cfg: ModelConfig, x_dtype):
    # D skip in fp32, back to the model dtype, then the gated RMSNorm and
    # w_out (over the whole normed y, gathered over the model axis)
    y = y + D[:, None] * xh.float()
    y = y.reshape(*z.shape).to(x_dtype)
    g = _gated_norm(p.norm_scale, y * F.silu(z), cfg.norm_eps)
    return gather_from_tp(g) @ p.w_out


def mamba2_forward(p: Mamba2, x, cfg: ModelConfig, conv_x=None, conv_bc=None):
    """Full-sequence forward (train and prefill) from a zero SSM state.
    Returns ``(y, (conv_x, conv_bc, ssm_state))``: the conv windows hold
    the last K − 1 pre-conv inputs. Conv windows passed in prefix the
    inputs. (The reference's signature also takes an ``ssm_state``, which
    its scan ignores; the port leaves it out.)"""
    d_in, H, P, G, N = ssm_dims(cfg)
    Bsz, S, _ = x.shape
    z, xr, bc, dt_raw = _project(p, x)
    xr, conv_x = _causal_conv(xr, p.conv_x_w, p.conv_x_b, conv_x)
    bc, conv_bc = _causal_conv(bc, p.conv_bc_w, p.conv_bc_b, conv_bc)
    xh = xr.reshape(Bsz, S, -1, P)  # this rank's heads
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    Bm, Cm, dt, A, D = _rank_heads(p, xh.shape[2], bc, dt)
    Bm, Cm = Bm.reshape(Bsz, S, -1, N), Cm.reshape(Bsz, S, -1, N)
    y, ssm_state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    return _gated_out(p, y, xh, z, D, cfg, x.dtype), (conv_x, conv_bc, ssm_state)


def _conv_step(u, w, b, state):
    win = torch.cat([state, u], dim=1)  # (B, K, C)
    out = torch.einsum("bkc,kc->bc", win, w) + b
    return F.silu(out)[:, None], win[:, 1:]


def mamba2_decode(p: Mamba2, x, cfg: ModelConfig, conv_x, conv_bc, ssm_state):
    """One token, x (B, 1, D), from the states of :func:`mamba2_forward` or
    :func:`init_mamba2_state`; returns ``(y, (conv_x, conv_bc, ssm_state))``."""
    d_in, H, P, G, N = ssm_dims(cfg)
    Bsz = x.shape[0]
    z, xr, bc, dt_raw = _project(p, x)
    xr, conv_x = _conv_step(xr, p.conv_x_w, p.conv_x_b, conv_x)
    bc, conv_bc = _conv_step(bc, p.conv_bc_w, p.conv_bc_b, conv_bc)
    xh = xr.reshape(Bsz, -1, P)  # this rank's heads
    Hr = xh.shape[1]
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)  # (B, H)
    Bm, Cm, dt, A, D = _rank_heads(p, Hr, bc[:, 0], dt)
    rep = Hr // (Bm.shape[-1] // N)
    Brep = Bm.reshape(Bsz, -1, N).repeat_interleave(rep, dim=1).float()  # (B, Hr, N)
    Crep = Cm.reshape(Bsz, -1, N).repeat_interleave(rep, dim=1).float()
    decay = torch.exp(dt * A)
    ssm_state = ssm_state * decay[..., None, None] + torch.einsum(
        "bhn,bhd->bhnd", Brep, xh.float() * dt[..., None])
    y = torch.einsum("bhn,bhnd->bhd", Crep, ssm_state)
    return _gated_out(p, y, xh, z, D, cfg, x.dtype), (conv_x, conv_bc, ssm_state)


def init_mamba2_state(cfg: ModelConfig, batch: int, device) -> tuple:
    """Zero ``(conv_x (B, K−1, d_inner), conv_bc (B, K−1, 2GN))`` in the
    parameter dtype and the fp32 SSM state (B, H, N, P); under tensor
    parallelism ``conv_x`` holds the rank's ``d_inner/m`` channels and the
    state its ``H/m`` heads (``cache_pspec``'s layout)."""
    d_in, H, P, G, N = ssm_dims(cfg)
    dt, K, m = cfg.param_dtype, cfg.ssm_conv, tp_index()[1]
    return (torch.zeros((batch, K - 1, d_in // m), dtype=dt, device=device),
            torch.zeros((batch, K - 1, 2 * G * N), dtype=dt, device=device),
            torch.zeros((batch, H // m, N, P), dtype=torch.float32, device=device))
