"""GMR gradient compression — the paper's Algorithm 1 as a data-parallel
training communication primitive (counterpart of
``repro/train/grad_compress.py``).

Data-parallel all-reduce of a weight gradient ``G (m×n)`` moves m·n floats
per step per worker. Instead each worker:

  1. draws the *same* sketches from a step-shared seed: Ω (c×n), Ψ (c×m)
     Gaussian outer sketches and S_C (s×m), S_R (s×n) inner sketches
     (paper §6.1 protocol: c = r, s = a·c);
  2. forms ``C = GΩᵀ``, ``R = ΨG``, ``M = S_C G S_Rᵀ`` — all linear in G;
  3. all-reduces (C, R, M): (m+n)·c + s² floats instead of m·n;
  4. reconstructs ``Ĝ = C · (S_C C)† M (R S_Rᵀ)† · R`` (Algorithm 1, with
     A = ΣᵢGᵢ never formed);
  5. keeps a local error-feedback residual ``e ← (G+e) − Ĝ`` folded into the
     next step.

Linearity of step 2 makes the compressed all-reduce exact: the sketch of
the sum is the sum of the sketches.

The port's tree is a dict of leaves in the reference's ``jax.tree.flatten``
order, a leaf's index ``i`` in it choosing its sketches: the train step
groups each layer's gradient into the reference's scan stacks
(:func:`~repro_torch.convert.stacked_leaves`) before it calls
:func:`compressed_mean_grads`, so an (L, m, n) stack shares one set of
sketches, as the reference's vmapped slices do. The reference's ``psum``
over its DP mesh axes is ``all_reduce(SUM) / world`` on a
``torch.distributed`` group (``None``: a world of one, no collective); the
reference's leading worker dimension of the EF state is the rank, each
rank keeping its own.

Sketches of leaf ``i`` at step seed ``key`` are drawn from a
``torch.Generator`` seeded by ``fold_in(key, i)`` on the leaf's device, in
the order Ω, Ψ, S_C, S_R (the port's ``fold_in`` and ``split``; the bits
differ from ``jax.random``'s, so the tests hand the reference's draws in
through ``sketches=``). With Gaussian inner sketches (the default) ``M`` is
kernel 4 (:func:`repro_torch.kernels.ops.twoside_sketch`): one launch per
leaf, a stack its batch axis; other inner sketches keep the reference's
``S_R.apply_t(S_C.apply(·))`` per slice (a CountSketch reaches kernel 1
there). The outer products ``GΩᵀ``, ``ΨG`` and the reconstruction are
plain ``torch.matmul``, as the reference computes them outside any Pallas
kernel.

Under tensor parallelism each rank holds a block of a leaf's columns or
rows (``cuts``, :func:`repro_torch.distributed.sharding.tp_cuts`) and
compresses its block, exact by the same linearity. Every rank draws the
logical leaf's sketches and keeps the columns of Ω and S_R (a column block
``G = [G_0 | G_1]``) or of Ψ and S_C (a row block). For a column block,
``C = Σ_k G_k Ω_kᵀ`` and ``M = Σ_k S_C G_k S_R,kᵀ`` (kernel 4 on the block)
are summed over the model axis, ``R_k = Ψ G_k`` stays local, the
reconstruction sums ``R S_Rᵀ = Σ_k R_k S_R,kᵀ`` and returns the block
``Ĝ_k = C X R_k``; a row block is the mirror image. Over the data axes
every triple takes the mean, as above. The EF residual is the rank's block;
the compressibility, ``comp/wire_floats`` and ``comp/ratio`` read the
logical shapes, and ``comp/ef_norm``, ``comp/rel_err`` sum their squares
over the model axis. No leaf is gathered. A block of a stack's slices (a
MoE layer's experts, cut on dim −3) holds whole slices: it is compressed
slice by slice with the logical leaf's sketches and no model-axis sum. A
leaf the model axis keeps whole (Mamba-2's ``w_out``, the router, MLA's
``w_dkv``) has a whole gradient, equal on every model rank: each rank
compresses it with the same sketches, so its update is equal bit for bit
on them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.gmr import fast_gmr_core
from ..core.sketching import GaussianSketch, draw_sketch
from ..device import fold_in, generator
from ..kernels import ops

__all__ = ["CompressionConfig", "compress", "compressed_mean_grads", "compression_ratio",
           "decompress", "group_leaves", "init_error_state", "is_compressible", "leaf_shapes",
           "logical_shape"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    rank: int = 64  # c = r — outer sketch size
    sketch_factor: int = 4  # a: inner sketch size s = a·rank (paper §6.1)
    min_dim: int = 512  # compress only 2-D leaves with both dims ≥ this
    inner_sketch: str = "gaussian"
    error_feedback: bool = True

    @property
    def s(self) -> int:
        return self.sketch_factor * self.rank


def is_compressible(leaf, ccfg: CompressionConfig) -> bool:
    """2-D weights, or stacked (L, m, n) weights (compressed per layer slice
    with shared sketches). ``leaf`` is a tensor or a shape."""
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
    if len(shape) == 2:
        return min(shape) >= ccfg.min_dim
    if len(shape) == 3:
        return min(shape[1:]) >= ccfg.min_dim
    return False


def group_leaves(named: dict, groups) -> dict:
    """The reference's leaves by path from per-layer tensors ``named``
    (name → tensor): each group's tensors stacked on a new leading axis,
    a group of one taken as it is. ``groups`` is
    :func:`~repro_torch.convert.stacked_leaves`'s ``[(path, names)]``."""
    return {path: torch.stack([named[n] for n in names]) if len(names) > 1 else named[names[0]]
            for path, names in groups}


def leaf_shapes(params) -> dict:
    """The reference's leaf shapes by path, in its flattening order: a
    :class:`~repro_torch.models.Transformer`'s groups of
    :func:`~repro_torch.convert.stacked_leaves` ((L, ...) for a stack of L
    layers), or a dict's items in sorted key order (``jax.tree`` sorts dict
    keys)."""
    from torch import nn

    if isinstance(params, nn.Module):
        from ..convert import stacked_leaves

        named = dict(params.named_parameters())
        return {path: torch.Size((len(names), *named[names[0]].shape)) if len(names) > 1
                else named[names[0]].shape for path, names in stacked_leaves(params, params.cfg)}
    return {k: params[k].shape for k in sorted(params)}


def compression_ratio(params, ccfg: CompressionConfig) -> float:
    """Dense vs compressed DP-all-reduce volume over the whole tree
    (``params``: a model, on the ``meta`` device too, or a dict of tensors)."""
    dense = comp = 0
    for shape in leaf_shapes(params).values():
        n = int(np.prod(shape))
        dense += n
        if is_compressible(shape, ccfg):
            L = shape[0] if len(shape) == 3 else 1
            m, nn_ = shape[-2:]
            comp += L * ((m + nn_) * ccfg.rank + ccfg.s * ccfg.s)
        else:
            comp += n
    return dense / comp


def _sketches_for(key: int, shape, ccfg: CompressionConfig, device) -> tuple:
    """``(Ω, Ψ, S_C, S_R)`` of an (m, n) slice, drawn in that order from a
    generator seeded by ``key`` on ``device``."""
    m, n = shape
    c = ccfg.rank
    g = generator(key, device)
    omega = draw_sketch(g, "gaussian", c, n)  # right outer: C = G Ωᵀ
    psi = draw_sketch(g, "gaussian", c, m)  # left outer: R = Ψ G
    s_c = draw_sketch(g, ccfg.inner_sketch, ccfg.s, m)
    s_r = draw_sketch(g, ccfg.inner_sketch, ccfg.s, n)
    return omega, psi, s_c, s_r


def _resolve(key, shape, ccfg, device) -> tuple:
    # a seed draws the sketches; a tuple is them (the tests' hook)
    return tuple(key) if isinstance(key, (tuple, list)) else _sketches_for(key, shape[-2:], ccfg,
                                                                          device)


def _left(S, A: torch.Tensor) -> torch.Tensor:
    """``S·A`` for A (m, k) or a stack (L, m, k)."""
    if isinstance(S, GaussianSketch):
        return torch.matmul(S.mat, A)
    return S.apply(A) if A.dim() == 2 else torch.stack([S.apply(a) for a in A])


def _right_t(S, A: torch.Tensor) -> torch.Tensor:
    """``A·Sᵀ`` for A (k, n) or a stack (L, k, n)."""
    if isinstance(S, GaussianSketch):
        return torch.matmul(A, S.mat.T)
    return S.apply_t(A) if A.dim() == 2 else torch.stack([S.apply_t(a) for a in A])


def compress(key, G: torch.Tensor, ccfg: CompressionConfig) -> tuple:
    """Local sketching (step 2): the (C, R, M) triple of ``G`` in fp32, linear
    in G. ``key`` is a seed or the four sketches. A stack (L, m, n) is
    sketched per slice with shared sketches; the triple gains a leading L."""
    omega, psi, s_c, s_r = _resolve(key, G.shape, ccfg, G.device)
    Gf = G.float()
    C = _right_t(omega, Gf)  # G Ωᵀ: (m, c)
    R = _left(psi, Gf)  # Ψ G: (c, n)
    if isinstance(s_c, GaussianSketch) and isinstance(s_r, GaussianSketch):
        M = ops.twoside_sketch(s_c.mat, Gf, s_r.mat.T)  # kernel 4: S_C G S_Rᵀ (s, s)
    else:
        M = _right_t(s_r, _left(s_c, Gf))
    return C, R, M


def decompress(key, triple, shape, ccfg: CompressionConfig, *, reduce=None) -> torch.Tensor:
    """Algorithm 1's reconstruction ``C (S_C C)† M (R S_Rᵀ)† R`` from the
    (all-reduced) triple, per slice of a stack. ``reduce``, when given, maps
    ``(S_C C, R S_Rᵀ)`` to their sums over the model axis (a block's)."""
    C, R, M = triple
    omega, psi, s_c, s_r = _resolve(key, shape, ccfg, C.device)
    ScC, RSr = _left(s_c, C), _right_t(s_r, R)
    if reduce is not None:
        ScC, RSr = reduce(ScC, RSr)
    X = fast_gmr_core(ScC, M, RSr)
    return torch.matmul(C, torch.matmul(X, R))


def logical_shape(shape, cut) -> tuple:
    """The whole leaf's shape from a block's and its cut ``(dim, parts, index)``."""
    shape = list(shape)
    if cut is not None:
        shape[cut[0]] *= cut[1]
    return tuple(shape)


def _block_sketches(sketches: tuple, cut) -> tuple:
    # a column block keeps its columns of Ω and S_R, a row block of Ψ and S_C
    omega, psi, s_c, s_r = sketches
    dim, parts, index = cut
    if dim == -1:
        n = omega.m // parts
        return omega.cols(index * n, n), psi, s_c, s_r.cols(index * n, n)
    m = psi.m // parts
    return omega, psi.cols(index * m, m), s_c.cols(index * m, m), s_r


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the model axis's ``group`` in place (identity without one)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _mean(t: torch.Tensor, group, world: int) -> torch.Tensor:
    """The reference's ``psum(t) / world`` over ``group`` (identity without one)."""
    if group is None:
        return t
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.div_(world)


def compressed_mean_grads(grads: dict, err: dict, key: int, ccfg: CompressionConfig,
                          group=None, *, with_stats: bool = False,
                          sketches: Optional[dict] = None, cuts: Optional[dict] = None,
                          tp_group=None):
    """Replace the dense DP all-reduce: ``(mean grads, new err[, stats])``.

    ``grads``: the local gradients by path in the reference's flattening
    order (:func:`leaf_shapes` order); ``err``: this rank's EF residuals of the
    compressible paths (fp32, missing ones read as zero); ``key``: the step's
    seed, leaf ``i``'s sketches drawn at ``fold_in(key, i)`` unless
    ``sketches[i]`` holds them. Small leaves take the dense all-reduce.

    ``with_stats=True`` also returns this rank's ``comp/wire_floats``,
    ``comp/dense_floats``, ``comp/ratio`` (config-static), ``comp/ef_norm``
    (``√Σ‖e‖²`` over compressible leaves) and ``comp/rel_err``
    (``‖(g+e) − ĝ‖ / ‖g+e‖``), as 0-d fp32 tensors.

    Tensor parallelism: ``cuts[path]`` is the ``(dim, parts, index)`` of a
    leaf's block on the model axis (``dim`` −1 for columns, −2 for rows),
    ``tp_group`` that axis's group; ``sketches[i]`` are then the logical
    leaf's, and ``err`` and the outputs are the blocks.
    """
    world = dist.get_world_size(group) if group is not None else 1
    cuts = cuts or {}
    out, out_err = {}, {}
    wire = dense = 0
    dev = next(iter(grads.values())).device
    # squares of replicated leaves [0] and of blocks [1] (summed over the model axis)
    ef_sq, local_sq, resid_sq = (torch.zeros(2, dtype=torch.float32, device=dev)
                                 for _ in range(3))
    for i, (path, g) in enumerate(grads.items()):
        cut = cuts.get(path)
        shape = logical_shape(g.shape, cut)
        dense += math.prod(shape)
        if not is_compressible(shape, ccfg):
            out[path] = _mean(g.float(), group, world).to(g.dtype)
            wire += math.prod(shape)
            continue
        k = sketches[i] if sketches is not None else fold_in(key, i)
        k = _resolve(k, shape, ccfg, dev)
        reduce = None
        if cut is not None and cut[0] == -3:
            cut = None  # whole slices of a stack: this rank's slices alone
        if cut is not None:
            k = _block_sketches(k, cut)
            # the terms the block only holds a part of: (C, M) or (R, M)
            col = cut[0] == -1

            def reduce(ScC, RSr, col=col):
                return (ScC, _sum(RSr, tp_group)) if col else (_sum(ScC, tp_group), RSr)

        local = g.float()
        if ccfg.error_feedback and path in err:
            local = local + err[path]
        C, R, M = compress(k, local, ccfg)
        if cut is not None:
            C, R = (_sum(C, tp_group), R) if col else (C, _sum(R, tp_group))
            M = _sum(M, tp_group)
        triple = tuple(_mean(t, group, world) for t in (C, R, M))
        ghat = decompress(k, triple, g.shape, ccfg, reduce=reduce)
        resid = local - ghat
        out[path] = ghat.to(g.dtype)
        out_err[path] = resid if ccfg.error_feedback else torch.zeros_like(local)
        if with_stats:
            L = shape[0] if len(shape) == 3 else 1
            wire += L * ((shape[-2] + shape[-1]) * ccfg.rank + ccfg.s * ccfg.s)
            j = int(path in cuts)
            ef_sq[j] += torch.sum(out_err[path] * out_err[path])
            local_sq[j] += torch.sum(local * local)
            resid_sq[j] += torch.sum(resid * resid)
    if not with_stats:
        return out, out_err
    sq = torch.stack([ef_sq, local_sq, resid_sq])
    blocks = sq[:, 1].contiguous()
    if cuts:
        _sum(blocks, tp_group)
    ef_sq, local_sq, resid_sq = sq[:, 0] + blocks
    f32 = dict(dtype=torch.float32, device=dev)
    stats = {
        "comp/wire_floats": torch.tensor(float(wire), **f32),
        "comp/dense_floats": torch.tensor(float(dense), **f32),
        "comp/ratio": torch.tensor(dense / max(wire, 1), **f32),
        "comp/ef_norm": torch.sqrt(ef_sq),
        "comp/rel_err": torch.sqrt(resid_sq) / torch.clamp(torch.sqrt(local_sq),
                                                           min=torch.finfo(torch.float32).tiny),
    }
    return out, out_err, stats


def init_error_state(params, ccfg: CompressionConfig, cuts: Optional[dict] = None) -> dict:
    """This rank's EF residuals: fp32 zeros for each compressible leaf of
    :func:`leaf_shapes` (the reference's placeholders of the other leaves
    hold nothing and are left out); with ``cuts``, each leaf compressible
    at its logical shape, as this rank's block."""
    from .optimizer import named_tensors

    cuts = cuts or {}
    dev = next(iter(named_tensors(params).values())).device
    return {path: torch.zeros(shape, dtype=torch.float32, device=dev)
            for path, shape in leaf_shapes(params).items()
            if is_compressible(logical_shape(shape, cuts.get(path)), ccfg)}
