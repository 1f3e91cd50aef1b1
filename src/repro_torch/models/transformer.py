"""Decoder stack (counterpart of ``repro/models/transformer.py``).

The reference scans stacked per-repeat parameters over each segment; the
port holds one :class:`~repro_torch.models.blocks.Block` module per layer
in a :class:`Transformer` and runs a plain loop over the layers, in the
reference's execution order (segment by segment, each repeat's unit in
turn). Parameters are trainable; ``train_logits`` builds the autograd
graph (with ``remat``, each repeat's unit under ``torch.utils.checkpoint``),
while ``prefill`` and ``decode_step`` run under ``no_grad``. Model-level
weights beside the blocks: ``shared``, the one GQA every ``SHARED_ATTN``
block attends through (zamba2), and ``vision_proj`` (d_vision, d_model),
which lifts the modality stub's patch embeddings for the ``CROSS`` blocks
(llama-3.2-vision); ``forward_hidden`` and ``prefill`` take them as
``vision`` (B, n_patches, d_vision) and raise without it for such a
config, ``decode_step`` reads the cross K/V from the cache.

Entry points:
  init_params    — a :class:`Transformer` drawn from a ``torch.Generator``
  train_logits   — (B, S) tokens → (B, S, V) fp32 logits + aux loss
  prefill        — prompt → last-position logits + cache
  decode_step    — one token + cache → logits + cache (updated in place)
  init_cache     — zeroed cache for a batch and cache length

A cache is ``{"layers": [per-layer cache, ...], "length": tensor}``, the
layers in execution order; ``length`` is a 0-d int32 on the cache's device,
as the reference's, which a decode step reads there and advances in place.
A step reads nothing back and rebinds no buffer, so
:func:`repro_torch.serve.generate` captures it, with the sampling, in CUDA
graphs replayed once per token on the card (the reference's one compiled
program per token); on the CPU it runs eagerly.

Under :func:`~repro_torch.distributed.activation_sharding` every entry
point runs this rank's part of a (data, model) mesh: its rows of the
batch (with ``seq_shard``, the whole batch and its block of each K/V
cache's positions, decode attention combining the blocks over the data
axes), and at model axis ``m > 1`` its shards of GQA, shared-attention,
cross-attention and MLA heads, Mamba-2 SSM heads, dense FFN blocks and MoE
experts, with ``vision_proj``, the cross gates and the leaves the
reference keeps whole on every rank (a width that would split a head
raises ``ValueError``, never running a block replicated as though it were
split); ``prefill`` and ``decode_step`` return the whole vocab's logits,
gathered over the model axis. ``init_params(..., mesh=)`` draws a rank's
blocks leaf by leaf. Under FSDP rules each block's leaves (and the
embedding, ``vision_proj``, a ``SHARED_ATTN`` position's shared GQA) are
gathered over the data axis where they are read
(:func:`~repro_torch.distributed.fsdp_gathered`).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..device import DeviceLike, resolve_device
from ..distributed.sharding import (ParallelismRules, check_seq_shard, check_tp, cut_at_init,
                                    fsdp_gathered, fsdp_param, is_whole, tp_index)
from . import blocks as blk
from .config import SHARED_ATTN, BlockSpec, ModelConfig, Segment, compile_pattern
from .layers import (embed_tokens, gather_vocab, init_scale, lm_logits, param, rmsnorm,
                     truncated_normal_)

__all__ = ["REMAT_POLICIES", "Transformer", "segments", "layer_specs", "init_params",
           "forward_hidden", "train_logits", "init_cache", "prefill", "decode_step",
           "param_count"]


def segments(cfg: ModelConfig) -> Tuple[Segment, ...]:
    return compile_pattern(cfg.pattern)


def layer_specs(cfg: ModelConfig) -> Tuple[BlockSpec, ...]:
    """Every layer's spec in execution order: segment by segment, repeat by
    repeat, the unit's positions in turn."""
    return tuple(spec for seg in segments(cfg) for _ in range(seg.n_repeat) for spec in seg.unit)


class Embedding(nn.Module):
    """Token table ``tok`` (V, D) and, untied, the head ``lm_head`` (D, V)."""

    def __init__(self, gen, cfg: ModelConfig, device):
        super().__init__()
        dt = cfg.param_dtype
        self.tok = nn.Parameter(truncated_normal_(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=dt, device=device), gen, 0.02))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(truncated_normal_(
                torch.empty((cfg.d_model, cfg.vocab_size), dtype=dt, device=device), gen,
                init_scale(cfg.d_model)))


def _has_shared(cfg: ModelConfig) -> bool:
    return any(s.mixer == SHARED_ATTN for s in cfg.pattern)


class Transformer(nn.Module):
    """The model's parameters: ``embed``, one block per layer, ``shared``
    (a :class:`~repro_torch.models.blocks.GQA`, with a ``SHARED_ATTN``
    block in the pattern), ``vision_proj`` (with ``d_vision > 0``),
    ``final_norm``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(gen, cfg, device)
        self.blocks = nn.ModuleList(blk.init_block(gen, spec, cfg, device)
                                    for spec in layer_specs(cfg))
        if _has_shared(cfg):
            self.shared = blk.GQA(gen, cfg, device)
        if cfg.d_vision > 0:
            self.vision_proj = param(gen, (cfg.d_vision, cfg.d_model), cfg.param_dtype, device,
                                     init_scale(cfg.d_vision))
        self.final_norm = nn.Parameter(torch.ones((cfg.d_model,), dtype=cfg.param_dtype,
                                                  device=device))


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig, *,
                device: DeviceLike = None, mesh=None,
                rules: Optional[ParallelismRules] = None) -> Transformer:
    """A :class:`Transformer` with the reference's initialisation (truncated
    normals at its scales, unit norms), drawn from ``gen`` on ``device``
    (``None`` means CUDA and raises without it). ``gen=None`` seeds 0.

    With a ``mesh`` (:class:`~repro_torch.distributed.Mesh`) it holds this
    rank's blocks on the model axis, each leaf drawn whole in the init
    order and cut at once (:func:`~repro_torch.distributed.cut_at_init`):
    the blocks :func:`~repro_torch.distributed.shard_params` cuts from the
    whole model, bit for bit, without the whole model on the device; with
    ``rules.fsdp`` each block is cut over the data axis too. On ``meta``
    (shapes only) the draws take a CPU generator, as none exists there."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
        gen.manual_seed(0)
    if mesh is None:
        return Transformer(gen, cfg, dev)
    check_tp(cfg, mesh.shape["model"])
    with cut_at_init(mesh, rules, cfg):
        return Transformer(gen, cfg, dev)


def _layers(params: Transformer, cfg: ModelConfig):
    return zip(layer_specs(cfg), params.blocks)


def _extras(params: Transformer, cfg: ModelConfig, vision) -> dict:
    # the shared GQA and the projected vision embeddings (cast to the
    # parameter dtype before the product), as the reference's _extras
    ex = {}
    if _has_shared(cfg):
        ex["shared"] = params.shared
    if cfg.d_vision > 0:
        if vision is None:
            raise ValueError(f"{cfg.name} requires `vision` embeddings (modality stub output)")
        ex["vision"] = vision.to(cfg.param_dtype) @ fsdp_param(params.vision_proj)
    return ex


def _owners(block, spec: BlockSpec, ex: dict) -> tuple:
    # the modules whose weights a block reads: its own, and the shared GQA
    # at a SHARED_ATTN position (gathered there under FSDP)
    return (block, ex["shared"]) if spec.mixer == SHARED_ATTN else (block,)


def _logits(params: Transformer, cfg: ModelConfig, h):
    # the whole vocab's logits: the model axis's shards gathered, unless the
    # run time keeps the vocab whole
    with fsdp_gathered(params.embed):
        logits = lm_logits(params.embed, h, cfg)
    return logits if is_whole("tok", cfg) else gather_vocab(logits)


def _save_dots(ctx, op, *args, **kwargs):
    # the 2-D weight products' outputs are kept; everything else, batched
    # products (bmm, SDPA) included, is recomputed in the backward
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


# remat policy name -> the selective-checkpoint policy (None: save nothing)
REMAT_POLICIES = {
    "full": None,
    "dots": _save_dots,  # the reference's dots_with_no_batch_dims_saveable
}


def _maybe_remat(fn, remat: Optional[str]):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) by the
    :data:`REMAT_POLICIES` entry ``remat``; ``None`` runs ``fn`` as it is."""
    if remat is None:
        return fn
    policy = REMAT_POLICIES[remat]
    kw = {} if policy is None else {
        "context_fn": functools.partial(create_selective_checkpoint_contexts, policy)}
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _units(params: Transformer, cfg: ModelConfig):
    """Each repeat's unit of each segment: ``[(spec, block), ...]``, in
    execution order (the reference's remat granule)."""
    blocks = iter(params.blocks)
    for seg in segments(cfg):
        for _ in range(seg.n_repeat):
            yield [(spec, next(blocks)) for spec in seg.unit]


def forward_hidden(params: Transformer, cfg: ModelConfig, tokens, vision=None, *,
                   dense_moe: bool = False, remat: Optional[str] = None):
    """Final-normed hidden states (B, S, D) and the aux loss, summed over the
    MoE layers (0 without one); ``dense_moe`` takes MoE's dropless loop.
    Builds the autograd graph when grad is enabled; ``remat`` (``None``,
    ``"full"``, ``"dots"``) checkpoints each repeat's unit, as the
    reference remats each scan step's body. Under
    :func:`~repro_torch.distributed.activation_sharding` at model axis
    ``m > 1`` it runs this rank's shards (a width that does not split into
    whole shards raises). Under FSDP each block's leaves are gathered before
    it runs (inside the ``remat`` unit, so its recomputation gathers them
    again rather than keeping them for the backward)."""
    check_tp(cfg, tp_index()[1])
    x = embed_tokens(fsdp_param(params.embed.tok), tokens, cfg)
    ex = _extras(params, cfg, vision)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def unit_fn(x, aux, unit):
        for spec, block in unit:
            with fsdp_gathered(*_owners(block, spec, ex)):
                x, a = blk.block_train(block, spec, cfg, x, ex, dense_moe=dense_moe)
            aux = aux + a
        return x, aux

    run = _maybe_remat(unit_fn, remat)
    for unit in _units(params, cfg):
        x, aux = run(x, aux, unit)
    return rmsnorm(params.final_norm, x, cfg.norm_eps), aux


def train_logits(params: Transformer, cfg: ModelConfig, tokens, vision=None, *,
                 dense_moe: bool = False, remat: Optional[str] = None):
    """fp32 logits (B, S, V), or this rank's vocab shard of them under
    tensor parallelism, and the aux loss."""
    h, aux = forward_hidden(params, cfg, tokens, vision, dense_moe=dense_moe, remat=remat)
    with fsdp_gathered(params.embed):
        return lm_logits(params.embed, h, cfg), aux


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: DeviceLike = None) -> dict:
    """A zeroed cache of ``batch`` rows (this rank's, under a mesh) and
    ``cache_len`` positions; under tensor parallelism each K/V cache holds
    the rank's KV heads, each Mamba-2 state its SSM heads and ``conv_x``
    channels; sequence-sharded (``activation_sharding(..., seq_shard=True)``)
    each K/V cache holds the rank's block of the positions, or of a local
    layer's ring, and ``batch`` is the whole batch."""
    check_tp(cfg, tp_index()[1])
    check_seq_shard(cfg)
    dev = resolve_device(device)
    return {"layers": [blk.init_block_cache(spec, cfg, batch, cache_len, dev)
                       for spec in layer_specs(cfg)],
            "length": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def prefill(params: Transformer, cfg: ModelConfig, tokens, cache_len: int, vision=None, *,
            dense_moe: bool = False):
    """Run the prompt (B, S); returns the last position's logits (B, 1, V)
    and a cache of ``cache_len`` positions holding it. Under
    :func:`~repro_torch.distributed.activation_sharding` the prompt is this
    rank's rows, the cache its block (:func:`~repro_torch.distributed.shard_cache`)
    and the logits the whole vocab's, gathered over the model axis. Under
    FSDP the embedding is gathered once for the lookup and the logits."""
    check_tp(cfg, tp_index()[1])
    check_seq_shard(cfg)
    B, S = tokens.shape
    with fsdp_gathered(params.embed):
        x = embed_tokens(params.embed.tok, tokens, cfg)
        ex = _extras(params, cfg, vision)
        caches = []
        for spec, block in _layers(params, cfg):
            with fsdp_gathered(*_owners(block, spec, ex)):
                x, c = blk.block_prefill(block, spec, cfg, x, cache_len, ex,
                                         dense_moe=dense_moe)
            caches.append(c)
        h = rmsnorm(params.final_norm, x[:, -1:], cfg.norm_eps)
        length = torch.full((), S, dtype=torch.int32, device=x.device)
        return _logits(params, cfg, h), {"layers": caches, "length": length}


@torch.no_grad()
def decode_step(params: Transformer, cfg: ModelConfig, cache: dict, token, *,
                dense_moe: bool = False, phase: str = blk.PLAIN):
    """token: (B, 1) ints. Returns (logits (B, 1, V), cache); the cache is
    updated in place and its ``length`` advanced in place. ``phase`` is the
    step's place in a compressed cache's schedule
    (:func:`repro_torch.serve.kv_cache.decode_schedule`); dense caches take
    every step alike. Under a mesh, as :func:`prefill`: this rank's rows and
    cache block, the whole vocab's logits (FSDP: the embedding gathered once)."""
    check_tp(cfg, tp_index()[1])
    check_seq_shard(cfg)
    ex = {"shared": params.shared} if _has_shared(cfg) else {}  # cross K/V live in the cache
    length = cache["length"]
    with fsdp_gathered(params.embed):
        x = embed_tokens(params.embed.tok, token, cfg)
        for (spec, block), layer in zip(_layers(params, cfg), cache["layers"]):
            with fsdp_gathered(*_owners(block, spec, ex)):
                x = blk.block_decode(block, spec, cfg, x, layer, length, ex,
                                     dense_moe=dense_moe, phase=phase)
        h = rmsnorm(params.final_norm, x, cfg.norm_eps)
        length.add_(1)
        return _logits(params, cfg, h), cache


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
