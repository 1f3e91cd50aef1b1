"""Logical-axis sharding rules → partition specs per tensor, and tensor
parallelism at run time (counterpart of ``repro/distributed/sharding.py``).

**The rules** are the reference's, as plain Python: ``ParallelismRules``,
the ``_LEAF_LAYOUTS`` and ``_MOE_LAYOUTS`` tables, ``leaf_pspec``,
``param_pspecs``, ``batch_pspec``, ``cache_pspec`` and ``explain``. A spec
is a tuple with one entry per dim, each what the reference's
``PartitionSpec`` entry is: an axis name, a tuple of names, or ``None``. A
path is a dotted string (``"segments.0.0.ffn.w_up"``) or a tuple of keys;
an all-digit part is a list index (the reference's ``SequenceKey``), any
other part a dict key. A mesh is anything with ``shape`` (axis name →
size) and ``axis_names``: a :class:`Mesh`, or a stand-in for the rules
alone. A dim is sharded only where its axes divide it, else it is
replicated, as the reference's rules degrade.

**Run time.** The reference places each weight by its spec and lets its
partitioner move activations where ``shard_act`` asks. The port runs one
process per rank of a :class:`Mesh` (``launch/mesh.py``), each holding its
block of every weight on the model axis (:func:`shard_params`), and the
model code calls autograd Functions where the reference calls
``shard_act``: :func:`copy_to_tp` (identity forward, all-reduce backward)
before a column-sharded product or where a rank reads its part of a whole
tensor, :func:`reduce_from_tp` (all-reduce forward, identity backward)
after a row-sharded one, :func:`sum_over_tp` (all-reduce both ways) for a
sum that every rank's part feeds and reads, :func:`gather_from_tp` (the
blocks joined forward, the rank's block of the gradient backward) where a
whole weight reads a cut activation. Each is the identity outside
:func:`activation_sharding` or at model axis 1.

* Each layer is a leaf of its own in the port, so a layer's tensors take
  the rules of an unscanned layer: ``w_q``, ``w_k``, ``w_v``, ``w_gate``,
  ``w_up`` columns, ``w_o``, ``w_down`` rows, ``tok`` and ``lm_head`` the
  vocab. (The reference's rules read a scanned dense FFN stack (L, D, F)
  as MoE experts by its rank and put its layer axis over ``model``;
  :func:`param_pspecs` returns those specs as they are.)
* A MoE layer's ``(E, D, Fe)`` / ``(E, Fe, D)`` expert tensors are true
  expert stacks in the port (each layer its own leaf): they are cut on the
  expert dim by ``_MOE_LAYOUTS``' ``ep``; its ``shared`` FFN takes the
  dense FFN's rules; the ``router`` stays whole. MLA's ``w_q``, ``w_uk``
  and ``w_uv`` are cut by columns, which are whole heads, ``w_o`` by rows;
  ``w_dkv`` stays whole, and so does the latent cache.
* Mamba-2 (``_LEAF_LAYOUTS``): ``w_z``, ``w_x``, ``conv_x_*`` and
  ``norm_scale`` are cut by channels, which are whole SSM heads; ``w_bc``,
  ``w_dt``, ``conv_bc_*``, ``dt_bias``, ``a_log``, ``d_skip`` and
  ``w_out`` (no rule: ``P()``) stay whole. A rank reads its heads' part of
  the whole ``bc``, ``dt``, ``A`` and ``D`` through :func:`copy_to_tp`, so
  their leaves' gradients come out whole; the gated norm sums its squares
  over the model axis (:func:`sum_over_tp`) and its output is gathered
  (:func:`gather_from_tp`) for the whole ``w_out``. Shared attention's
  model-level GQA and each cross layer are cut as any GQA; ``vision_proj``
  and the cross ``gate`` stay whole.
* The run time takes every mixer and FFN, and only whole shards: whole
  query, KV, MLA and SSM heads, equal FFN, expert, shared-expert and vocab
  blocks (:func:`check_tp`). Where the rules would replicate a dim they
  lay out over ``model``, or a block would split a head, it raises; it
  never runs a replicated weight as though it were split. Where the model
  axis is a multiple of the GQA family's KV heads (8 heads at 16), each
  rank keeps them whole (``w_k``, ``w_v`` and the K/V caches, as the
  reference's ``cache_pspec`` does), and its query heads read the one
  their group shares; where the query heads do not split either, the rank
  runs every head and keeps its rows of the output for its block of
  ``w_o``; a vocab that does not split is kept whole (:func:`whole_leaves`).
  A whole weight passes through :func:`copy_to_tp`, so its partial
  gradients are summed.
* **FSDP** (``rules.fsdp``): each leaf's ``fsdp`` dim is cut over
  ``fsdp_axes`` (``data``) too, where they divide it (:func:`fsdp_cut`;
  the block carries ``fsdp_dim``). The model code gathers a block's leaves
  before it runs (:func:`fsdp_gathered`: ``all_gather_into_tensor``
  forward, ``reduce_scatter_tensor`` of the gradient backward, summed over
  the data ranks; gloo takes both on CUDA tensors), so a step's FSDP
  gradients arrive summed over ``data``.
  :func:`cut_at_init` draws a model leaf by leaf, each cut to
  the rank's block at once, so a model that does not fit the card whole
  never sits there.
* The context is a module global, not a context variable: the autograd
  engine's device threads run the backward and ``torch.utils.checkpoint``'s
  recomputation, which must see it too.

**The data axes.** A context computes what the reference's SPMD program
computes over the global batch (``jit`` with the batch sharded over
``data``): the MoE capacity dispatch groups and ranks each assignment as
the global batch's run does, and the Switch aux loss reads the global
top-1 counts (:func:`global_batch_group`). ``per_shard=True`` computes
each data rank's loss, dispatch and aux over its own rows, as the
reference's ``shard_map`` over the data axes does (the compressed train
step).

**Serving** runs under the same context. A data rank holds its rows of the
batch (:func:`shard_batch`) and of every cache; a model rank holds its KV
heads of every K/V cache (:func:`shard_cache`, the run-time cut of
:func:`cache_pspec`). The logits' vocab shards are gathered in shard order
before sampling (:func:`gather_tp`), and :func:`dp_index` tells the
sampling and the compressed cache's sketch draws which rows of the whole
batch are this rank's.

**The sequence-sharded decode cache** (``activation_sharding(...,
seq_shard=True)``, the reference's ``cache_pspec(seq_shard=True)`` for its
``long_500k`` cell): the batch is replicated over the data axes (whole
on every data rank, as the reference's ``P(None, None)`` token) and every
data rank runs the whole
model on it; each K/V cache holds the rank's block of the sequence (of a
local layer's ring, its block of the slots) where the data axes divide it
(:func:`seq_cut`, :func:`shard_cache`), and decode attention combines the
blocks over the data axes (:func:`seq_place`): the reference's SPMD
partitioner puts in those sums, the port writes them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "ParallelismRules", "activation_sharding", "batch_pspec", "block",
           "cache_pspec", "check_tp", "copy_to_tp", "cut_at_init", "dp_index", "explain",
           "fsdp_cut", "fsdp_gathered", "fsdp_group", "fsdp_names", "fsdp_param",
           "gather_tp", "global_batch_group", "leaf_pspec", "param_pspecs", "reduce_from_tp",
           "ref_path", "shard_batch", "gather_from_tp", "shard_cache", "shard_params",
           "check_seq_shard", "seq_cut", "seq_group", "seq_place", "spec_block", "spec_str",
           "sum_over_tp", "tp_cut", "tp_cuts", "tp_group", "tp_index", "tp_names", "is_whole",
           "whole_leaves"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A logical mesh over the ranks of a ``torch.distributed`` world.

    ``shape`` maps axis names to sizes, the last axis varying fastest over
    the ranks (``jax.make_mesh``'s device order): rank ``r`` of a
    (data, model) mesh sits at ``(r // model, r % model)``. ``groups``
    maps a tuple of axis names to the process group of the ranks that
    differ from this one only along those axes (``None`` for an axis of
    size 1). A mesh without groups describes a rank's place for the rules
    and for :func:`shard_params`, but runs no collective."""

    shape: dict
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def coords(self) -> dict:
        """This rank's coordinate along each axis."""
        out, r = {}, self.rank
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {name: out[name] for name in self.axis_names}

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def index(self, axes) -> int:
        """This rank's place along ``axes`` (row-major over several)."""
        idx, c = 0, self.coords
        for a in _axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, axes):
        """The process group along ``axes``; ``None`` where they have size 1,
        and an error where the mesh holds no group for axes of more."""
        axes = _axes(axes)
        if self.axis_size(axes) == 1:
            return None
        if axes not in self.groups:
            raise ValueError(f"the mesh holds no process group along {axes}: "
                             "make it with repro_torch.launch.mesh")
        return self.groups[axes]


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class ParallelismRules:
    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("data",)  # ("pod", "data") on the multi-pod mesh
    fsdp: bool = False
    fsdp_axes: Tuple[str, ...] = ("data",)
    shard_vocab: bool = True
    # sequence parallelism: shard the S axis of activations over tp_axis and
    # replicate weights (tp_enabled=False)
    tp_enabled: bool = True
    seq_parallel: bool = False

    def with_mesh(self, mesh) -> "ParallelismRules":
        names = tuple(mesh.axis_names)
        dp = tuple(a for a in ("pod", "data") if a in names)
        return dataclasses.replace(self, dp_axes=dp, fsdp_axes=("data",))


# leaf name → semantic layout of the LAST dims:
#   tp — over tp_axis; fsdp — over fsdp_axes when rules.fsdp;
#   ep — expert dim over tp_axis; vocab — over tp_axis when shard_vocab;
#   - — never sharded
_LEAF_LAYOUTS = {
    # attention / generic projections: (in, out)
    "w_q": ("fsdp", "tp"),
    "w_k": ("fsdp", "tp"),
    "w_v": ("fsdp", "tp"),
    "w_o": ("tp", "fsdp"),
    # FFN
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # embedding / head
    "tok": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    # MLA
    "w_dkv": ("fsdp", "-"),
    "w_uk": ("-", "tp"),
    "w_uv": ("-", "tp"),
    # Mamba-2
    "w_z": ("fsdp", "tp"),
    "w_x": ("fsdp", "tp"),
    "w_bc": ("fsdp", "-"),
    "w_dt": ("fsdp", "-"),
    "conv_x_w": ("-", "tp"),
    "conv_x_b": ("tp",),
    "conv_bc_w": ("-", "-"),
    "conv_bc_b": ("-",),
    "dt_bias": ("-",),
    "a_log": ("-",),
    "d_skip": ("-",),
    "norm_scale": ("tp",),
    # MoE
    "router": ("fsdp", "-"),
    # misc
    "vision_proj": ("-", "fsdp"),
    "gate": (),
    "scale": ("-",),
}

# MoE expert tensors are 3-D (E, in, out) and shadow FFN names: resolved by rank
_MOE_LAYOUTS = {
    "w_gate": ("ep", "fsdp", "-"),
    "w_up": ("ep", "fsdp", "-"),
    "w_down": ("ep", "-", "fsdp"),
}


def _axis_for(sem: str, rules: ParallelismRules):
    if sem == "dp":
        return rules.dp_axes
    if sem == "tp" or sem == "ep":
        return rules.tp_axis if rules.tp_enabled else None
    if sem == "vocab":
        return rules.tp_axis if (rules.shard_vocab and rules.tp_enabled) else None
    if sem == "fsdp":
        return rules.fsdp_axes if rules.fsdp else None
    if sem == "seq":
        return rules.tp_axis if rules.seq_parallel else None
    return None


def _divisible(dim: int, axis, mesh) -> bool:
    if axis is None:
        return True
    sizes = [mesh.shape[a] for a in (axis if isinstance(axis, tuple) else (axis,))]
    return dim % int(math.prod(sizes)) == 0


def _keys(path) -> tuple:
    """A path's parts: an all-digit part is a list index, the rest dict keys."""
    parts = path.split(".") if isinstance(path, str) else tuple(path)
    return tuple(int(p) if isinstance(p, str) and p.isdigit() else p for p in parts)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _layout(path, ndim: int):
    keys = [k for k in _keys(path) if isinstance(k, str)]
    name = keys[-1] if keys else None
    in_moe = "ffn" in keys and ndim >= 3 and name in _MOE_LAYOUTS
    return _MOE_LAYOUTS[name] if in_moe else _LEAF_LAYOUTS.get(name)


def leaf_pspec(path, leaf, rules: ParallelismRules, mesh) -> tuple:
    """The spec of one parameter leaf (a tensor, array or shape) by its path's
    last dict key and its rank; leaves of stacked scan segments carry a
    leading repeat dim, unsharded."""
    shape = _shape(leaf)
    layout = _layout(path, len(shape))
    if layout is None:
        return ()
    extra = len(shape) - len(layout)
    spec = [None] * extra
    for sem, dim in zip(layout, shape[extra:]):
        axis = _axis_for(sem, rules)
        spec.append(axis if _divisible(dim, axis, mesh) else None)
    return tuple(spec)


def _leaf_shapes(params) -> dict:
    """``{path: shape}``: a :class:`~repro_torch.models.Transformer`'s leaves
    as the reference's stacked ones (:func:`~repro_torch.convert.stacked_leaves`),
    or a dict of paths to tensors, arrays or shapes."""
    from torch import nn

    if isinstance(params, nn.Module):
        from ..convert import stacked_leaves

        named = dict(params.named_parameters())
        return {path: ((len(names), *named[names[0]].shape) if len(names) > 1
                       else tuple(named[names[0]].shape))
                for path, names in stacked_leaves(params, params.cfg)}
    return {path: _shape(v) for path, v in params.items()}


def param_pspecs(params, rules: ParallelismRules, mesh) -> dict:
    """``{path: spec}`` of every leaf, in the reference's flattening order for
    a model (its stacked leaves at their stacked shapes)."""
    return {path: leaf_pspec(path, shape, rules, mesh)
            for path, shape in _leaf_shapes(params).items()}


def batch_pspec(rules: ParallelismRules) -> tuple:
    """(B, S) token batches: batch over the DP axes (and S over tp_axis with
    sequence parallelism)."""
    return (rules.dp_axes, rules.tp_axis if rules.seq_parallel else None)


def cache_pspec(path, leaf, rules: ParallelismRules, mesh, *, seq_shard: bool) -> tuple:
    """The spec of one KV-cache leaf: batch over DP, KV heads over TP where
    they divide; with ``seq_shard`` the sequence dim over the DP axes
    instead."""
    keys = [k for k in _keys(path) if isinstance(k, str)]
    name = keys[-1] if keys else None
    shape = _shape(leaf)
    dp = rules.dp_axes

    def over(dim, axis):
        return axis if _divisible(dim, axis, mesh) else None

    if name in ("k", "v"):  # (B, S|window|patches, KV, hd) (+ repeat prefix)
        extra = len(shape) - 4
        b, s, kv, hd = shape[extra:]
        spec = [None] * extra
        spec += [None, over(s, dp)] if seq_shard else [over(b, dp), None]
        return tuple(spec + [over(kv, rules.tp_axis), None])
    if name == "latent":  # (B, S, r + rope)
        extra = len(shape) - 3
        b, s, r = shape[extra:]
        spec = [None] * extra
        spec += [None, over(s, dp), None] if seq_shard else [over(b, dp), None, None]
        return tuple(spec)
    if name == "ssm":  # (B, H, N, P)
        extra = len(shape) - 4
        b, h, n, p_ = shape[extra:]
        return tuple([None] * extra + [over(b, dp), over(h, rules.tp_axis), None, None])
    if name in ("conv_x", "conv_bc"):  # (B, K − 1, C)
        extra = len(shape) - 3
        b, k, cdim = shape[extra:]
        spec = [None] * extra + [over(b, dp), None]
        return tuple(spec + [over(cdim, rules.tp_axis) if name == "conv_x" else None])
    return ()


def spec_str(spec) -> str:
    """A spec as the reference's ``PartitionSpec`` prints it (one-name tuples
    shown as the name)."""
    entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)
    return f"PartitionSpec{entries!r}"


def _keystr(path) -> str:
    return "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]" for k in _keys(path))


def explain(params, rules: ParallelismRules, mesh) -> str:
    """A table of leaf → spec (replication fallbacks included), one line a
    leaf in the reference's format."""
    return "\n".join(f"{_keystr(path):60s} {str(shape):24s} "
                     f"{spec_str(leaf_pspec(path, shape, rules, mesh))}"
                     for path, shape in _leaf_shapes(params).items())


# ---------------------------------------------------------------------------
# Run time: whole-shard checks, cutting, the model axis's collectives
# ---------------------------------------------------------------------------


def _check_run_rules(rules: ParallelismRules) -> None:
    if rules.seq_parallel or not rules.tp_enabled or not rules.shard_vocab:
        raise NotImplementedError(
            f"{rules}: the run time takes model-axis tensor parallelism with the vocab sharded, "
            "FSDP over the data axis and the sequence-sharded decode cache; sequence "
            "parallelism in prefill (seq_parallel=True, tp_enabled=False, hill-climb cell C) "
            "is the next slice, ROADMAP.md §1, and a replicated vocab or weights run only as "
            "rules")


def _gqa_family(cfg) -> bool:
    from ..models.config import ATTN, ATTN_LOCAL, CROSS, SHARED_ATTN

    return bool({s.mixer for s in cfg.pattern} & {ATTN, ATTN_LOCAL, SHARED_ATTN, CROSS})


@functools.lru_cache(maxsize=None)
def whole_leaves(cfg, m: int) -> frozenset:
    """The leaf names the run time keeps whole on every rank at model axis
    ``m`` where the rules would cut a head or the vocab into parts that are
    not whole (the reference's partitioner splits them mid-head; its
    ``cache_pspec`` keeps such KV heads whole): ``tok`` and ``lm_head``
    where the vocab does not split, GQA's ``w_k`` and ``w_v`` where the KV
    heads do not (``m`` a multiple of them: each rank's query heads then
    read one KV head), and ``w_q`` too where the query heads do not (the
    rank runs every head and keeps its rows of the output for its block of
    ``w_o``). A whole weight's gradient is summed over the model axis."""
    if m == 1:
        return frozenset()
    out = set()
    if cfg.vocab_size % m:
        out |= {"tok", "lm_head"}
    if _gqa_family(cfg):
        if cfg.n_kv_heads % m:
            out |= {"w_k", "w_v"}
        if cfg.n_heads % m:
            out.add("w_q")
    return frozenset(out)


def is_whole(name: str, cfg) -> bool:
    """Whether this rank holds leaf ``name`` (``tok``, ``lm_head``, ``w_q``,
    ``w_k``, ``w_v``) whole where the rules cut it: :func:`whole_leaves` at
    the model axis of :func:`activation_sharding` (never outside it). The
    model code asks this, rather than compare shapes."""
    m = tp_index()[1]
    return m > 1 and name in whole_leaves(cfg, m)


def check_tp(cfg, m: int) -> None:
    """Raise ``ValueError`` unless ``cfg`` runs at model axis ``m`` in whole
    shards: where the pattern has them, the MLA heads, the FFN width
    (dense), the experts and the shared experts' width (MoE) and the SSM
    heads (Mamba-2, hence ``d_inner``) must each be a multiple of ``m``,
    and the SSM heads must read one B/C group (``ssm_groups = 1``). The
    GQA family's (GQA, shared and cross attention) KV heads must be a
    multiple of ``m`` or ``m`` a multiple of them, its query heads a
    multiple of ``m`` or, where they are not, its query width (heads ×
    head_dim) with the KV heads whole; a vocab that does not split is kept
    whole (:func:`whole_leaves`). Every
    mixer, FFN and a modality input run at ``m > 1``: the projected vision
    embeddings, the Mamba-2 leaves the reference keeps whole (``w_bc``,
    ``w_dt``, ``conv_bc_*``, ``dt_bias``, ``a_log``, ``d_skip``,
    ``w_out``), ``vision_proj`` and the cross gates are whole on every
    rank."""
    from ..models.config import ATTN, ATTN_LOCAL, CROSS, DENSE, MAMBA2, MLA, MOE, SHARED_ATTN
    from ..models.ssm import ssm_dims

    if m == 1:
        return
    mixers, ffns = {s.mixer for s in cfg.pattern}, {s.ffn for s in cfg.pattern}
    sizes = []
    if MAMBA2 in mixers:
        sizes.append(("SSM heads", ssm_dims(cfg)[1]))
    gqa = bool(mixers & {ATTN, ATTN_LOCAL, SHARED_ATTN, CROSS})
    kv_whole = gqa and cfg.n_kv_heads % m != 0 and m % cfg.n_kv_heads == 0
    if gqa and not kv_whole:
        sizes.append(("KV heads", cfg.n_kv_heads))
    if MLA in mixers or gqa and not (kv_whole and cfg.n_heads * cfg.head_dim % m == 0):
        sizes.append(("query heads", cfg.n_heads))
    if DENSE in ffns:
        sizes.append(("FFN width", cfg.d_ff))
    if MOE in ffns:
        sizes.append(("experts", cfg.n_experts))
        if cfg.n_shared_experts:
            sizes.append(("shared-expert width", cfg.n_shared_experts * cfg.d_ff_expert))
    for what, n in sizes:
        if n % m:
            raise ValueError(f"{cfg.name}: {n} {what} do not split into {m} whole shards; the "
                             "run time never splits a head or replicates a sharded dim")
    if MAMBA2 in mixers and cfg.ssm_groups > 1:
        raise ValueError(f"{cfg.name}: {cfg.ssm_groups} B/C groups; above model axis 1 the run "
                         "time takes one group, which every rank's SSM heads read whole")


def ref_path(name: str) -> tuple:
    """A port parameter name (model-level or block-relative) as the
    reference's key path: the norms' leaves are ``{"scale"}`` dicts there."""
    parts = tuple(name.split("."))
    return parts + ("scale",) if parts[-1] in ("norm1", "norm2", "final_norm") else parts


def _tp_dim(path, ndim: int, rules: ParallelismRules):
    # the dim (from the end) a layer's leaf lays out over the model axis, if any
    layout = _layout(path, ndim)
    dims = [i - len(layout) for i, sem in enumerate(layout or ())
            if _axis_for(sem, rules) == rules.tp_axis]
    return dims[-1] if dims else None


def _leaf_name(path) -> str:
    keys = [k for k in _keys(path) if isinstance(k, str)]
    return keys[-1] if keys else ""


def tp_cut(path, shape, rules: ParallelismRules, mesh, *, stack: int = 0,
           whole: frozenset = frozenset()):
    """``(dim, parts, index)`` of a whole tensor's block on the model axis
    (``dim`` counted from the end, ``index`` this rank's), or ``None`` for a
    replicated one or a leaf named in ``whole`` (:func:`whole_leaves`). The
    layout is that of the layer's own leaf: the dims after the first
    ``stack`` (a stack of layers). Raises where the rules would replicate a
    dim they lay out over the model axis."""
    layer = _shape(shape)[stack:]
    m = mesh.shape[rules.tp_axis]
    dim = _tp_dim(path, len(layer), rules)
    if dim is None or m == 1 or _leaf_name(path) in whole:
        return None
    if layer[dim] % m:
        raise ValueError(f"{'.'.join(map(str, _keys(path)))} {layer}: dim {layer[dim]} does "
                         f"not split over model axis {m}; the rules would replicate it")
    return dim, m, mesh.index(rules.tp_axis)


def tp_cuts(params, rules: ParallelismRules, mesh) -> dict:
    """``{path: (dim, parts, index)}`` of a model's stacked leaves on the
    model axis (``dim`` from the end holds for a stack too), read from the
    layout of each path's first layer; replicated leaves are left out. The
    model may be cut already: shapes are not read."""
    from ..convert import stacked_leaves

    rules = rules.with_mesh(mesh)
    m = mesh.shape[rules.tp_axis]
    if m == 1:
        return {}
    named = dict(params.named_parameters())
    whole = whole_leaves(params.cfg, m)
    out = {}
    for path, names in stacked_leaves(params, params.cfg):
        dim = _tp_dim(ref_path(names[0]), named[names[0]].dim(), rules)
        if dim is not None and _leaf_name(path) not in whole:
            out[path] = (dim, m, mesh.index(rules.tp_axis))
    return out


def tp_names(params, rules: ParallelismRules, mesh) -> frozenset:
    """The names of a model's parameters that are blocks on the model axis."""
    rules = rules.with_mesh(mesh)
    m = mesh.shape[rules.tp_axis]
    if m == 1:
        return frozenset()
    whole = whole_leaves(params.cfg, m)
    return frozenset(n for n, p in params.named_parameters()
                     if _tp_dim(ref_path(n), p.dim(), rules) is not None
                     and _leaf_name(ref_path(n)) not in whole)


def fsdp_cut(path, shape, rules: ParallelismRules, mesh, *, stack: int = 0):
    """``(dim, parts, index)`` of a whole tensor's block over the FSDP axes
    (``rules.fsdp_axes``, ``data``), or ``None``: the leaf's layout's
    ``fsdp`` dim where ``rules.fsdp`` holds and the axes divide it (else
    replicated, as the reference's ``_divisible``)."""
    if not rules.fsdp:
        return None
    layer = _shape(shape)[stack:]
    layout = _layout(path, len(layer))
    d = mesh.axis_size(rules.fsdp_axes)
    dims = [i - len(layout) for i, sem in enumerate(layout or ()) if sem == "fsdp"]
    if d == 1 or not dims or layer[dims[0]] % d:
        return None
    return dims[0], d, mesh.index(rules.fsdp_axes)


def fsdp_names(params) -> frozenset:
    """The names of a model's parameters that are FSDP blocks."""
    return frozenset(n for n, p in params.named_parameters() if hasattr(p, "fsdp_dim"))


def _cut_leaf(p, path, rules, mesh, whole):
    # a whole tensor's block on the model axis, then over the FSDP axes; the
    # FSDP dim (from the end) or None
    t = block(p, tp_cut(path, p.shape, rules, mesh, whole=whole))
    fcut = fsdp_cut(path, p.shape, rules, mesh)
    return block(t, fcut), (fcut[0] if fcut else None)


def block(t, cut):
    """The block ``cut`` (:func:`tp_cut`) of a tensor or numpy array, copied;
    ``t`` itself for ``None``."""
    if cut is None:
        return t
    dim, parts, index = cut
    n = t.shape[dim] // parts
    idx = [slice(None)] * t.ndim
    idx[dim] = slice(index * n, (index + 1) * n)
    b = t[tuple(idx)]
    return b.clone() if torch.is_tensor(b) else b.copy()


def shard_params(params, rules: ParallelismRules, mesh, *, cfg=None):
    """This rank's block of each leaf on the model axis and, with
    ``rules.fsdp``, over the FSDP axes (the counterpart of
    ``param_shardings``). ``params``: a :class:`~repro_torch.models.Transformer`,
    whose parameters are replaced in place by copies of their blocks (the
    whole tensors are freed; an FSDP block carries its dim from the end as
    ``fsdp_dim``), or a dict of port parameter names to tensors or numpy
    arrays, returned as a new dict of blocks (``cfg`` names the leaves kept
    whole, :func:`whole_leaves`)."""
    from torch import nn

    rules = rules.with_mesh(mesh)
    m = mesh.shape[rules.tp_axis]
    _check_run_rules(rules)
    if isinstance(params, nn.Module):
        check_tp(params.cfg, m)
        whole = whole_leaves(params.cfg, m)
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.data, dim = _cut_leaf(p.data, ref_path(name), rules, mesh, whole)
                if dim is not None:
                    p.fsdp_dim = dim
        return params
    whole = whole_leaves(cfg, m) if cfg is not None else frozenset()
    return {name: _cut_leaf(v, ref_path(name), rules, mesh, whole)[0]
            for name, v in params.items()}


def _init_layout_path(module, name: str, ndim: int) -> tuple:
    # the path _layout reads for a parameter registered on ``module``: the
    # expert stacks (>= 3-D) of a module that declares an ``expert_layout``
    # prefix by that layout, the rest by their own name
    prefix = getattr(module, "expert_layout", None)
    return (prefix, name) if prefix is not None and ndim >= 3 else ref_path(name)


@contextlib.contextmanager
def cut_at_init(mesh, rules: Optional[ParallelismRules] = None, cfg=None):
    """Within it, every parameter a module registers is cut at once to this
    rank's block on the model axis and over the FSDP axes, as
    :func:`shard_params` cuts it (``cfg`` names the leaves kept whole): a
    model drawn here is drawn leaf by leaf from its generator in the init
    order, each leaf whole, its block kept and the whole freed before the
    next draw, so its blocks equal a whole model's blocks bit for bit and
    the whole model never sits on the device (the counterpart of the
    reference placing its weights by ``param_shardings``). Used through
    :func:`~repro_torch.models.init_params`'s ``mesh=``."""
    from torch import nn

    rules = (rules or ParallelismRules()).with_mesh(mesh)
    m = mesh.shape[rules.tp_axis]
    if m == 1 and not (rules.fsdp and mesh.axis_size(rules.fsdp_axes) > 1):
        yield
        return
    _check_run_rules(rules)
    whole = whole_leaves(cfg, m) if cfg is not None else frozenset()

    def hook(module, name, p):
        if p is None:
            return None
        path, data = _init_layout_path(module, name, p.dim()), p.data
        with torch.no_grad():
            t, dim = _cut_leaf(data, path, rules, mesh, whole)
        if t is data:
            return None
        out = nn.Parameter(t, requires_grad=p.requires_grad)
        if dim is not None:
            out.fsdp_dim = dim
        return out

    handle = nn.modules.module.register_module_parameter_registration_hook(hook)
    try:
        yield
    finally:
        handle.remove()


def spec_block(t, spec, mesh):
    """This rank's block of a whole tensor (or numpy array) laid out by
    ``spec`` (one entry a dim: ``None``, an axis name or a tuple of names)
    on a :class:`Mesh`: each sharded dim cut into ``mesh.axis_size(axes)``
    equal blocks, this rank's at ``mesh.index(axes)``. Raises where a block
    would not be whole."""
    for dim, axes in enumerate(spec):
        if axes is None or mesh.axis_size(axes) == 1:
            continue
        parts = mesh.axis_size(axes)
        if t.shape[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {axes} ({parts})")
        t = block(t, (dim - t.ndim, parts, mesh.index(axes)))
    return t


def shard_cache(cache: dict, mesh: Mesh, rules: Optional[ParallelismRules] = None, *,
                seq_shard: bool = False) -> dict:
    """This rank's block of a whole serving cache (``{"layers": [...],
    "length"}``, each layer a dict of tensors): every leaf cut by its
    :func:`cache_pspec` (K/V batch over the data axes, KV heads over
    ``model``; MLA latents and Mamba-2 states by their rows and heads; with
    ``seq_shard`` the K/V sequence, or a ring's slots, over the data axes
    instead of the batch, and every other leaf's batch whole, as the batch
    is on every data rank: at the reference's batch of 1 that is
    ``cache_pspec``'s layout too), the run-time counterpart of the reference
    placing its cache by those specs. ``length`` is shared."""
    rules = (rules or ParallelismRules()).with_mesh(mesh)
    dp = rules.dp_axes

    def cut(name, t):
        spec = cache_pspec(name, t.shape, rules, mesh, seq_shard=seq_shard)
        if seq_shard and name in ("k", "v"):
            if spec[-3] is None and mesh.axis_size(dp) > 1:
                raise ValueError(f"{name} {tuple(t.shape)}: {t.shape[-3]} slots do not split "
                                 "over the data axes; a sequence-sharded cache takes whole "
                                 "blocks")
        elif seq_shard:
            spec = tuple(None if e == dp else e for e in spec)
        return spec_block(t, spec, mesh)

    layers = [{name: cut(name, t) for name, t in layer.items()} for layer in cache["layers"]]
    return {"layers": layers, "length": cache["length"]}


def shard_batch(x, mesh: Mesh, rules: Optional[ParallelismRules] = None):
    """A data rank's rows of a whole batch (a prompt (B, S), vision
    embeddings (B, P, d), ...): block ``mesh.index(dp_axes)`` of B over the
    data axes (:func:`batch_pspec`'s first entry). ``None`` passes through;
    a batch that does not split into whole blocks raises. (With the
    sequence-sharded cache the batch is whole on every data rank and does
    not pass here.)"""
    if x is None:
        return None
    rules = (rules or ParallelismRules()).with_mesh(mesh)
    return spec_block(x, (rules.dp_axes,), mesh)


@dataclasses.dataclass(frozen=True)
class _Context:
    mesh: Mesh
    rules: ParallelismRules
    per_shard: bool
    seq_shard: bool


_ACT: list = []  # the active contexts, innermost last


@contextlib.contextmanager
def activation_sharding(mesh: Mesh, rules: Optional[ParallelismRules] = None, *,
                        per_shard: bool = False, seq_shard: bool = False):
    """Run the model code on ``mesh``'s model axis: :func:`copy_to_tp` and
    :func:`reduce_from_tp` all-reduce over its group, :func:`tp_index` gives
    this rank's place. Wrap the forward and the backward both. Over the
    data axes the model computes what the reference's SPMD program computes
    over the global batch (:func:`global_batch_group`), or with
    ``per_shard`` what its ``shard_map`` over the data axes computes on each
    rank's rows alone. With ``seq_shard`` the batch is whole on every data
    rank and the K/V caches are cut over the sequence instead
    (:func:`seq_cut`; serving only: the reference's ``long_500k`` cell)."""
    rules = (rules or ParallelismRules()).with_mesh(mesh)
    if mesh.shape[rules.tp_axis] > 1:
        _check_run_rules(rules)
    _ACT.append(_Context(mesh, rules, per_shard, seq_shard))
    try:
        yield
    finally:
        _ACT.pop()


def tp_group():
    """The model axis's process group under :func:`activation_sharding`;
    ``None`` outside it or at model axis 1."""
    if not _ACT:
        return None
    ctx = _ACT[-1]
    return ctx.mesh.group(ctx.rules.tp_axis)


def tp_index() -> Tuple[int, int]:
    """``(this rank's index, size)`` along the model axis (``(0, 1)`` outside
    :func:`activation_sharding`)."""
    if not _ACT:
        return 0, 1
    ctx = _ACT[-1]
    return ctx.mesh.index(ctx.rules.tp_axis), ctx.mesh.shape[ctx.rules.tp_axis]


def dp_index() -> Tuple[int, int]:
    """``(this rank's index, size)`` of the batch's split over the
    data-parallel axes under :func:`activation_sharding`; ``(0, 1)`` outside
    it, and with ``seq_shard``, where every data rank holds the whole
    batch."""
    if not _ACT or _ACT[-1].seq_shard:
        return 0, 1
    ctx = _ACT[-1]
    return ctx.mesh.index(ctx.rules.dp_axes), ctx.mesh.axis_size(ctx.rules.dp_axes)


def global_batch_group():
    """The data axes' process group where the model computes over the global
    batch, as the reference's SPMD program does (:func:`activation_sharding`
    without ``per_shard``, data axes of size > 1): the MoE dispatch and the
    aux loss then read the other data ranks' routing. ``None`` outside the
    context, per shard, with one data rank, or with ``seq_shard`` (every
    data rank holds the whole batch)."""
    if not _ACT:
        return None
    ctx = _ACT[-1]
    if ctx.per_shard or ctx.seq_shard or ctx.mesh.axis_size(ctx.rules.dp_axes) == 1:
        return None
    return ctx.mesh.group(ctx.rules.dp_axes)


def seq_group():
    """The data axes' process group over which a sequence-sharded cache's
    blocks combine (:func:`activation_sharding` with ``seq_shard``, data axes
    of size > 1); ``None`` otherwise."""
    if not _ACT or not _ACT[-1].seq_shard:
        return None
    ctx = _ACT[-1]
    return ctx.mesh.group(ctx.rules.dp_axes)


def seq_place() -> Tuple[int, int, object]:
    """``(index, d, group)``: this rank's place among the ``d`` data ranks
    over which a sequence-sharded cache is cut (:func:`activation_sharding`
    with ``seq_shard``), and their group; ``(0, 1, None)`` outside such a
    context or at one data rank."""
    group = seq_group()
    if group is None:
        return 0, 1, None
    ctx = _ACT[-1]
    return ctx.mesh.index(ctx.rules.dp_axes), ctx.mesh.axis_size(ctx.rules.dp_axes), group


def seq_cut(n: int) -> Tuple[int, int, object]:
    """``(start, size, group)`` of this rank's block of ``n`` cache slots (a
    K/V cache's positions, a ring's slots): block ``index`` of ``d`` equal
    blocks (:func:`seq_place`; :func:`cache_pspec`'s sequence entry);
    ``(0, n, None)`` outside a sequence-sharded context. Slots that do not
    split into ``d`` whole blocks raise ``ValueError`` (the rules would keep
    them whole on every rank, a layout the sequence-sharded decode does not
    run)."""
    index, d, group = seq_place()
    if n % d:
        raise ValueError(f"{n} cache slots do not split over the data axes ({d} ranks); a "
                         "sequence-sharded cache takes whole blocks")
    return index * (n // d), n // d, group


def check_seq_shard(cfg) -> None:
    """Raise ``NotImplementedError`` where a sequence-sharded cache meets a
    mixer whose cache the run time does not cut over the sequence: MLA's
    latent and the cross K/V (no ``long_500k`` cell runs either)."""
    from ..models.config import CROSS, MLA

    if seq_group() is None:
        return
    mixers = {s.mixer for s in cfg.pattern} & {MLA, CROSS}
    if mixers:
        raise NotImplementedError(
            f"{cfg.name}: the sequence-sharded decode cache cuts GQA K/V caches only; "
            f"{sorted(mixers)} under seq_shard are open items of ROADMAP.md §1")


def gather_tp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model axis's blocks of ``x`` along ``dim`` joined in shard order
    (rank ``i``'s block at ``i``): one all-reduce of each rank's block
    placed into zeros, which is the concatenation bit for bit (the blocks
    are disjoint; gloo carries all-reduces of CUDA tensors). ``x`` itself
    outside :func:`activation_sharding` or at model axis 1."""
    index, parts = tp_index()
    if parts == 1:
        return x
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * parts
    out = x.new_zeros(shape)
    out.narrow(dim, index * n, n).copy_(x)
    dist.all_reduce(out, group=tp_group())
    return out


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """Sum of the ranks' partial outputs forward; identity backward (the
    gradient downstream is already the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverTP(torch.autograd.Function):
    """Sum of the ranks' partial values forward and backward: every rank
    reads the sum, so each rank's part takes the gradient summed over the
    ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """The model axis's blocks joined along ``dim`` (:func:`gather_tp`)
    forward; backward, this rank's block of the gradient, which is the
    whole one on every rank (the product that reads the joined tensor is
    computed whole on each)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        return gather_tp(x, dim)

    @staticmethod
    def backward(ctx, g):
        index = tp_index()[0]
        return g.narrow(ctx.dim, index * ctx.n, ctx.n).contiguous(), None


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """Mark a replicated input of a column-sharded product, or a whole tensor
    of which a rank reads its part: its gradient is summed over the model
    axis."""
    group = tp_group()
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """Sum the partial outputs of a row-sharded product over the model axis."""
    group = tp_group()
    return x if group is None else _ReduceFromTP.apply(x, group)


def sum_over_tp(x: torch.Tensor) -> torch.Tensor:
    """Sum the ranks' partial values over the model axis where every rank
    then reads the sum (a norm's sum of squares over a channel block)."""
    group = tp_group()
    return x if group is None else _SumOverTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Join the model axis's blocks of ``x`` along ``dim`` for a whole weight
    to read; the backward keeps this rank's block of the gradient."""
    return x if tp_group() is None else _GatherFromTP.apply(x, dim)


# ---------------------------------------------------------------------------
# FSDP at run time: a leaf's block over the data axis gathered where it is used
# ---------------------------------------------------------------------------


def fsdp_group():
    """The FSDP axes' process group under :func:`activation_sharding` with
    ``rules.fsdp`` and more than one data rank; ``None`` otherwise."""
    if not _ACT:
        return None
    ctx = _ACT[-1]
    if not ctx.rules.fsdp or ctx.mesh.axis_size(ctx.rules.fsdp_axes) == 1:
        return None
    return ctx.mesh.group(ctx.rules.fsdp_axes)


class _GatherFSDP(torch.autograd.Function):
    """The FSDP axes' blocks of a leaf joined along ``dim`` (from the end)
    forward, one ``all_gather_into_tensor``; backward, the gradient's block
    summed over the ranks, one ``reduce_scatter_tensor`` (gloo takes both on
    CUDA tensors as on the CPU)."""

    @staticmethod
    def forward(ctx, p, dim, group):
        ctx.dim, ctx.group = dim, group
        parts = dist.get_world_size(group)
        x = p.movedim(dim, 0).contiguous()
        out = x.new_empty((parts * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        parts = dist.get_world_size(ctx.group)
        x = g.movedim(ctx.dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // parts, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def fsdp_param(p: torch.Tensor) -> torch.Tensor:
    """The whole (model-axis block of a) leaf for an FSDP block ``p``
    (one that carries ``fsdp_dim``): gathered over the FSDP axes, its
    gradient reduce-scattered, summed; any other tensor as it is."""
    dim = getattr(p, "fsdp_dim", None)
    if dim is None:
        return p
    group = fsdp_group()
    if group is None:
        raise ValueError("an FSDP block is read outside activation_sharding with FSDP rules")
    return _GatherFSDP.apply(p, dim, group)


@contextlib.contextmanager
def fsdp_gathered(*modules):
    """Within it, the FSDP blocks of ``modules`` (and their submodules) read
    as their gathered leaves (:func:`fsdp_param`), once each; on exit the
    blocks are back and the gathered leaves are freed, but for what autograd
    saves. A block's forward runs inside it; under ``remat`` the unit's
    recomputation runs it again, so the backward gathers again."""
    swapped = []
    try:
        for mod in modules:
            for sub in mod.modules():
                for name, p in list(sub._parameters.items()):
                    if p is not None and hasattr(p, "fsdp_dim"):
                        swapped.append((sub, name, p))
                        sub._parameters[name] = fsdp_param(p)
        yield
    finally:
        for sub, name, p in swapped:
            sub._parameters[name] = p
