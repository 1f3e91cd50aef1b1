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
model code calls two autograd Functions where the reference calls
``shard_act``: :func:`copy_to_tp` (identity forward, all-reduce backward)
before a column-sharded product, :func:`reduce_from_tp` (all-reduce
forward, identity backward) after a row-sharded one. Both are the identity
outside :func:`activation_sharding` or at model axis 1.

* Each layer is a leaf of its own in the port, so a layer's tensors take
  the rules of an unscanned layer: ``w_q``, ``w_k``, ``w_v``, ``w_gate``,
  ``w_up`` columns, ``w_o``, ``w_down`` rows, ``tok`` and ``lm_head`` the
  vocab. (The reference's rules read a scanned dense FFN stack (L, D, F)
  as MoE experts by its rank and put its layer axis over ``model``;
  :func:`param_pspecs` returns those specs as they are.)
* The run time takes only the dense stack (``ATTN``, ``ATTN_LOCAL``, dense
  FFN) and only whole shards: whole heads, equal FFN and vocab blocks
  (:func:`check_tp`). Where the rules would replicate a dim they lay out
  over ``model``, or a block would split a head, it raises; it never runs
  a replicated weight as though it were split.
* The context is a module global, not a context variable: the autograd
  engine's device threads run the backward and ``torch.utils.checkpoint``'s
  recomputation, which must see it too.

**Serving** runs under the same context. A data rank holds its rows of the
batch (:func:`shard_batch`) and of every cache; a model rank holds its KV
heads of every K/V cache (:func:`shard_cache`, the run-time cut of
:func:`cache_pspec`). The logits' vocab shards are gathered in shard order
before sampling (:func:`gather_tp`), and :func:`dp_index` tells the
sampling and the compressed cache's sketch draws which rows of the whole
batch are this rank's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "ParallelismRules", "activation_sharding", "batch_pspec", "block",
           "cache_pspec", "check_tp", "copy_to_tp", "dp_index", "explain", "gather_tp",
           "leaf_pspec", "param_pspecs", "reduce_from_tp", "ref_path", "shard_batch",
           "shard_cache", "shard_params", "spec_block", "spec_str", "tp_cut", "tp_cuts",
           "tp_group", "tp_index", "tp_names"]


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
    if rules.fsdp or rules.seq_parallel or not rules.tp_enabled or not rules.shard_vocab:
        raise NotImplementedError(
            f"{rules}: the run time takes the default rules (model-axis tensor parallelism, "
            "vocab sharded); FSDP, sequence parallelism and a replicated vocab run only as "
            "rules (ROADMAP.md §1)")


def check_tp(cfg, m: int) -> None:
    """Raise unless ``cfg`` runs at model axis ``m`` in whole shards: only
    the dense stack (``ATTN``, ``ATTN_LOCAL``, dense FFN, no shared or
    cross attention, no modality input) at ``m > 1``, with the query and
    KV heads, the FFN width and the vocab each a multiple of ``m``."""
    from ..models.config import ATTN, ATTN_LOCAL, DENSE

    if m == 1:
        return
    kinds = sorted({(s.mixer, s.ffn) for s in cfg.pattern})
    if any(mx not in (ATTN, ATTN_LOCAL) or f != DENSE for mx, f in kinds) or cfg.d_vision:
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism at model axis {m} runs the dense stack only "
            f"(ATTN, ATTN_LOCAL, dense FFN); its blocks are {kinds}. MoE, MLA, Mamba-2, "
            "shared and cross attention wait in ROADMAP.md §1")
    for what, n in (("query heads", cfg.n_heads), ("KV heads", cfg.n_kv_heads),
                    ("FFN width", cfg.d_ff), ("vocab", cfg.vocab_size)):
        if n % m:
            raise ValueError(f"{cfg.name}: {n} {what} do not split into {m} whole shards; the "
                             "run time never splits a head or replicates a sharded dim")


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


def tp_cut(path, shape, rules: ParallelismRules, mesh, *, stack: int = 0):
    """``(dim, parts, index)`` of a whole tensor's block on the model axis
    (``dim`` counted from the end, ``index`` this rank's), or ``None`` for a
    replicated one. The layout is that of the layer's own leaf: the dims
    after the first ``stack`` (a stack of layers). Raises where the rules
    would replicate a dim they lay out over the model axis."""
    layer = _shape(shape)[stack:]
    m = mesh.shape[rules.tp_axis]
    dim = _tp_dim(path, len(layer), rules)
    if dim is None or m == 1:
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
    out = {}
    for path, names in stacked_leaves(params, params.cfg):
        dim = _tp_dim(ref_path(names[0]), named[names[0]].dim(), rules)
        if dim is not None:
            out[path] = (dim, m, mesh.index(rules.tp_axis))
    return out


def tp_names(params, rules: ParallelismRules, mesh) -> frozenset:
    """The names of a model's parameters that are blocks on the model axis."""
    rules = rules.with_mesh(mesh)
    if mesh.shape[rules.tp_axis] == 1:
        return frozenset()
    return frozenset(n for n, p in params.named_parameters()
                     if _tp_dim(ref_path(n), p.dim(), rules) is not None)


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


def shard_params(params, rules: ParallelismRules, mesh):
    """This rank's block of each leaf on the model axis (the counterpart of
    ``param_shardings``). ``params``: a :class:`~repro_torch.models.Transformer`,
    whose parameters are replaced in place by copies of their blocks (the
    whole tensors are freed), or a dict of port parameter names to tensors
    or numpy arrays, returned as a new dict of blocks."""
    from torch import nn

    rules = rules.with_mesh(mesh)
    if mesh.shape[rules.tp_axis] > 1:
        _check_run_rules(rules)
    if isinstance(params, nn.Module):
        check_tp(params.cfg, mesh.shape[rules.tp_axis])
        with torch.no_grad():
            for name, p in params.named_parameters():
                cut = tp_cut(ref_path(name), p.shape, rules, mesh)
                if cut is not None:
                    p.data = block(p.data, cut)
        return params
    return {name: block(v, tp_cut(ref_path(name), _shape(v), rules, mesh))
            for name, v in params.items()}


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


def shard_cache(cache: dict, mesh: Mesh, rules: Optional[ParallelismRules] = None) -> dict:
    """This rank's block of a whole serving cache (``{"layers": [...],
    "length"}``, each layer a dict of tensors): every leaf cut by its
    :func:`cache_pspec` (K/V batch over the data axes, KV heads over
    ``model``; MLA latents and Mamba-2 states by their rows and heads), the
    run-time counterpart of the reference placing its cache by those specs.
    ``length`` is shared."""
    rules = (rules or ParallelismRules()).with_mesh(mesh)
    layers = [{name: spec_block(t, cache_pspec(name, t.shape, rules, mesh, seq_shard=False), mesh)
               for name, t in layer.items()} for layer in cache["layers"]]
    return {"layers": layers, "length": cache["length"]}


def shard_batch(x, mesh: Mesh, rules: Optional[ParallelismRules] = None):
    """A data rank's rows of a whole batch (a prompt (B, S), vision
    embeddings (B, P, d), ...): block ``mesh.index(dp_axes)`` of B over the
    data axes (:func:`batch_pspec`'s first entry). ``None`` passes through;
    a batch that does not split into whole blocks raises."""
    if x is None:
        return None
    rules = (rules or ParallelismRules()).with_mesh(mesh)
    return spec_block(x, (rules.dp_axes,), mesh)


_ACT: list = []  # the active (mesh, rules), innermost last


@contextlib.contextmanager
def activation_sharding(mesh: Mesh, rules: Optional[ParallelismRules] = None):
    """Run the model code on ``mesh``'s model axis: :func:`copy_to_tp` and
    :func:`reduce_from_tp` all-reduce over its group, :func:`tp_index` gives
    this rank's place. Wrap the forward and the backward both."""
    rules = (rules or ParallelismRules()).with_mesh(mesh)
    if mesh.shape[rules.tp_axis] > 1:
        _check_run_rules(rules)
    _ACT.append((mesh, rules))
    try:
        yield
    finally:
        _ACT.pop()


def tp_group():
    """The model axis's process group under :func:`activation_sharding`;
    ``None`` outside it or at model axis 1."""
    if not _ACT:
        return None
    mesh, rules = _ACT[-1]
    return mesh.group(rules.tp_axis)


def tp_index() -> Tuple[int, int]:
    """``(this rank's index, size)`` along the model axis (``(0, 1)`` outside
    :func:`activation_sharding`)."""
    if not _ACT:
        return 0, 1
    mesh, rules = _ACT[-1]
    return mesh.index(rules.tp_axis), mesh.shape[rules.tp_axis]


def dp_index() -> Tuple[int, int]:
    """``(this rank's index, size)`` along the data-parallel axes under
    :func:`activation_sharding` (``(0, 1)`` outside it)."""
    if not _ACT:
        return 0, 1
    mesh, rules = _ACT[-1]
    return mesh.index(rules.dp_axes), mesh.axis_size(rules.dp_axes)


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


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """Mark a replicated input of a column-sharded product."""
    group = tp_group()
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """Sum the partial outputs of a row-sharded product over the model axis."""
    group = tp_group()
    return x if group is None else _ReduceFromTP.apply(x, group)
