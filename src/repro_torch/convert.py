"""Carry the reference's state into the port.

The JAX package's sketches and index sets, handed over as numpy arrays,
become the port's objects on a chosen device, so both packages run on the
same randomness. Nothing here imports the reference: the caller does the
JAX → numpy step (``np.asarray``). A bfloat16 array (numpy's ``ml_dtypes``
bfloat16, which torch cannot wrap) arrives as a torch bfloat16 tensor, its
bits viewed as ``uint16`` on the way (never rounded through another type).

The serving slice adds the model and its caches: :func:`model_params`
(a reference parameter pytree → the port's :class:`~repro_torch.models.Transformer`,
laid out by :func:`model_state`: every block's leaves, MoE's nested
experts, Mamba-2's fp32 ``dt_bias``/``a_log``/``d_skip`` beside its bf16
matrices, the cross gate, and the model-level ``shared`` GQA and
``vision_proj``), :func:`dense_cache` (a reference prefill cache → the
port's per-layer cache: K/V, MLA latents, Mamba-2 conv windows and fp32
state, cross K/V) and :func:`compressed_kv_sketches` (a reference ``CompressedKV``'s
engine sketches → the port's stacked sketches).

The training slice adds :func:`stacked_leaves` (the port's per-layer
parameters grouped into the reference's scan stacks, in its flattening
order: gradient compression sketches each group as one leaf),
:func:`train_state` (a reference train state → the port's) and
:func:`error_state` (one worker's EF residuals).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.sketching import (
    ComposedSketch,
    CountSketch,
    GaussianSketch,
    OSNAPSketch,
    RowSampling,
    SRHTSketch,
)
from .device import DeviceLike, resolve_device
from .distributed.sharding import ref_path

__all__ = ["to_tensor", "indices", "sketch_arrays", "sketch_from_arrays", "sketch_pair",
           "spsvd_sketches", "telemetry_frame", "stream_init_inputs", "model_state", "model_params",
           "dense_cache", "stacked_spsvd_sketches", "compressed_kv_sketches", "stacked_leaves",
           "train_state", "error_state"]

# family name of a reference sketch class -> (kind, fields to carry)
_FIELDS = {
    "GaussianSketch": ("gaussian", ("mat",)),
    "CountSketch": ("countsketch", ("hashes", "signs", "s")),
    "OSNAPSketch": ("osnap", ("hashes", "signs", "s")),
    "SRHTSketch": ("srht", ("signs", "row_idx", "m", "m_pad")),
    "RowSampling": ("rowsampling", ("idx", "scale", "m")),
}


def to_tensor(x, device: DeviceLike = None, dtype=None) -> torch.Tensor:
    """A fresh tensor on ``device`` holding the numpy array ``x``, in its own
    dtype unless ``dtype`` is given."""
    arr = np.array(x, copy=True)
    if arr.dtype.name == "bfloat16":  # the same 16 bits, viewed
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=resolve_device(device), dtype=dtype or t.dtype)


def indices(x, device: DeviceLike = None) -> torch.Tensor:
    """An index set, or a batch of them (B, c), as an int32 tensor."""
    return to_tensor(np.asarray(x), device, torch.int32)


def sketch_arrays(S) -> tuple:
    """``(kind, arrays)`` of a reference sketch object, read by its class
    name and attributes (``np.asarray`` of each), for :func:`sketch_from_arrays`."""
    name = type(S).__name__
    if name == "ComposedSketch":
        return "composed", {"inner": sketch_arrays(S.inner), "outer": sketch_arrays(S.outer)}
    kind, fields = _FIELDS[name]
    return kind, {f: np.asarray(getattr(S, f)) for f in fields}


def sketch_from_arrays(kind: str, arrays: dict, device: DeviceLike = None):
    """The port's sketch of family ``kind`` from the reference's arrays.

    ``arrays`` holds, by ``kind``:

    * ``gaussian``: ``{"mat": (s, m)}``, kept in its own dtype;
    * ``countsketch`` / ``osnap``: ``{"hashes": (m,) or (p, m), "signs": same, "s": int}``;
    * ``srht``: ``{"signs": (m_pad,), "row_idx": (s,), "m": int, "m_pad": int}``;
    * ``rowsampling`` (the reference's ``uniform``/``leverage`` draws):
      ``{"idx": (s,), "scale": (s,), "m": int}``;
    * ``composed``: ``{"inner": (kind, arrays), "outer": (kind, arrays)}``.
    """
    if kind == "gaussian":
        return GaussianSketch(to_tensor(arrays["mat"], device))
    if kind == "srht":
        return SRHTSketch(signs=to_tensor(arrays["signs"], device),
                          row_idx=to_tensor(arrays["row_idx"], device, torch.int64),
                          m=int(arrays["m"]), m_pad=int(arrays["m_pad"]))
    if kind == "rowsampling":
        return RowSampling(idx=to_tensor(arrays["idx"], device, torch.int64),
                           scale=to_tensor(arrays["scale"], device), m=int(arrays["m"]))
    if kind == "composed":
        return ComposedSketch(inner=sketch_from_arrays(*arrays["inner"], device=device),
                              outer=sketch_from_arrays(*arrays["outer"], device=device))
    if kind not in ("countsketch", "osnap"):
        raise ValueError(f"unknown sketch kind {kind!r}")
    hashes = to_tensor(arrays["hashes"], device, torch.int32)
    signs = to_tensor(arrays["signs"], device, torch.float32)
    s = int(arrays["s"])
    if kind == "countsketch":
        return CountSketch(hashes=hashes, signs=signs, s=s)
    return OSNAPSketch(hashes=hashes, signs=signs, s=s, p=hashes.shape[0])


def sketch_pair(pair, device: DeviceLike = None) -> tuple:
    """The port's copy of a tuple of reference sketches, e.g. the RowSampling
    pair of the reference's ``leverage_sampling_sketches``."""
    return tuple(sketch_from_arrays(*sketch_arrays(S), device=device) for S in pair)


def spsvd_sketches(sk, device: DeviceLike = None):
    """The port's :class:`~repro_torch.core.svd.SPSVDSketches` from a
    reference SP-SVD state's ``ctx`` (its Ω and S_R already padded to whole
    panels; the port's ``pad_cols`` leaves them as they are)."""
    from .core.svd import SPSVDSketches

    return SPSVDSketches(**{f.name: sketch_from_arrays(*sketch_arrays(getattr(sk, f.name)),
                                                       device=device)
                            for f in dataclasses.fields(SPSVDSketches)})


_FRAME_ARRAYS = ("admitted", "evicted", "rows_admitted", "occupancy", "events", "panel_scores",
                 "panel_energy", "energy_mass", "psi", "omega", "panels_seen")


def telemetry_frame(tel, device: DeviceLike = None):
    """The port's :class:`~repro_torch.obs.telemetry.TelemetryFrame` holding a
    reference frame's arrays (read by attribute, ``np.asarray`` of each) and
    its ``panel`` and ``n``."""
    from .obs.telemetry import TelemetryFrame

    return TelemetryFrame(**{f: to_tensor(np.asarray(getattr(tel, f)), device)
                             for f in _FRAME_ARRAYS}, panel=int(tel.panel), n=int(tel.n))


def stream_init_inputs(state, device: DeviceLike = None) -> dict:
    """Keyword arguments that hand a reference streaming state's randomness
    to the matching port init: ``sketches``, its core sketch pair (``S_C``,
    ``S_R`` or the SPSD ``S1``, ``S2``, the right one cut back to the true
    column count), and ``tel_omega``, its frame's Ω_test, when it has one."""
    ctx = state.ctx
    left, right = (ctx.S_C, ctx.S_R) if hasattr(ctx, "S_C") else (ctx.S1, ctx.S2)
    out = {"sketches": (sketch_from_arrays(*sketch_arrays(left), device=device),
                        sketch_from_arrays(*sketch_arrays(right.cols(0, state.n)),
                                           device=device))}
    if getattr(state, "tel", None) is not None:
        out["tel_omega"] = to_tensor(np.asarray(state.tel.omega), device)
    return out


def _unstack(tree, reps: int) -> list:
    """A per-repeat list of a reference pytree of numpy arrays stacked on
    a leading repeat axis (a scanned segment's), or ``[tree]``."""
    if reps == 1:
        return [tree]
    if isinstance(tree, dict):
        parts = {k: _unstack(v, reps) for k, v in tree.items()}
        return [{k: v[r] for k, v in parts.items()} for r in range(reps)]
    arr = np.asarray(tree)
    return [arr[r] for r in range(reps)]


def _flatten(prefix: str, tree, out: dict) -> None:
    """A nested dict's leaves into ``out`` under dotted names below ``prefix``
    (``""``: the top-level names)."""
    for name, v in tree.items():
        key = f"{prefix}.{name}" if prefix else name
        if isinstance(v, dict):
            _flatten(key, v, out)
        else:
            out[key] = v


def model_state(np_params, cfg) -> dict:
    """The port's state-dict names → the reference's leaves (numpy arrays;
    zero-stride ``np.broadcast_to`` views stand in for shapes alone): scanned
    segments' leaves unstacked along their leading repeat axis, in
    ``segments(cfg)`` order, into one block per layer; nested dicts (MoE's
    ``shared`` experts, the model's ``shared`` GQA) flattened into dotted
    names; a ``SHARED_ATTN`` block's empty mixer holds no leaf."""
    from .models.transformer import segments

    state = {"embed.tok": np_params["embed"]["tok"], "final_norm": np_params["final_norm"]["scale"]}
    if "lm_head" in np_params["embed"]:
        state["embed.lm_head"] = np_params["embed"]["lm_head"]
    if "shared" in np_params:
        _flatten("shared", np_params["shared"], state)
    if "vision_proj" in np_params:
        state["vision_proj"] = np_params["vision_proj"]
    layer = 0
    for seg, seg_params in zip(segments(cfg), np_params["segments"]):
        per_pos = [_unstack(p, seg.n_repeat) for p in seg_params]
        for rep in range(seg.n_repeat):
            for pos in range(len(seg.unit)):
                p = per_pos[pos][rep]
                state[f"blocks.{layer}.norm1"] = p["norm1"]["scale"]
                _flatten(f"blocks.{layer}.mixer", p["mixer"], state)
                if "norm2" in p:
                    state[f"blocks.{layer}.norm2"] = p["norm2"]["scale"]
                    _flatten(f"blocks.{layer}.ffn", p["ffn"], state)
                layer += 1
    return state


def model_params(np_params, cfg, device: DeviceLike = None, *, mesh=None):
    """The port's :class:`~repro_torch.models.Transformer` holding a
    reference parameter pytree (leaves as numpy arrays, ``ml_dtypes``
    bfloat16 included), laid out by :func:`model_state`; every tensor keeps
    its dtype and bits (MoE's fp32 router beside bf16 experts included).
    With a ``mesh``, its rank's block of each leaf on the model axis
    (:func:`~repro_torch.distributed.shard_params`)."""
    from .distributed.sharding import ParallelismRules, shard_params
    from .models.transformer import Transformer

    dev = resolve_device(device)
    state = model_state(np_params, cfg)
    model = Transformer(torch.Generator(), cfg, torch.device("meta"))
    if mesh is not None:
        state = shard_params(state, ParallelismRules(), mesh)
        shard_params(model, ParallelismRules(), mesh)
    model.load_state_dict({k: to_tensor(v, dev) for k, v in state.items()}, assign=True)
    return model


def dense_cache(ref_cache, cfg, device: DeviceLike = None) -> dict:
    """The port's ``{"layers": [...], "length": 0-d int32}`` from a reference
    prefill cache (``{"segments": ..., "length"}``, leaves as numpy),
    unstacking scanned segments into one cache per layer (K/V dicts, MLA's
    ``{"latent": ...}``, Mamba-2's ``{"conv_x", "conv_bc", "ssm"}``), every
    leaf in its own dtype."""
    from .models.transformer import segments

    dev = resolve_device(device)
    layers = []
    for seg, seg_cache in zip(segments(cfg), ref_cache["segments"]):
        per_pos = [_unstack(c, seg.n_repeat) for c in seg_cache]
        for rep in range(seg.n_repeat):
            for pos in range(len(seg.unit)):
                layers.append({k: to_tensor(v, dev) for k, v in per_pos[pos][rep].items()})
    return {"layers": layers, "length": torch.full((), int(np.asarray(ref_cache["length"])),
                                                    dtype=torch.int32, device=dev)}


def stacked_spsvd_sketches(sk, device: DeviceLike = None):
    """The port's :class:`~repro_torch.core.svd.StackedSPSVDSketches` from a
    ``vmap``-ped reference SP-SVD ``ctx`` (per-head engines drawn under
    ``vmap``), its leading axes flattened row-major into the head axis."""
    from .core.sketching import StackedOSNAPSketch
    from .core.svd import OSNAP_FIELDS, StackedSPSVDSketches

    def heads(x, tail: int, dtype=None):
        x = np.asarray(x)
        return to_tensor(x.reshape((-1,) + x.shape[x.ndim - tail:]), device, dtype)

    osnaps = {f: StackedOSNAPSketch(hashes=heads(getattr(sk, f).hashes, 2, torch.int32),
                                    signs=heads(getattr(sk, f).signs, 2, torch.float32),
                                    s=int(getattr(sk, f).s))
              for f in OSNAP_FIELDS}
    return StackedSPSVDSketches(**osnaps, g_r=heads(sk.g_r.mat, 2), g_c=heads(sk.g_c.mat, 2))


def compressed_kv_sketches(ckv, device: DeviceLike = None) -> tuple:
    """``(k_sketches, v_sketches)``: :func:`stacked_spsvd_sketches` of a
    reference ``CompressedKV``'s K and V engines (leading axes (B, KV), or
    (n_repeat, B, KV) for a scanned segment)."""
    return tuple(stacked_spsvd_sketches(eng.ctx, device) for eng in (ckv.k_eng, ckv.v_eng))


def stacked_leaves(model, cfg) -> list:
    """``[(path, names)]``: each leaf of the reference's parameter pytree, in
    its ``jax.tree.flatten`` order (dict keys sorted, segments and unit
    positions in order), as a dotted path (``"segments.0.0.ffn.w_up"``)
    and the port parameter names it holds: one name for an unscanned
    leaf, a scanned segment's ``n_repeat`` layers (the stack's order)
    otherwise."""
    from .models.transformer import segments

    names = [n for n, _ in model.named_parameters()]
    top = sorted((n for n in names if not n.startswith("blocks.")), key=ref_path)
    out = [(".".join(ref_path(n)), [n]) for n in top if ref_path(n)[0] < "segments"]
    layer = 0
    for si, seg in enumerate(segments(cfg)):
        U = len(seg.unit)
        for pos in range(U):
            layers = [layer + r * U + pos for r in range(seg.n_repeat)]
            first = f"blocks.{layers[0]}."
            rel = sorted((n[len(first):] for n in names if n.startswith(first)), key=ref_path)
            out += [(f"segments.{si}.{pos}." + ".".join(ref_path(r)),
                     [f"blocks.{i}.{r}" for i in layers]) for r in rel]
        layer += seg.n_repeat * U
    out += [(".".join(ref_path(n)), [n]) for n in top if ref_path(n)[0] > "segments"]
    return out


def train_state(np_state, cfg, device: DeviceLike = None, *, mesh=None) -> dict:
    """The port's train state ``{"params": Transformer, "opt": {"m", "v":
    {name: tensor}, "step"[, "master"]}}`` from the reference's (leaves as
    numpy arrays): the parameters by :func:`model_params`, each moment tree
    unstacked by :func:`model_state` the same way; with a ``mesh``, each
    leaf's block on the model axis."""
    from .distributed.sharding import ParallelismRules, shard_params

    dev = resolve_device(device)
    opt = np_state["opt"]
    cut = ((lambda t: shard_params(t, ParallelismRules(), mesh)) if mesh is not None
           else (lambda t: t))
    out = {k: {n: to_tensor(v, dev) for n, v in cut(model_state(opt[k], cfg)).items()}
           for k in ("m", "v", "master") if k in opt}
    out["step"] = to_tensor(np.asarray(opt["step"]), dev, torch.int32)
    return {"params": model_params(np_state["params"], cfg, dev, mesh=mesh), "opt": out}


def error_state(np_err, cfg, rank: int = None, device: DeviceLike = None, *, mesh=None) -> dict:
    """Worker ``rank``'s EF residuals ``{path: fp32 tensor}`` (the port's
    per-rank state) from the reference's ``err`` tree, whose leaves carry a
    leading worker dimension (the data axes'); the reference's placeholders
    of the leaves it does not compress ((workers, 1)) are left out. With a
    ``mesh``, the worker is its data-parallel index (unless ``rank`` is
    given) and each residual its block on the model axis."""
    from .distributed.sharding import ParallelismRules, block, tp_cut
    from .models.transformer import Transformer

    if mesh is not None:
        rules = ParallelismRules().with_mesh(mesh)
        rank = mesh.index(rules.dp_axes) if rank is None else rank
    if rank is None:
        raise ValueError("error_state needs a worker rank or a mesh")
    meta = Transformer(torch.Generator(), cfg, torch.device("meta"))
    named = dict(meta.named_parameters())
    out = {}
    for path, names in stacked_leaves(meta, cfg):
        leaf = np_err
        for part in path.split("."):
            leaf = leaf[int(part) if part.isdigit() else part]
        shape = (len(names), *named[names[0]].shape) if len(names) > 1 else tuple(named[names[0]].shape)
        arr = np.asarray(leaf)[rank]
        if arr.shape == tuple(shape):
            if mesh is not None:
                arr = block(arr, tp_cut(ref_path(names[0]), shape, rules, mesh,
                                        stack=int(len(names) > 1)))
            out[path] = to_tensor(arr, device, torch.float32)
    return out
