"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``), entry by entry, and the
run-time checks of tensor parallelism.

Every parameter leaf of all ten archs' full configs (kimi-k2 at depth 2,
the vision model at depth 10; shapes from ``jax.eval_shape`` and the port's
model on the ``meta`` device) and every leaf of each arch's ``init_cache``
(``seq_shard`` both ways), under four rule sets (default, ``fsdp=True``,
``seq_parallel=True, tp_enabled=False``, ``shard_vocab=False``) and four
meshes (16×16, 2×16×16, 4×2, 1×2, through the reference tests'
``FakeMesh``): the port's spec equals the reference's, and ``explain``
prints the reference's table. The reference's rule tests
(``tests/test_distributed.py``) have their counterparts case for case.
Nothing here draws a weight or starts a rank.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as rconfigs
from repro import models as rmodels
from repro.distributed import sharding as rs
from repro_torch import configs as pconfigs
from repro_torch import models as pmodels
from repro_torch.distributed import sharding as ps
from repro_torch.launch import mesh as pmesh


class FakeMesh:
    """Minimal mesh stand-in for rule unit tests (axis sizes only)."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


ARCHS = list(pconfigs.ARCH_IDS)
DEPTH = {"kimi-k2-1t-a32b": 2, "llama-3.2-vision-90b": 10}
RULES = {"default": {}, "fsdp": dict(fsdp=True),
         "seq_parallel": dict(seq_parallel=True, tp_enabled=False),
         "vocab_replicated": dict(shard_vocab=False)}
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}, "1x2": {"data": 1, "model": 2}}
CACHE_B, CACHE_LEN = 32, 4096


def _full(arch: str, mod):
    cfg = mod.get_arch(arch).full_config()
    if arch in DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH[arch], pattern=cfg.pattern[:DEPTH[arch]])
    return cfg


def _dotted(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _flat(tree) -> dict:
    """A reference pytree's leaves (specs or shapes) by dotted path, in order."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {_dotted(p): x for p, x in leaves}


@functools.lru_cache(maxsize=None)
def _shapes(arch: str):
    """``(reference parameter shapes, port model on meta, reference cache
    shapes, port cache on meta, port config)``."""
    cfg_r, cfg_p = _full(arch, rconfigs), _full(arch, pconfigs)
    params = jax.eval_shape(lambda k: rmodels.init_params(k, cfg_r), jax.random.key(0))
    cache = jax.eval_shape(lambda: rmodels.init_cache(cfg_r, CACHE_B, CACHE_LEN))
    model = pmodels.Transformer(torch.Generator(), cfg_p, torch.device("meta"))
    pcache = pmodels.init_cache(cfg_p, CACHE_B, CACHE_LEN, device="meta")
    return params, model, cache, pcache, cfg_p


def _rules(kw: dict, mesh):
    return rs.ParallelismRules(**kw).with_mesh(mesh), ps.ParallelismRules(**kw).with_mesh(mesh)


def _same(got: tuple, want) -> bool:
    # the reference's spec prints one-name tuples as the name
    return want == got and ps.spec_str(got) == str(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    params, model, _, _, _ = _shapes(arch)
    for mesh_shape in MESHES.values():
        mesh = FakeMesh(mesh_shape)
        for kw in RULES.values():
            rr, pr = _rules(kw, mesh)
            want = _flat(rs.param_pspecs(params, rr, mesh))
            got = ps.param_pspecs(model, pr, mesh)
            assert list(got) == list(want)
            for path, spec in want.items():
                assert _same(got[path], spec), (path, got[path], spec, mesh_shape, kw)
            assert ps.explain(model, pr, mesh) == rs.explain(params, rr, mesh)


def _layer_paths(cfg) -> list:
    """Each port layer's reference cache path prefix and its index in a
    stack (``None`` unscanned), in execution order."""
    out = []
    for si, seg in enumerate(pmodels.segments(cfg)):
        for rep in range(seg.n_repeat):
            for pos in range(len(seg.unit)):
                out.append((f"segments.{si}.{pos}", rep if seg.n_repeat > 1 else None))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch):
    _, _, cache, pcache, cfg = _shapes(arch)
    leaves = _flat(cache)
    for mesh_shape in MESHES.values():
        mesh = FakeMesh(mesh_shape)
        for kw in RULES.values():
            rr, pr = _rules(kw, mesh)
            for seq_shard in (False, True):
                want = {path: rs.cache_pspec(p, leaf, rr, mesh, seq_shard=seq_shard)
                        for (p, leaf), path in zip(
                            jax.tree_util.tree_flatten_with_path(cache)[0], leaves)}
                for path, leaf in leaves.items():
                    got = ps.cache_pspec(path, leaf.shape, pr, mesh, seq_shard=seq_shard)
                    assert _same(got, want[path]), (path, got, want[path])
                # the port's per-layer caches: the stack's spec without its repeat dim
                assert ps.cache_pspec("length", (), pr, mesh, seq_shard=seq_shard) == () == tuple(
                    want["length"])
                for (prefix, rep), layer in zip(_layer_paths(cfg), pcache["layers"]):
                    for name, leaf in layer.items():
                        spec = ps.cache_pspec(name, leaf.shape, pr, mesh, seq_shard=seq_shard)
                        stacked = want[f"{prefix}.{name}"]
                        layer_spec = P(*tuple(stacked)[1:]) if rep is not None else stacked
                        assert _same(spec, layer_spec), (prefix, name, spec, stacked)


# ---------------------------------------------------------------------------
# the counterparts of tests/test_distributed.py's rule tests
# ---------------------------------------------------------------------------

MESH = FakeMesh({"data": 16, "model": 16})
RULES16 = ps.ParallelismRules(dp_axes=("data",))


def _spec(path_names, shape, rules=RULES16, mesh=MESH):
    return ps.leaf_pspec(tuple(path_names), shape, rules, mesh)


def test_tp_rules_column_row_parallel():
    assert _spec(("mixer", "w_q"), (2048, 2048)) == (None, "model")
    assert _spec(("mixer", "w_o"), (2048, 2048)) == ("model", None)
    assert _spec(("ffn", "w_down"), (8192, 2048)) == ("model", None)


def test_divisibility_fallback():
    # vocab 50280 is not divisible by 16 → replicated
    assert _spec(("embed", "tok"), (50280, 2048))[0] is None
    assert _spec(("embed", "tok"), (163840, 2048))[0] == "model"


def test_moe_expert_sharding():
    assert _spec(("ffn", "w_up"), (384, 7168, 2048))[0] == "model"  # expert-parallel dim


def test_fsdp_adds_data_axis():
    rules = ps.ParallelismRules(dp_axes=("data",), fsdp=True)
    assert _spec(("mixer", "w_q"), (8192, 8192), rules) == (("data",), "model")


def test_stacked_leading_dims_unsharded():
    spec = _spec(("segments", "w_q"), (16, 2048, 2048))
    assert spec[0] is None and spec[2] == "model"


def test_norms_and_scalars():
    assert _spec(("norm1", "scale"), (2048,)) == (None,)
    assert _spec(("mixer", "gate"), ()) == ()


def test_tp_collectives_are_identity_outside_context():
    x = torch.ones((4, 8, 16))
    assert ps.copy_to_tp(x) is x and ps.reduce_from_tp(x) is x
    assert ps.tp_group() is None and ps.tp_index() == (0, 1)


def test_batch_pspec_matches_reference():
    for kw in RULES.values():
        for mesh_shape in MESHES.values():
            mesh = FakeMesh(mesh_shape)
            rr, pr = _rules(kw, mesh)
            assert _same(ps.batch_pspec(pr), rs.batch_pspec(rr))


# ---------------------------------------------------------------------------
# run time: the mesh, whole shards only
# ---------------------------------------------------------------------------


def test_mesh_places_ranks_model_fastest():
    mesh = ps.Mesh({"data": 2, "model": 2}, rank=3)
    assert mesh.coords == {"data": 1, "model": 1} and mesh.index("data") == 1
    assert ps.Mesh({"data": 4, "model": 2}, rank=5).coords == {"data": 2, "model": 1}
    pod = ps.Mesh({"pod": 2, "data": 16, "model": 16}, rank=300)
    assert pod.coords == {"pod": 1, "data": 2, "model": 12}
    assert pod.index(("pod", "data")) == 18 and pod.axis_size(("pod", "data")) == 32
    assert ps.Mesh({"data": 1, "model": 1}).group("model") is None
    with pytest.raises(ValueError, match="no process group"):
        mesh.group("model")


def test_host_mesh_needs_the_world():
    one = pmesh.make_host_mesh(1, 1)
    assert one.shape == {"data": 1, "model": 1} and one.groups == {}
    with pytest.raises(ValueError, match="needs 8 ranks"):
        pmesh.make_host_mesh()
    with pytest.raises(ValueError, match="needs 256 ranks"):
        pmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        pmesh.make_production_mesh(multi_pod=True)


def test_run_time_cuts_layers_where_the_rules_read_a_stack_as_experts():
    """llama3.2-1b at 1×2: the reference's rules read the scanned dense FFN
    stack (16, 2048, 8192) as MoE experts and put its layer axis over
    ``model``; the port's layers are leaves of their own and take an
    unscanned layer's rules: w_up's columns, w_down's rows."""
    _, model, _, _, _ = _shapes("llama3.2-1b")
    mesh = ps.Mesh({"data": 1, "model": 2}, rank=1)
    rules = ps.ParallelismRules().with_mesh(mesh)
    specs = ps.param_pspecs(model, rules, mesh)
    assert specs["segments.0.0.ffn.w_up"] == ("model", None, None)
    assert specs["segments.0.0.mixer.w_q"] == (None, None, "model")
    cuts = ps.tp_cuts(model, rules, mesh)
    assert cuts["segments.0.0.ffn.w_up"] == (-1, 2, 1)
    assert cuts["segments.0.0.ffn.w_down"] == (-2, 2, 1)
    assert cuts["segments.0.0.mixer.w_o"] == (-2, 2, 1) and cuts["embed.tok"] == (-2, 2, 1)
    assert "final_norm.scale" not in cuts and "segments.0.0.norm1.scale" not in cuts


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b", "llama-3.2-vision-90b"])
def test_run_time_raises_beyond_the_dense_stack(arch):
    """Mamba-2, shared and cross attention and a modality input run at model
    axis 2: every rank's block of every parameter at 1×2 and 2×2
    (``shard_params``, and ``init_params(mesh=)`` drawing leaf by leaf, bit
    for bit the same) is the block the reference's ``leaf_pspec`` lays out
    for an unscanned layer's leaf, the leaves it keeps whole (``w_bc``,
    ``w_dt``, ``conv_bc_*``, ``dt_bias``, ``a_log``, ``d_skip``,
    ``w_out``, ``vision_proj``, the cross ``gate``) whole; a prefill
    cache's cut (``shard_cache``) is the reference's ``cache_pspec`` block
    and ``init_cache`` under the mesh has its shape. At model axis 3 an SSM
    or KV head would split, and the run time raises ``ValueError``; FSDP
    runs, sequence parallelism raises ``NotImplementedError``."""
    cfg = pconfigs.get_arch(arch).smoke_config()
    g = torch.Generator()
    g.manual_seed(0)
    whole = pmodels.init_params(g, cfg, device="cpu")
    named = {k: v.detach() for k, v in whole.named_parameters()}
    tokens = torch.randint(0, cfg.vocab_size, (4, 8), generator=g)
    vision = (torch.randn((4, cfg.n_patches, cfg.d_vision), generator=g) if cfg.d_vision
              else None)
    _, cache = pmodels.prefill(whole, cfg, tokens, 12, vision)
    kept = {"w_bc", "w_dt", "conv_bc_w", "conv_bc_b", "dt_bias", "a_log", "d_skip", "w_out",
            "vision_proj", "gate"}
    seen = set()
    for shape in ((1, 2), (2, 2)):
        fake = FakeMesh(dict(zip(("data", "model"), shape)))
        rules = rs.ParallelismRules().with_mesh(fake)
        for rank in range(shape[0] * shape[1]):
            mesh = ps.Mesh(fake.shape, rank)
            cut = ps.shard_params(named, ps.ParallelismRules(), mesh)
            g = torch.Generator()
            g.manual_seed(0)
            drawn = dict(pmodels.init_params(g, cfg, device="cpu", mesh=mesh).named_parameters())
            for name, t in named.items():
                spec = tuple(rs.leaf_pspec(_ref_key(name), jax.ShapeDtypeStruct(t.shape,
                                                                                jnp.float32),
                                           rules, fake))
                want = _rule_block(t, spec, fake.shape, rank)
                assert torch.equal(cut[name], want) and torch.equal(drawn[name], want), name
                leaf = name.split(".")[-1]
                if leaf in kept:
                    assert cut[name].shape == t.shape, name
                    seen.add(leaf)
                elif leaf in ("w_z", "w_x", "w_q", "w_k", "w_v", "w_o", "norm_scale"):
                    assert cut[name].numel() * 2 == t.numel(), name
            layers = ps.shard_cache(cache, mesh)["layers"]
            with ps.activation_sharding(mesh):
                local = pmodels.init_cache(cfg, 4 // shape[0], 12, device="cpu")["layers"]
            for lw, lc, ll in zip(cache["layers"], layers, local):
                for name, t in lw.items():
                    spec = rs.cache_pspec((jax.tree_util.DictKey(name),),
                                          jax.ShapeDtypeStruct(t.shape, jnp.float32), rules,
                                          fake, seq_shard=False)
                    want = _rule_block(t, tuple(spec), fake.shape, rank)
                    assert torch.equal(lc[name], want), (shape, rank, name)
                    assert ll[name].shape == want.shape, (shape, rank, name)
    assert seen == kept & {n.split(".")[-1] for n in named}
    with pytest.raises(ValueError, match="SSM heads" if cfg.ssm_heads else "KV heads"):
        ps.shard_params(whole, ps.ParallelismRules(), ps.Mesh({"data": 1, "model": 3}))
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        ps.shard_params(whole, ps.ParallelismRules(seq_parallel=True),
                        ps.Mesh({"data": 1, "model": 2}))


def _ref_key(name: str) -> tuple:
    # a port parameter name as the reference's key path of an unscanned layer
    return tuple(jax.tree_util.SequenceKey(int(k)) if k.isdigit() else jax.tree_util.DictKey(k)
                 for k in ps.ref_path(name))


MOE_MLA_ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]


@pytest.mark.parametrize("arch", MOE_MLA_ARCHS)
def test_run_time_cuts_experts_and_mla_heads(arch):
    """At 1×2 and 2×2, every rank's block of every parameter of the MoE
    archs (``shard_params``, and ``init_params(mesh=)`` drawing leaf by
    leaf, bit for bit the same) is the block the reference's
    ``leaf_pspec`` lays out for an unscanned layer's leaf: the experts'
    ``(E, D, Fe)`` stacks by ``_MOE_LAYOUTS``' ``ep`` on dim −3, the shared
    FFN and MLA's ``w_q``/``w_uk``/``w_uv`` by columns (whole heads), the
    ``w_o``'s by rows; ``router`` and ``w_dkv`` whole. A prefill cache's
    MLA latents are whole on every model rank (``cache_pspec``), a GQA
    cache holds the rank's KV heads."""
    cfg = pconfigs.get_arch(arch).smoke_config()
    g = torch.Generator()
    g.manual_seed(0)
    whole = pmodels.init_params(g, cfg, device="cpu")
    named = {k: v.detach() for k, v in whole.named_parameters()}
    tokens = torch.randint(0, cfg.vocab_size, (4, 8), generator=g)
    _, cache = pmodels.prefill(whole, cfg, tokens, 12, dense_moe=True)
    seen = set()
    for shape in ((1, 2), (2, 2)):
        fake = FakeMesh(dict(zip(("data", "model"), shape)))
        rules = rs.ParallelismRules().with_mesh(fake)
        for rank in range(shape[0] * shape[1]):
            mesh = ps.Mesh(fake.shape, rank)
            cut = ps.shard_params(named, ps.ParallelismRules(), mesh)
            g = torch.Generator()
            g.manual_seed(0)
            drawn = dict(pmodels.init_params(g, cfg, device="cpu", mesh=mesh).named_parameters())
            for name, t in named.items():
                spec = tuple(rs.leaf_pspec(_ref_key(name), jax.ShapeDtypeStruct(t.shape,
                                                                                jnp.float32),
                                           rules, fake))
                want = _rule_block(t, spec, fake.shape, rank)
                assert torch.equal(cut[name], want) and torch.equal(drawn[name], want), name
                leaf = name.split(".")[-1]
                if leaf in ("router", "w_dkv"):
                    assert cut[name].shape == t.shape, name
                elif t.dim() == 3:
                    assert spec == ("model", None, None), (name, spec)
                    seen.add("experts")
                elif leaf in ("w_q", "w_uk", "w_uv") or ".shared.w_" in name and leaf != "w_down":
                    assert spec == (None, "model"), (name, spec)
                    seen.add(leaf)
                elif leaf in ("w_o", "w_down"):
                    assert spec == ("model", None), (name, spec)
            for layer, lc in zip(cache["layers"], ps.shard_cache(cache, mesh)["layers"]):
                for name, t in layer.items():
                    di, mi = rank // shape[1], rank % shape[1]
                    rows = t[di * 4 // shape[0]:(di + 1) * 4 // shape[0]]
                    if name == "latent":
                        assert torch.equal(lc[name], rows)
                        seen.add("latent")
                    else:
                        kv = t.shape[2] // shape[1]
                        assert torch.equal(lc[name], rows[:, :, mi * kv:(mi + 1) * kv])
    assert {"experts", "w_q"} <= seen
    assert ({"w_uk", "w_uv", "latent"} <= seen) == (arch == "deepseek-v2-lite-16b")


def test_run_time_raises_rather_than_replicate_or_split_a_head():
    """A head never splits: at model axis 3 llama's 2 KV heads raise. Where
    the model axis is a multiple of the KV heads (4), each rank holds every
    KV head whole, as the reference's ``cache_pspec`` keeps them, and a
    vocab that does not split is kept whole (``whole_leaves``; these
    layouts are held to the reference on numbers at 1×4 by
    ``tests/test_torch_fsdp.py::test_whole_leaves_match_single_device_reference``);
    a dim the rules would replicate is never cut (``tp_cut`` raises).
    Sequence parallelism raises; FSDP runs."""
    base = pconfigs.get_arch("llama3.2-1b").smoke_config()  # 4 query, 2 KV heads
    model = pmodels.Transformer(torch.Generator(), base, torch.device("meta"))
    with pytest.raises(ValueError, match="KV heads"):
        ps.shard_params(model, ps.ParallelismRules(), ps.Mesh({"data": 1, "model": 3}))
    ps.shard_params(model, ps.ParallelismRules(), ps.Mesh({"data": 1, "model": 4}))
    D, hd = base.d_model, base.head_dim
    layer = model.blocks[0].mixer
    assert layer.w_k.shape == (D, 2 * hd) and layer.w_q.shape == (D, hd)
    assert ps.whole_leaves(base, 4) == {"w_k", "w_v"}
    odd = dataclasses.replace(base, vocab_size=255)
    ps.check_tp(odd, 2)
    assert ps.whole_leaves(odd, 2) == {"tok", "lm_head"}
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        ps.shard_params(model, ps.ParallelismRules(seq_parallel=True),
                        ps.Mesh({"data": 1, "model": 2}))
    with pytest.raises(ValueError, match="replicate"):
        ps.tp_cut("embed.tok", (255, 64), ps.ParallelismRules(), ps.Mesh({"data": 1, "model": 2}))
    cut = ps.shard_params({"embed.tok": np.arange(12.0).reshape(6, 2)}, ps.ParallelismRules(),
                          ps.Mesh({"data": 1, "model": 2}, rank=1))
    np.testing.assert_array_equal(cut["embed.tok"], np.arange(6.0, 12.0).reshape(3, 2))


# the dense stack, the run time's archs at model axis > 1 (check_tp's)
DENSE_ARCHS = ["llama3.2-1b", "phi4-mini-3.8b", "mistral-nemo-12b", "musicgen-large",
               "gemma3-12b"]
RUN_MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}


def _rule_block(t, spec, shape: dict, rank: int):
    """Rank ``rank``'s block of ``t`` by a reference spec on a ``shape``
    mesh (ranks row-major over its axes, the last fastest)."""
    coords, r = {}, rank
    for name in reversed(tuple(shape)):
        coords[name], r = r % shape[name], r // shape[name]
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        parts, idx = 1, 0
        for a in axes:
            parts, idx = parts * shape[a], idx * shape[a] + coords[a]
        n = t.shape[dim] // parts
        t = t.narrow(dim, idx * n, n)
    return t


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_run_time_cache_blocks_follow_the_reference_cache_pspec(arch):
    """Every ``prefill`` cache leaf of a dense-stack arch at 1×2, 2×1 and
    2×2: the run time's cut (``shard_cache``, what ``convert.dense_cache``
    gives a rank) equals the block the reference's ``cache_pspec`` lays out
    on a ``FakeMesh``, and ``init_cache`` under ``activation_sharding`` at
    that rank has its shape (the K/V heads over ``model``, the batch over
    ``data``)."""
    cfg = pconfigs.get_arch(arch).smoke_config()
    g = torch.Generator()
    g.manual_seed(0)
    model = pmodels.init_params(g, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 8), generator=g)
    _, whole = pmodels.prefill(model, cfg, tokens, 12)
    for shape in RUN_MESHES.values():
        fake = FakeMesh(dict(zip(("data", "model"), shape)))
        rules = rs.ParallelismRules().with_mesh(fake)
        for rank in range(shape[0] * shape[1]):
            mesh = ps.Mesh(fake.shape, rank)
            cut = ps.shard_cache(whole, mesh)
            with ps.activation_sharding(mesh):
                local = pmodels.init_cache(cfg, 4 // shape[0], 12, device="cpu")
            assert cut["length"] is whole["length"]
            for lw, lc, ll in zip(whole["layers"], cut["layers"], local["layers"]):
                assert set(lw) == set(lc) == set(ll) == {"k", "v"}
                for name, t in lw.items():
                    spec = rs.cache_pspec((jax.tree_util.DictKey(name),),
                                          jax.ShapeDtypeStruct(t.shape, jnp.float32), rules,
                                          fake, seq_shard=False)
                    assert tuple(spec) == ("data", None, "model", None)
                    want = _rule_block(t, tuple(spec), fake.shape, rank)
                    assert torch.equal(lc[name], want), (arch, shape, rank, name)
                    assert ll[name].shape == want.shape, (arch, shape, rank, name)
