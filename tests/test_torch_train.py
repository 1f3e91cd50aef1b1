"""The port's training slice (``repro_torch.train``, the training forward of
``repro_torch.models``, ``repro_torch.launch.train``) against the JAX
reference on shared inputs.

Weights cross through :func:`repro_torch.convert.model_params`, sketches
through :func:`repro_torch.convert.sketch_from_arrays` (the reference's
draws, handed in as ``sketches``); tokens and gradients are numpy draws.
Tolerances:

* ``ssd_chunked``'s gradients (fp32): 1e-5 of each one's largest entry
  (the forward's bound in ``tests/test_torch_ssm.py``);
* the loss and every parameter's gradient of ``make_loss_fn`` (fp32 smoke
  configs): 1e-4 of each leaf's largest entry, ten times the logits' bound
  (``tests/test_torch_models.py``): a backward is about twice the forward's
  products, through every layer, in other summation orders;
* attention gradients: 5e-4 absolute, the reference's own bound on its
  flash gradients against the naive ones (``tests/test_models_smoke.py``);
* AdamW, ``lr_at``, ``global_norm``, ``cross_entropy``: 1e-6 relative (the
  same fp32 operations in the same order, bar ``sqrt``/``cos`` ulps); a
  bf16 parameter to one bf16 ulp of its largest entry (2^-8), where the two
  fp32 updates round to neighbours;
* C, R, M and Ĝ of the compression: 1e-5 of each one's largest entry (fp32
  products over up to 200 terms, other orders); the reference's own
  low-rank bounds (0.02, 0.03) and linearity (1e-3 absolute) as they are;
  ``compression_ratio``: equal.

The gloo ranks of the W = 2 case are spawned processes running
:func:`_rank` (this module imports JAX only inside its tests, so that the
ranks stay light). The reference's ``slow`` tests keep their mark here.
"""

import dataclasses
import datetime
import queue
import socket
import time
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import models as pmodels
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import generator
from repro_torch.models import attention as pattn
from repro_torch.models import moe as pmoe
from repro_torch.train import grad_compress as pgc
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pts

FAST_ARCHS = ["llama3.2-1b", "deepseek-v2-lite-16b", "mamba2-1.3b"]
SLOW_ARCHS = ["phi4-mini-3.8b", "mistral-nemo-12b", "musicgen-large", "gemma3-12b",
              "kimi-k2-1t-a32b", "zamba2-1.2b", "llama-3.2-vision-90b"]
B, S = 2, 32


def _ref():
    """The reference's modules, imported on first use."""
    import importlib

    names = ["jax", "jax.numpy", "repro.configs", "repro.models", "repro.models.attention",
             "repro.models.ssm", "repro.train", "repro.train.grad_compress",
             "repro.train.optimizer", "repro.data"]
    return {n: importlib.import_module(n) for n in names}


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    return err / scale if scale > 0 else err


def _cfgs(arch: str, full: bool = False, **over):
    """``(port config, reference config)`` of ``arch`` with ``over`` applied."""
    from repro.configs import get_arch as rget

    which = "full_config" if full else "smoke_config"
    return tuple(dataclasses.replace(getattr(g(arch), which)(), **over) for g in (get_arch, rget))


def _tiny_cfg():
    return _cfgs("llama3.2-1b", d_model=64, d_ff=256, vocab_size=128)[0]


# ---------------------------------------------------------------------------
# F7: the training forward builds a graph; F8: ssd_chunked differentiates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [None, "full", "dots"])
def test_train_logits_builds_a_graph(remat):
    cfg = get_arch("llama3.2-1b").smoke_config()
    model = pmodels.init_params(generator(0, "cpu"), cfg, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=generator(1, "cpu"))
    logits, aux = pmodels.train_logits(model, cfg, toks, remat=remat)
    assert logits.requires_grad and logits.grad_fn is not None
    g = torch.autograd.grad(logits.square().mean(), model.embed.tok)[0]
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_serving_builds_no_graph():
    cfg = get_arch("llama3.2-1b").smoke_config()
    model = pmodels.init_params(generator(0, "cpu"), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, 8), generator=generator(1, "cpu"))
    lg, cache = pmodels.prefill(model, cfg, toks, 12)
    assert not lg.requires_grad and not cache["layers"][0]["k"].requires_grad
    lg, _ = pmodels.decode_step(model, cfg, cache, lg.argmax(-1))
    assert not lg.requires_grad


def _ssd_inputs():
    rng = np.random.default_rng(0)
    Bz, Sq, H, P, G, N = 1, 16, 4, 8, 2, 8
    f32 = np.float32
    return dict(xh=rng.standard_normal((Bz, Sq, H, P)).astype(f32),
                dt=(np.log1p(np.exp(rng.standard_normal((Bz, Sq, H)))) * 0.3).astype(f32),
                A=(-np.exp(rng.standard_normal(H) * 0.3)).astype(f32),
                Bm=(rng.standard_normal((Bz, Sq, G, N)) * 0.3).astype(f32),
                Cm=(rng.standard_normal((Bz, Sq, G, N)) * 0.3).astype(f32),
                wy=rng.standard_normal((Bz, Sq, H, P)).astype(f32),
                ws=rng.standard_normal((Bz, H, N, P)).astype(f32))


def test_ssd_chunked_gradients_match_reference():
    r = _ref()
    jax, jnp, rssm = r["jax"], r["jax.numpy"], r["repro.models.ssm"]
    d = _ssd_inputs()
    names = ("xh", "dt", "A", "Bm", "Cm")

    def ref_loss(xh, dt, A, Bm, Cm):
        y, st = rssm.ssd_chunked(xh, dt, A, Bm, Cm, 8)
        return jnp.sum(y * d["wy"]) + jnp.sum(st * d["ws"])

    want = jax.grad(ref_loss, argnums=tuple(range(5)))(*(jnp.asarray(d[n]) for n in names))
    ins = [torch.tensor(d[n], requires_grad=True) for n in names]
    y, st = pmodels.ssd_chunked(*ins, 8)
    loss = (y * torch.from_numpy(d["wy"])).sum() + (st * torch.from_numpy(d["ws"])).sum()
    got = torch.autograd.grad(loss, ins)
    for n, g, w in zip(names, got, want):
        assert _rel(g, w) <= 1e-5, n


def test_ssd_chunked_inference_holds_one_decay_tensor():
    """Without autograd the (B, nc, H, Q, Q) decay gets storage once and is
    then changed in place; under autograd the exp and the product are new."""
    from torch.utils._python_dispatch import TorchDispatchMode

    rng = np.random.default_rng(0)
    Bz, Sq, H, P, G, N, Q = 1, 16, 4, 16, 2, 6, 8  # no other tensor of the decay's shape
    ins = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((Bz, Sq, H, P)), np.full((Bz, Sq, H), 0.1), -np.ones(H),
        rng.standard_normal((Bz, Sq, G, N)), rng.standard_normal((Bz, Sq, G, N)))]
    qq = (Bz, Sq // Q, H, Q, Q)

    class Fresh(TorchDispatchMode):
        """Names of the ops that give a (B, nc, H, Q, Q) result new storage."""

        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            seen = {a.untyped_storage().data_ptr() for a in args if torch.is_tensor(a)}
            if (torch.is_tensor(out) and tuple(out.shape) == qq
                    and out.untyped_storage().data_ptr() not in seen):
                self.ops.append(func.__name__)
            return out

    with torch.no_grad(), Fresh() as made:
        pmodels.ssd_chunked(*ins, Q)
    assert made.ops == ["sub.Tensor"], made.ops
    with Fresh() as made:
        pmodels.ssd_chunked(ins[0].clone().requires_grad_(), *ins[1:], Q)
    assert made.ops == ["sub.Tensor", "exp.default"], made.ops  # the product is 6-D


# ---------------------------------------------------------------------------
# loss and gradients of whole models against jax.value_and_grad
# ---------------------------------------------------------------------------


def _ref_paths(tree) -> dict:
    """The reference pytree's leaves by dotted path, in flattening order."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = np.asarray(leaf)
    return out


def _grad_parity(arch: str):
    r = _ref()
    jax, rmodels, rtrain = r["jax"], r["repro.models"], r["repro.train"]
    cfg, cfg_r = _cfgs(arch)
    if cfg.n_experts:  # a small capacity, so that the dispatch drops assignments
        cfg, cfg_r = _cfgs(arch, capacity_factor=0.5)
    params = jax.jit(lambda k: rmodels.init_params(k, cfg_r))(jax.random.key(0))
    if cfg.d_vision:  # cross gates start at 0 (the layer adds nothing): open them
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: x + 0.5 if getattr(p[-1], "key", None) == "gate" else x, params)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.d_vision:
        batch["vision"] = rng.standard_normal((B, cfg.n_patches, cfg.d_vision)).astype(np.float32)
    loss_r = rtrain.make_loss_fn(cfg_r)
    (lr, mr), gr = jax.jit(jax.value_and_grad(loss_r, has_aux=True))(params, batch)

    model = convert.model_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    kept = []
    real = pmoe.dispatch_slots

    def spy(*a, **kw):
        slot, keep = real(*a, **kw)
        kept.append(bool(keep.all()))
        return slot, keep

    with mock.patch.object(pmoe, "dispatch_slots", spy):
        loss, metrics, grads = pts._value_and_grad(pts.make_loss_fn(cfg), model,
                                                   {k: torch.from_numpy(v) for k, v in batch.items()})
    if cfg.n_experts:
        assert kept and not all(kept), "no assignment dropped"
    assert _rel(loss, float(lr)) <= 1e-4 and _rel(metrics["aux"], float(mr["aux"])) <= 1e-4
    want = _ref_paths(gr)
    got = pgc.group_leaves(grads, convert.stacked_leaves(model, cfg))
    assert list(got) == list(want)
    for path, g in got.items():
        assert _rel(g, want[path]) <= 1e-4, path


@pytest.mark.parametrize("arch", FAST_ARCHS)
def test_loss_gradients_match_reference(arch):
    _grad_parity(arch)


@pytest.mark.slow
@pytest.mark.parametrize("arch", SLOW_ARCHS)
def test_loss_gradients_match_reference_slow(arch):
    _grad_parity(arch)


@pytest.mark.parametrize("case", [(2, 128, 4, 2, 16, None, 32), (1, 200, 8, 8, 8, None, 64),
                                  (2, 256, 4, 1, 16, 48, 32), (1, 96, 2, 2, 8, 20, 32)])
@pytest.mark.parametrize("impl", ["custom_vjp", "scan_ad"])
def test_attention_train_gradients_match_reference(case, impl):
    r = _ref()
    jax, jnp, rattn = r["jax"], r["jax.numpy"], r["repro.models.attention"]
    Bz, Sq, H, KV, D, window, chunk = case
    rng = np.random.default_rng(sum(x or 0 for x in case))
    q, k, v = (rng.standard_normal((Bz, Sq, h, D)).astype(np.float32) for h in (H, KV, KV))
    w = rng.standard_normal((Bz, Sq, H, D)).astype(np.float32)

    def ref_loss(q, k, v):
        return jnp.sum(rattn.attention_train(q, k, v, window=window, chunk=chunk, impl=impl) * w)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
    out_r = rattn.attention_train(q, k, v, window=window, chunk=chunk, impl=impl)
    ins = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = pattn.attention_train(*ins, window=window, chunk=chunk, impl=impl)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_r), atol=2e-5)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ins)
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), atol=5e-4)


# ---------------------------------------------------------------------------
# optimizer and loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("master,moments,dtype", [(False, "float32", "float32"),
                                                  (True, "float32", "bfloat16"),
                                                  (False, "bfloat16", "bfloat16")])
def test_adamw_update_matches_reference(master, moments, dtype):
    r = _ref()
    jnp, ropt = r["jax.numpy"], r["repro.train.optimizer"]
    rng = np.random.default_rng(2)
    shapes = {"a": (6, 5), "b": (7,), "c": (3, 4, 2)}
    p_np = {k: (rng.standard_normal(s) * 0.02).astype(np.float32) for k, s in shapes.items()}
    oc = popt.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=10, master=master,
                              moments_dtype=moments)
    jdt = getattr(jnp, dtype)
    params_r = {k: jnp.asarray(v).astype(jdt) for k, v in p_np.items()}
    st_r = ropt.init_opt_state(params_r, oc)
    params_p = {k: convert.to_tensor(np.asarray(v), "cpu") for k, v in params_r.items()}
    st_p = popt.init_opt_state(params_p, oc)
    for step in range(3):
        g_np = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        g_r = {k: jnp.asarray(v).astype(jdt) for k, v in g_np.items()}
        params_r, st_r, m_r = ropt.adamw_update(g_r, st_r, params_r, oc)
        g_p = {k: convert.to_tensor(np.asarray(v), "cpu") for k, v in g_r.items()}
        params_p, st_p, m_p = popt.adamw_update(g_p, st_p, params_p, oc)
        assert int(st_p["step"]) == int(st_r["step"]) == step + 1
        assert _rel(m_p["grad_norm"], m_r["grad_norm"]) <= 1e-6
        assert _rel(m_p["lr"], m_r["lr"]) <= 1e-6
        ptol = 2.0 ** -8 if dtype == "bfloat16" else 1e-6
        mtol = 2.0 ** -8 if moments == "bfloat16" else 1e-6
        for k in shapes:
            assert params_p[k].dtype == convert.to_tensor(np.asarray(params_r[k]), "cpu").dtype
            assert _rel(params_p[k].float(), np.asarray(params_r[k].astype(jnp.float32))) <= ptol
            for mk in ("m", "v"):
                assert _rel(st_p[mk][k].float(), np.asarray(st_r[mk][k].astype(jnp.float32))) <= mtol
            if master:
                assert _rel(st_p["master"][k], np.asarray(st_r["master"][k])) <= 1e-6


def test_adamw_matches_numpy_reference():
    oc = popt.OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=100, clip_norm=None,
                              weight_decay=0.1, min_lr_ratio=1.0)
    params = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]])}
    grads = {"w": torch.tensor([[0.1, -0.2], [0.3, 0.4]])}
    w = params["w"].numpy().copy()
    st = popt.init_opt_state(params, oc)
    new_p, st, _ = popt.adamw_update(grads, st, params, oc)
    g = grads["w"].numpy()
    mhat = 0.1 * g / (1 - 0.9)
    vhat = 0.05 * g * g / (1 - 0.95)
    expect = w - 1e-2 * (mhat / (np.sqrt(vhat) + oc.eps) + 0.1 * w)
    np.testing.assert_allclose(new_p["w"].numpy(), expect, rtol=1e-5)


def test_lr_schedule_and_global_norm_match_reference():
    r = _ref()
    jnp, ropt = r["jax.numpy"], r["repro.train.optimizer"]
    oc = popt.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 60, 109, 110, 200):
        assert _rel(popt.lr_at(step, oc), ropt.lr_at(jnp.asarray(step), oc)) <= 1e-6
        assert _rel(popt.lr_at(torch.tensor(step), oc), ropt.lr_at(step, oc)) <= 1e-6
    assert float(popt.lr_at(5, oc)) == pytest.approx(0.5)
    assert float(popt.lr_at(110, oc)) == pytest.approx(0.1, abs=1e-3)
    rng = np.random.default_rng(3)
    t = {"a": rng.standard_normal((4, 5)).astype(np.float32), "b": np.float32([3.0, 4.0])}
    assert _rel(popt.global_norm({k: torch.from_numpy(v) for k, v in t.items()}),
                ropt.global_norm({k: jnp.asarray(v) for k, v in t.items()})) <= 1e-6


def test_cross_entropy_matches_reference():
    r = _ref()
    jnp, rtrain = r["jax.numpy"], r["repro.train"]
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 8, 32)).astype(np.float32) * 3
    labels = rng.integers(0, 32, (2, 8)).astype(np.int32)
    want = rtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert _rel(pts.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)), want) <= 1e-6


# ---------------------------------------------------------------------------
# GMR gradient compression
# ---------------------------------------------------------------------------


def _ref_sketches(key, shape, ccfg_r) -> tuple:
    """The reference's four sketches of an (m, n) slice, as numpy arrays."""
    from repro.train.grad_compress import _sketches_for

    return tuple(convert.sketch_arrays(S) for S in _sketches_for(key, shape, ccfg_r))


def _port_sketches(arrays) -> tuple:
    return tuple(convert.sketch_from_arrays(kind, arr, device="cpu") for kind, arr in arrays)


@pytest.mark.parametrize("shape", [(120, 96), (3, 100, 72)])
@pytest.mark.parametrize("inner", ["gaussian", "countsketch"])
def test_compress_decompress_match_reference(shape, inner):
    r = _ref()
    jax, jnp, rgc = r["jax"], r["jax.numpy"], r["repro.train.grad_compress"]
    ccfg_r = rgc.CompressionConfig(rank=8, sketch_factor=3, min_dim=32, inner_sketch=inner)
    ccfg = pgc.CompressionConfig(rank=8, sketch_factor=3, min_dim=32, inner_sketch=inner)
    key = jax.random.key(5)
    G = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    t_r = rgc.compress(key, jnp.asarray(G), ccfg_r)
    ghat_r = rgc.decompress(key, t_r, shape, ccfg_r)
    sk = _port_sketches(_ref_sketches(key, shape[-2:], ccfg_r))
    t_p = pgc.compress(sk, torch.from_numpy(G), ccfg)
    for name, a, b in zip("CRM", t_p, t_r):
        assert _rel(a, b) <= 1e-5, name
    assert _rel(pgc.decompress(sk, t_p, shape, ccfg), ghat_r) <= 1e-5


def test_compress_linearity():
    """sketch(G1) + sketch(G2) == sketch(G1 + G2): the all-reduce is exact."""
    ccfg = pgc.CompressionConfig(rank=16, sketch_factor=4, min_dim=32)
    g = generator(1, "cpu")
    G1, G2 = torch.randn((128, 96), generator=g), torch.randn((128, 96), generator=g)
    for a, b, ab in zip(pgc.compress(3, G1, ccfg), pgc.compress(3, G2, ccfg),
                        pgc.compress(3, G1 + G2, ccfg)):
        torch.testing.assert_close(a + b, ab, atol=1e-3, rtol=0)


def test_compress_decompress_lowrank_exact():
    ccfg = pgc.CompressionConfig(rank=24, sketch_factor=6, min_dim=32)
    g = generator(5, "cpu")
    G = torch.randn((200, 8), generator=g) @ torch.randn((8, 160), generator=g)
    Ghat = pgc.decompress(4, pgc.compress(4, G, ccfg), G.shape, ccfg)
    assert float(torch.linalg.norm(G - Ghat) / torch.linalg.norm(G)) < 0.02


def test_compress_stacked_lowrank():
    ccfg = pgc.CompressionConfig(rank=24, sketch_factor=6, min_dim=32)
    g = generator(12, "cpu")
    G = torch.einsum("lmr,lrn->lmn", torch.randn((4, 100, 8), generator=g),
                     torch.randn((4, 8, 120), generator=g))
    Ghat = pgc.decompress(11, pgc.compress(11, G, ccfg), G.shape, ccfg)
    assert float(torch.linalg.norm(G - Ghat) / torch.linalg.norm(G)) < 0.03


def test_is_compressible_rules():
    ccfg = pgc.CompressionConfig(min_dim=512)
    assert pgc.is_compressible(torch.zeros((512, 2048)), ccfg)
    assert not pgc.is_compressible(torch.zeros((128, 2048)), ccfg)
    assert not pgc.is_compressible(torch.zeros((2048,)), ccfg)
    assert pgc.is_compressible(torch.zeros((4, 512, 512)), ccfg)
    assert not pgc.is_compressible(torch.zeros((4, 128, 512)), ccfg)
    assert not pgc.is_compressible(torch.zeros((2, 4, 512, 512)), ccfg)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-lite-16b", "zamba2-1.2b",
                                  "llama-3.2-vision-90b"])
def test_stacked_leaves_and_ratio_match_reference(arch):
    """The grouping is the reference's flattening, path by path and shape by
    shape, and ``compression_ratio`` is equal (smoke config, min_dim 32)."""
    r = _ref()
    jax, rmodels, rgc = r["jax"], r["repro.models"], r["repro.train.grad_compress"]
    cfg, cfg_r = _cfgs(arch)
    shapes = jax.eval_shape(lambda k: rmodels.init_params(k, cfg_r), jax.random.key(0))
    want = {p: tuple(s.shape) for p, s in _ref_shape_paths(shapes).items()}
    model = pmodels.init_params(generator(0, "cpu"), cfg, device="cpu")
    got = {p: tuple(s) for p, s in pgc.leaf_shapes(model).items()}
    assert list(got.items()) == list(want.items())
    for rank, min_dim in ((8, 32), (4, 16)):
        assert pgc.compression_ratio(model, pgc.CompressionConfig(rank=rank, min_dim=min_dim)) == \
            rgc.compression_ratio(shapes, rgc.CompressionConfig(rank=rank, min_dim=min_dim))


def _ref_shape_paths(tree) -> dict:
    import jax

    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_compression_ratio_at_full_width():
    """llama3.2-1b's full config at the reference CLI's rank 32, factor 4,
    min_dim 512: the reference's ratio over ``jax.eval_shape``, exactly."""
    r = _ref()
    jax, rmodels, rgc = r["jax"], r["repro.models"], r["repro.train.grad_compress"]
    cfg, cfg_r = _cfgs("llama3.2-1b", full=True)
    shapes = jax.eval_shape(lambda k: rmodels.init_params(k, cfg_r), jax.random.key(0))
    want = rgc.compression_ratio(shapes, rgc.CompressionConfig(rank=32, sketch_factor=4))
    model = pmodels.Transformer(torch.Generator(), cfg, torch.device("meta"))
    got = pgc.compression_ratio(model, pgc.CompressionConfig(rank=32, sketch_factor=4))
    assert got == want == 43.160360489235394
    fake = {"w1": torch.zeros((4096, 14336)), "w2": torch.zeros((14336, 4096)),
            "norm": torch.zeros((4096,))}
    assert pgc.compression_ratio(fake, pgc.CompressionConfig(rank=64, min_dim=1024)) > 5


# compressed_mean_grads: a tree of stacked, 2-D and small leaves, per rank
TREE = {"a": (3, 40, 48), "b": (40, 36), "c": (5,), "d": (10, 40)}
CCFG = dict(rank=6, sketch_factor=3, min_dim=32)


def _mean_grads_case(world: int):
    """Each rank's gradients and EF residuals (numpy), the reference's
    sketches of each compressible leaf (by leaf index) and the reference's
    expected outputs: the mean gradients, each rank's new residuals and
    stats."""
    r = _ref()
    jax, jnp, rgc = r["jax"], r["jax.numpy"], r["repro.train.grad_compress"]
    ccfg_r = rgc.CompressionConfig(**CCFG)
    rng = np.random.default_rng(7)
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in TREE.items()}
             for _ in range(world)]
    errs = [{k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in TREE.items()
             if rgc.is_compressible(np.zeros(s), ccfg_r)} for _ in range(world)]
    key = jax.random.key(8)
    sketches, mean, new_err = {}, {}, [{} for _ in range(world)]
    stats = [dict(wire=0, dense=0, ef=0.0, loc=0.0, res=0.0) for _ in range(world)]
    for i, (k, shape) in enumerate(TREE.items()):
        for st in stats:
            st["dense"] += int(np.prod(shape))
        if k not in errs[0]:
            mean[k] = sum(g[k] for g in grads) / world
            for st in stats:
                st["wire"] += int(np.prod(shape))
            continue
        kk = jax.random.fold_in(key, i)
        sketches[i] = _ref_sketches(kk, shape[-2:], ccfg_r)
        local = [jnp.asarray(g[k]) + jnp.asarray(e[k]) for g, e in zip(grads, errs)]
        triples = [rgc.compress(kk, loc, ccfg_r) for loc in local]
        tm = tuple(sum(t[j] for t in triples) / world for j in range(3))
        ghat = rgc.decompress(kk, tm, shape, ccfg_r)
        mean[k] = np.asarray(ghat)
        for w in range(world):
            e = np.asarray(local[w] - ghat, np.float64)
            new_err[w][k] = e
            stats[w]["wire"] += sum(int(np.prod(t.shape)) for t in tm)
            stats[w]["ef"] += float((e * e).sum())
            stats[w]["loc"] += float((np.asarray(local[w], np.float64) ** 2).sum())
            stats[w]["res"] += float((e * e).sum())
    return grads, errs, sketches, mean, new_err, stats


def _port_mean_grads(grads, errs, sketches, group=None):
    sk = {i: _port_sketches(a) for i, a in sketches.items()}
    out, err, st = pgc.compressed_mean_grads(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in errs.items()}, 0,
        pgc.CompressionConfig(**CCFG), group, with_stats=True, sketches=sk)
    return ({k: v.numpy() for k, v in out.items()}, {k: v.numpy() for k, v in err.items()},
            {k: float(v) for k, v in st.items()})


def _check_mean_grads(rank, got, mean, new_err, stats):
    out, err, st = got
    assert list(out) == list(TREE) and set(err) == set(new_err[rank])
    for k in TREE:
        assert _rel(out[k], mean[k]) <= 1e-5, k
    for k in err:
        assert _rel(err[k], new_err[rank][k]) <= 1e-5, k
    want = stats[rank]
    assert st["comp/wire_floats"] == want["wire"] and st["comp/dense_floats"] == want["dense"]
    assert st["comp/ratio"] == pytest.approx(want["dense"] / want["wire"], rel=1e-6)
    assert st["comp/ef_norm"] == pytest.approx(np.sqrt(want["ef"]), rel=1e-5)
    assert st["comp/rel_err"] == pytest.approx(np.sqrt(want["res"] / want["loc"]), rel=1e-5)


def test_compressed_mean_grads_at_one_worker():
    grads, errs, sketches, mean, new_err, stats = _mean_grads_case(1)
    _check_mean_grads(0, _port_mean_grads(grads[0], errs[0], sketches), mean, new_err, stats)


def _rank(rank, world, port, case, out_q):
    """One gloo rank: its ``compressed_mean_grads`` over the group."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        grads, errs, sketches = case
        out_q.put((rank, _port_mean_grads(grads[rank], errs[rank], sketches, dist.group.WORLD)))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_compressed_mean_grads_in_two_gloo_ranks():
    """Two ranks all-reduce their triples: the reference's ``decompress`` of
    the mean of both ranks' ``compress`` triples, each rank's residuals and
    stats its own."""
    world = 2
    grads, errs, sketches, mean, new_err, stats = _mean_grads_case(world)
    mp = torch.multiprocessing
    out_q = mp.get_context("spawn").Queue()
    procs = mp.start_processes(_rank, args=(world, _free_port(), (grads, errs, sketches), out_q),
                               nprocs=world, join=False, start_method="spawn")
    results, deadline = {}, time.monotonic() + 180
    try:
        while len(results) < world:
            try:
                rank, out = out_q.get(timeout=1.0)
                results[rank] = out
            except queue.Empty:
                procs.join(timeout=0)  # raises if a rank failed
                assert time.monotonic() < deadline, "ranks did not report"
        while not procs.join(timeout=1.0):
            assert time.monotonic() < deadline, "ranks did not exit"
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
    for rank in range(world):
        _check_mean_grads(rank, results[rank], mean, new_err, stats)
    np.testing.assert_array_equal(results[0][0]["a"], results[1][0]["a"])


# ---------------------------------------------------------------------------
# state conversion, the train steps, the CLI
# ---------------------------------------------------------------------------


def test_train_state_and_error_state_convert():
    r = _ref()
    jax, rmodels, ropt, rgc = (r["jax"], r["repro.models"], r["repro.train.optimizer"],
                               r["repro.train.grad_compress"])
    cfg, cfg_r = _cfgs("llama3.2-1b", d_model=64, d_ff=256, vocab_size=128)
    params = rmodels.init_params(jax.random.key(0), cfg_r)
    oc = ropt.OptimizerConfig(master=True)
    opt = ropt.init_opt_state(params, oc)
    opt = {**opt, "m": jax.tree.map(lambda x: x + 1.0, opt["m"]), "step": opt["step"] + 3}
    st = convert.train_state(jax.tree.map(np.asarray, {"params": params, "opt": opt}), cfg,
                             device="cpu")
    assert all(p.requires_grad for p in st["params"].parameters())
    assert int(st["opt"]["step"]) == 3
    names = {n for n, _ in st["params"].named_parameters()}
    assert set(st["opt"]["m"]) == set(st["opt"]["v"]) == set(st["opt"]["master"]) == names
    assert all(bool((t == 1).all()) for t in st["opt"]["m"].values())
    ccfg_r = rgc.CompressionConfig(rank=4, min_dim=32)
    err = jax.tree.map(lambda e: e + np.arange(2).reshape((2,) + (1,) * (e.ndim - 1)),
                       rgc.init_error_state(params, ccfg_r, 2))
    e1 = convert.error_state(jax.tree.map(np.asarray, err), cfg, 1, device="cpu")
    want = pgc.init_error_state(st["params"], pgc.CompressionConfig(rank=4, min_dim=32))
    assert list(e1) == list(want)
    assert all(v.shape == want[k].shape and bool((v == 1).all()) for k, v in e1.items())


def test_train_checkpoint_restores_the_model_in_place(tmp_path):
    from repro_torch.checkpoint import restore, save

    cfg = _tiny_cfg()
    oc = popt.OptimizerConfig()
    st = pts.init_train_state(generator(0, "cpu"), cfg, oc, device="cpu")
    step, init_err = pts.make_compressed_train_step(cfg, oc, pgc.CompressionConfig(
        rank=4, min_dim=32), remat=None)
    st["err"] = init_err(st["params"])
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=16), device="cpu")
    st, _ = step(st, data.batch_at(0), 1)
    saved = {k: v.detach().clone() for k, v in st["params"].state_dict().items()}
    save(str(tmp_path), 1, st)
    with torch.no_grad():
        for p in st["params"].parameters():
            p.zero_()
    got, _, at = restore(str(tmp_path), st)
    assert at == 1 and got["params"] is st["params"]
    for k, v in got["params"].state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert torch.equal(got["opt"]["step"], st["opt"]["step"])
    assert set(got["err"]) == set(st["err"])


def test_launch_train_cli_on_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    rep = main(["--smoke", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
                "--grad-compress", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1",
                "--fail-at-step", "1"])
    assert rep.steps_run == 3 and rep.restarts == 1
    out = capsys.readouterr().out
    assert "DP volume ratio=" in out and "[train] done: 3 steps" in out
    with pytest.raises(ValueError, match="process group"):
        main(["--smoke", "--device", "cpu", "--mesh", "1x2", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="data axis"):
        main(["--smoke", "--device", "cpu", "--mesh", "4x1", "--ckpt-dir", str(tmp_path)])


@pytest.mark.slow
def test_microbatch_equivalence():
    """Gradient accumulation over 4 microbatches == one batch."""
    cfg = _tiny_cfg()
    oc = popt.OptimizerConfig(lr=1e-3, clip_norm=None)
    toks = torch.randint(0, cfg.vocab_size, (8, 32), generator=generator(1, "cpu"))
    outs = []
    for micro in (1, 4):
        st = pts.init_train_state(generator(0, "cpu"), cfg, oc, device="cpu")
        st, _ = pts.make_train_step(cfg, oc, remat=None, microbatch=micro)(st, {"tokens": toks})
        outs.append(st["params"].state_dict())
    for k in outs[0]:
        torch.testing.assert_close(outs[0][k], outs[1][k], atol=2e-5, rtol=0)


@pytest.mark.slow
def test_loss_decreases():
    cfg = _tiny_cfg()
    oc = popt.OptimizerConfig(lr=5e-3, warmup_steps=2, total_steps=40)
    st = pts.init_train_state(generator(0, "cpu"), cfg, oc, device="cpu")
    step = pts.make_train_step(cfg, oc, remat=None)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=8, seq_len=64), device="cpu")
    losses = []
    for i in range(30):
        st, m = step(st, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


@pytest.mark.slow
def test_remat_grad_equivalence():
    """remat=full/dots give the update of no remat."""
    cfg = _tiny_cfg()
    oc = popt.OptimizerConfig(lr=1e-3, clip_norm=None)
    toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=generator(1, "cpu"))
    ref = None
    for remat in (None, "dots", "full"):
        st = pts.init_train_state(generator(0, "cpu"), cfg, oc, device="cpu")
        st, _ = pts.make_train_step(cfg, oc, remat=remat)(st, {"tokens": toks})
        leaves = st["params"].state_dict()
        if ref is None:
            ref = leaves
        else:
            for k in ref:
                torch.testing.assert_close(ref[k], leaves[k], atol=2e-5, rtol=0)


@pytest.mark.slow
def test_train_checkpoint_restore_serve(tmp_path):
    """Loss falls, a crash mid-run recovers from its checkpoint, the final
    model serves tokens deterministically."""
    from repro_torch.checkpoint import latest_step, restore, run_resilient_loop
    from repro_torch.serve import generate

    cfg = _tiny_cfg()
    oc = popt.OptimizerConfig(lr=5e-3, warmup_steps=2, total_steps=40)
    st = pts.init_train_state(generator(0, "cpu"), cfg, oc, device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=8, seq_len=64), device="cpu")
    step = pts.make_train_step(cfg, oc, remat=None)
    report = run_resilient_loop(state=st, step_fn=lambda s, b, i: step(s, b),
                                batch_fn=data.batch_at, n_steps=30, ckpt_dir=str(tmp_path),
                                ckpt_every=10, fail_at_step=17)
    assert report.restarts == 1
    assert report.losses[-1] < report.losses[0] - 0.3
    assert latest_step(str(tmp_path)) == 30
    final, _, _ = restore(str(tmp_path), st)
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), generator=generator(1, "cpu"))
    out1 = generate(final["params"], cfg, prompt, 8)
    out2 = generate(final["params"], cfg, prompt, 8)
    assert torch.equal(out1, out2) and out1.shape == (2, 8)
