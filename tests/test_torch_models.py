"""The port's model stack (``repro_torch.models``, ``repro_torch.configs``)
against the JAX reference on shared inputs.

Weights come from the reference's ``init_params`` and cross through
:func:`repro_torch.convert.model_params` (bf16 leaves as their bits);
tokens are drawn with numpy. Tolerances:

* configs and segment patterns: equal field by field;
* attention (fp32): 2e-5 absolute, the reference's own test's bound on its
  flash attention against the naive one (both sides fp32, different
  summation orders and ``exp`` implementations);
* fp32 logits: 1e-5 of the largest |logit| (three layers of fp32 products
  summed in other orders, and other ``rsqrt``/``cos``/``sin`` ulps); the
  MoE aux loss likewise;
* MLA's projections, latent cache and outputs (fp32): 1e-5 of the largest
  entry (the attention bound above, one product deeper);
* bf16 logits: 3e-2 of the largest |logit| — both sides round every
  activation to bf16 (2^-8 relative), at different places (XLA fuses, the
  port rounds after each op), through three layers.

The vision arch's cross layers start with ``gate = 0`` (``tanh(0) = 0``:
the layer adds nothing), so its runs set every reference ``gate`` to 0.5
before converting, and both packages take the same numpy patch
embeddings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro.models import attention as rattn
from repro.models import mla as rmla
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch import models as pmodels
from repro_torch.models import attention as pattn
from repro_torch.models import mla as pmla

LOGIT_ARCHS = ["llama3.2-1b", "phi4-mini-3.8b", "mistral-nemo-12b", "musicgen-large",
               "gemma3-12b", "deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "mamba2-1.3b",
               "zamba2-1.2b", "llama-3.2-vision-90b"]
MOE_ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]
B, S, N_DECODE = 2, 40, 3


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype else t


def _close(got, want, tol, what=""):
    got, want = (t.detach() if torch.is_tensor(t) else t for t in (got, want))  # trainable
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def _fields(cfg) -> dict:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["pattern"] = tuple(b.signature for b in cfg.pattern)
    return d


@pytest.mark.parametrize("which", ["full_config", "smoke_config"])
@pytest.mark.parametrize("arch_id", list(rconfigs.ARCH_IDS))
def test_configs_match_reference_field_by_field(arch_id, which):
    ref = getattr(rconfigs.get_arch(arch_id), which)()
    port = getattr(pconfigs.get_arch(arch_id), which)()
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    assert _fields(port) == _fields(ref)
    assert port.param_dtype == getattr(torch, ref.dtype)
    assert port.d_inner == ref.d_inner
    assert port.validate_tpu_alignment() == ref.validate_tpu_alignment()
    assert pconfigs.get_arch(arch_id).SUPPORTED_SHAPES == rconfigs.get_arch(arch_id).SUPPORTED_SHAPES


def test_registry_answers_every_reference_arch():
    assert pconfigs.ARCH_IDS == rconfigs.ARCH_IDS
    assert pconfigs.supported_cells() == rconfigs.supported_cells()
    assert pconfigs.SHAPES == {k: pconfigs.ShapeCell(*dataclasses.astuple(v))
                               for k, v in rconfigs.SHAPES.items()}
    with pytest.raises(KeyError):
        pconfigs.get_arch("no-such-arch")


def _patterns():
    out = {}
    for arch_id in rconfigs.ARCH_IDS:
        for which in ("full_config", "smoke_config"):
            out[f"{arch_id}:{which}"] = getattr(rconfigs.get_arch(arch_id), which)().pattern
    A, L, M = (rmodels.BlockSpec(k) for k in (rmodels.ATTN, rmodels.ATTN_LOCAL, rmodels.MAMBA2))
    out.update({"single": (A,), "alternating": (A, L) * 5, "prefix_then_unit": (M, M, A, L, A, L),
                "ragged": (A, A, L, A, A, L, A), "unit_9": (A,) * 8 + (L,)})
    return out


PATTERNS = _patterns()


@pytest.mark.parametrize("name", list(PATTERNS))
def test_compile_pattern_matches_reference(name):
    pat = PATTERNS[name]
    port_pat = tuple(pmodels.BlockSpec(b.mixer, b.ffn) for b in pat)
    want = [(tuple(b.signature for b in s.unit), s.n_repeat) for s in rmodels.compile_pattern(pat)]
    got = [(tuple(b.signature for b in s.unit), s.n_repeat)
           for s in pmodels.compile_pattern(port_pat)]
    assert got == want


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

# the reference's cases (tests/test_models_smoke.py): (B, S, H, KV, D, window, chunk)
ATTN_CASES = [(2, 128, 4, 2, 16, None, 32), (1, 200, 8, 8, 8, None, 64),
              (2, 256, 4, 1, 16, 48, 32), (1, 96, 2, 2, 8, 20, 32)]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_matches_reference(case):
    Bq, Sq, H, KV, D, window, chunk = case
    rng = np.random.default_rng(sum(x or 0 for x in case))
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((Bq, Sq, H, D), (Bq, Sq, KV, D), (Bq, Sq, KV, D)))
    want = rattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                                 chunk=chunk)
    got = pattn.flash_attention(_t(q), _t(k), _t(v), window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("window", [None, 24])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 64, 2, 16)).astype(np.float32) for _ in range(2))
    for length in (1, 37, 64):
        want = rattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.asarray(length), window=window)
        got = pattn.decode_attention(_t(q), _t(kc), _t(vc), length, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _mla_pair(seed=0):
    cfg_r = rconfigs.get_arch("deepseek-v2-lite-16b").smoke_config()
    cfg_p = pconfigs.get_arch("deepseek-v2-lite-16b").smoke_config()
    params = jax.tree.map(np.asarray, rmla.init_mla(jax.random.key(seed), cfg_r))
    mod = pmla.MLA(torch.Generator(), cfg_p, torch.device("meta"))
    mod.load_state_dict({k: _t(v) for k, v in params.items()}, assign=True)
    return cfg_r, cfg_p, params, mod


def test_mla_projections_match_reference():
    """``_project`` (RoPE on q's rope part, one shared roped key per token)
    and ``_decompress`` (per-head K of nope + the broadcast rope key, V)."""
    cfg_r, cfg_p, params, mod = _mla_pair(1)
    x = np.random.default_rng(1).standard_normal((2, 12, cfg_r.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, 17)[None], (2, 12))
    want = rmla._project(params, jnp.asarray(x), jnp.asarray(pos), cfg_r)
    got = pmla._project(mod, _t(x), _t(pos), cfg_p)
    assert got[0].shape == (2, 12, cfg_p.n_heads, cfg_p.nope_head_dim + cfg_p.rope_head_dim)
    assert got[2].shape == (2, 12, 1, cfg_p.rope_head_dim)
    for name, g, w in zip(("q", "c_kv", "k_rope"), got, want):
        _close(g, w, 1e-5, name)
    want_kv = rmla._decompress(params, want[1], want[2], cfg_r)
    got_kv = pmla._decompress(mod, got[1], got[2], cfg_p)
    assert got_kv[1].shape[-1] == cfg_p.v_head_dim
    for name, g, w in zip(("k", "v"), got_kv, want_kv):
        _close(g, w, 1e-5, name)


def test_mla_prefill_and_decode_match_reference():
    """Prefill's output and its latent cache (r + rope wide, zeros past the
    prompt), then four decode steps each writing its entry in place at
    ``length`` (a 0-d int tensor)."""
    cfg_r, cfg_p, params, mod = _mla_pair(2)
    rng = np.random.default_rng(2)
    S, n_dec, cache_len = 10, 4, 16
    x = rng.standard_normal((2, S, cfg_r.d_model)).astype(np.float32)
    o_r, cache_r = rmla.mla_prefill(params, jnp.asarray(x), cfg_r, cache_len)
    o_p, cache_p = pmla.mla_prefill(mod, _t(x), cfg_p, cache_len)
    assert cache_p.shape == (2, cache_len, cfg_p.kv_lora_rank + cfg_p.rope_head_dim)
    _close(o_p, o_r, 1e-5, "prefill output")
    _close(cache_p, cache_r, 1e-5, "latent cache")
    assert not cache_p[:, S:].any()
    _close(pmla.mla_train(mod, _t(x), cfg_p), o_r, 1e-5, "train forward")
    for t in range(n_dec):
        xd = rng.standard_normal((2, 1, cfg_r.d_model)).astype(np.float32)
        o_r, cache_r = rmla.mla_decode(params, jnp.asarray(xd), cfg_r, cache_r,
                                       jnp.asarray(S + t, jnp.int32))
        o_p = pmla.mla_decode(mod, _t(xd), cfg_p, cache_p, torch.tensor(S + t, dtype=torch.int32))
        _close(o_p, o_r, 1e-5, f"decode step {t}")
    _close(cache_p, cache_r, 1e-5, "latent cache after decode")


# ---------------------------------------------------------------------------
# logits with converted weights
# ---------------------------------------------------------------------------


def open_gates(params, value: float = 0.5):
    """The reference pytree with every cross layer's ``gate`` set to ``value``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.full_like(leaf, value)
        if getattr(path[-1], "key", None) == "gate" else leaf, params)


def _reference_run(cfg, seed: int = 0, dense_moe: bool = False):
    """The reference's weights (numpy leaves; cross gates at 0.5), its
    train_logits and aux loss, prefill and three greedy decode steps,
    jitted; the tokens each step was fed; the patch embeddings (numpy, or
    ``None`` without a vision tower)."""
    params = open_gates(jax.jit(lambda k: rmodels.init_params(k, cfg))(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vision = (rng.standard_normal((B, cfg.n_patches, cfg.d_vision)).astype(np.float32)
              if cfg.d_vision else None)
    logits, aux = jax.jit(lambda p, t, v: rmodels.train_logits(p, cfg, t, v,
                                                               dense_moe=dense_moe))(
        params, toks, vision)
    lg, cache = jax.jit(lambda p, t, v: rmodels.prefill(p, cfg, t, S + N_DECODE + 1, vision=v,
                                                        dense_moe=dense_moe))(params, toks, vision)
    step = jax.jit(lambda p, c, t: rmodels.decode_step(p, cfg, c, t, dense_moe=dense_moe))
    fed, steps = [], []
    prefill_cache = jax.tree.map(np.asarray, cache)
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    for _ in range(N_DECODE):
        fed.append(np.asarray(tok))
        lg_t, cache = step(params, cache, tok)
        steps.append(np.asarray(lg_t))
        tok = jnp.argmax(lg_t, -1).astype(jnp.int32)
    return dict(params=jax.tree.map(np.asarray, params), toks=toks, logits=np.asarray(logits),
                aux=float(aux), prefill=np.asarray(lg), cache=prefill_cache, fed=fed,
                steps=steps, vision=vision)


def _port_logits(cfg, ref, tol, dense_moe: bool = False):
    model = convert.model_params(ref["params"], cfg, device="cpu")
    toks = _t(ref["toks"])
    vision = None if ref["vision"] is None else _t(ref["vision"])
    logits, aux = pmodels.train_logits(model, cfg, toks, vision, dense_moe=dense_moe)
    _close(aux, ref["aux"], tol, "aux loss")
    _close(logits, ref["logits"], tol, "train_logits")
    lg, cache = pmodels.prefill(model, cfg, toks, S + N_DECODE + 1, vision, dense_moe=dense_moe)
    assert cache["length"].dtype == torch.int32 and int(cache["length"]) == S
    _close(lg, ref["prefill"], tol, "prefill")
    for t, (tok, want) in enumerate(zip(ref["fed"], ref["steps"])):
        lg, cache = pmodels.decode_step(model, cfg, cache, _t(tok), dense_moe=dense_moe)
        _close(lg, want, tol, f"decode step {t}")
    assert int(cache["length"]) == S + N_DECODE
    return model


@pytest.mark.parametrize("arch_id,dense_moe",
                         [pytest.param(a, False, id=a) for a in LOGIT_ARCHS]
                         + [pytest.param(a, True, id=f"{a}-dense_moe") for a in MOE_ARCHS])
def test_smoke_logits_match_reference(arch_id, dense_moe):
    cfg_r = rconfigs.get_arch(arch_id).smoke_config()
    cfg_p = pconfigs.get_arch(arch_id).smoke_config()
    ref = _reference_run(cfg_r, dense_moe=dense_moe)
    model = _port_logits(cfg_p, ref, 1e-5, dense_moe=dense_moe)
    assert pmodels.param_count(model) == rmodels.param_count(ref["params"])
    if arch_id in MOE_ARCHS:
        assert ref["aux"] > 0
    if cfg_p.d_vision:  # the gates crossed open: the cross layers take part
        gates = [b.mixer.gate for b in model.blocks if hasattr(b.mixer, "gate")]
        assert gates and all(float(g) == 0.5 and g.dtype == torch.float32 for g in gates)


def test_bf16_smoke_logits_and_leaves_match_reference():
    """A bf16 config: every converted leaf keeps its bits, and the logits
    agree within the bf16 tolerance."""
    cfg_r = dataclasses.replace(rconfigs.get_arch("llama3.2-1b").smoke_config(), dtype="bfloat16")
    cfg_p = dataclasses.replace(pconfigs.get_arch("llama3.2-1b").smoke_config(), dtype="bfloat16")
    ref = _reference_run(cfg_r, seed=3)
    model = _port_logits(cfg_p, ref, 3e-2)
    tok = ref["params"]["embed"]["tok"]
    assert tok.dtype.name == "bfloat16" and model.embed.tok.dtype == torch.bfloat16
    assert np.array_equal(model.embed.tok.view(torch.int16).numpy(), tok.view(np.int16))
    w_q = ref["params"]["segments"][0][0]["mixer"]["w_q"]  # (n_repeat, D, H·hd)
    for layer in range(cfg_p.n_layers):
        got = model.blocks[layer].mixer.w_q.view(torch.int16).numpy()
        assert np.array_equal(got, w_q[layer].view(np.int16))


def test_dense_cache_converter_continues_the_reference_decode():
    """A reference prefill cache converted to the port's per-layer cache
    decodes as the reference does from it (gemma3: ring and full caches)."""
    cfg_r = rconfigs.get_arch("gemma3-12b").smoke_config()
    cfg_p = pconfigs.get_arch("gemma3-12b").smoke_config()
    ref = _reference_run(cfg_r, seed=1)
    model = convert.model_params(ref["params"], cfg_p, device="cpu")
    cache = convert.dense_cache(ref["cache"], cfg_p, device="cpu")
    assert int(cache["length"]) == S and len(cache["layers"]) == cfg_p.n_layers
    assert cache["layers"][0]["k"].shape == (B, cfg_p.window, cfg_p.n_kv_heads, cfg_p.head_dim)
    lg, _ = pmodels.decode_step(model, cfg_p, cache, _t(ref["fed"][0]))
    _close(lg, ref["steps"][0], 1e-5, "decode from a converted cache")


def test_scanned_segments_unstack_in_layer_order():
    """llama's 3 layers are one scanned segment: layer i of the port holds
    repeat i of the reference's stacked leaves."""
    cfg_r = rconfigs.get_arch("llama3.2-1b").smoke_config()
    cfg_p = pconfigs.get_arch("llama3.2-1b").smoke_config()
    assert [s.n_repeat for s in pmodels.segments(cfg_p)] == [3]
    params = jax.tree.map(np.asarray, jax.jit(lambda k: rmodels.init_params(k, cfg_r))(
        jax.random.key(7)))
    model = convert.model_params(params, cfg_p, device="cpu")
    seg = params["segments"][0][0]
    for layer, block in enumerate(model.blocks):
        assert np.array_equal(block.ffn.w_down.detach().numpy(), seg["ffn"]["w_down"][layer])
        assert np.array_equal(block.norm1.detach().numpy(), seg["norm1"]["scale"][layer])


@pytest.mark.parametrize("arch_id", list(pconfigs.ARCH_IDS))
def test_entry_points_raise_without_cuda_and_every_arch_builds_on_the_cpu(arch_id):
    """Every arch in ``configs/`` builds, its cache too, on the CPU when asked
    (no block kind is left unported); without a card the entry points raise
    rather than fall back."""
    cfg = pconfigs.get_arch(arch_id).smoke_config()
    g = torch.Generator()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmodels.init_params(g, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            pmodels.init_cache(cfg, 1, 8)
    model = pmodels.init_params(g, cfg, device="cpu")
    assert len(model.blocks) == cfg.n_layers
    assert len(pmodels.init_cache(cfg, 1, 8, device="cpu")["layers"]) == cfg.n_layers
    shapes = jax.eval_shape(lambda k: rmodels.init_params(
        k, rconfigs.get_arch(arch_id).smoke_config()), jax.random.key(0))
    assert pmodels.param_count(model) == rmodels.param_count(shapes)


# the published widths: deepseek-v2-lite, mamba2-1.3b and zamba2-1.2b whole,
# kimi-k2 cut to its first two layers (one dense, one MoE), the vision model
# to its first ten (two [4 self + 1 cross] units); parameter totals from the
# reference's eval_shape
FULL_WIDTH = {"deepseek-v2-lite-16b": (None, 15_706_470_400),
              "kimi-k2-1t-a32b": (2, 19_967_675_392),
              "mamba2-1.3b": (None, 1_446_714_368),
              "zamba2-1.2b": (None, 1_268_633_600),
              "llama-3.2-vision-90b": (10, 10_668_384_258)}


def _full_width(arch_id, mod):
    depth, _ = FULL_WIDTH[arch_id]
    cfg = mod.get_arch(arch_id).full_config()
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth, pattern=cfg.pattern[:depth])
    return cfg


@pytest.mark.parametrize("arch_id", list(FULL_WIDTH))
def test_full_width_parameter_shapes_match_reference(arch_id):
    """Every parameter's name, shape and dtype at the published widths, the
    reference's ``jax.eval_shape(init_params)`` (through
    ``convert.model_state``, on zero-stride stand-ins) against the port's
    model built on the ``meta`` device; no weight is drawn."""
    cfg_r, cfg_p = _full_width(arch_id, rconfigs), _full_width(arch_id, pconfigs)
    shapes = jax.eval_shape(lambda k: rmodels.init_params(k, cfg_r), jax.random.key(0))
    stand_in = jax.tree.map(lambda l: np.broadcast_to(np.zeros((), l.dtype), l.shape), shapes)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            convert.model_state(stand_in, cfg_p).items()}
    model = pmodels.Transformer(torch.Generator(), cfg_p, torch.device("meta"))
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in model.state_dict().items()}
    assert got == want
    total = FULL_WIDTH[arch_id][1]
    assert pmodels.param_count(model) == rmodels.param_count(shapes) == total
    fp32 = ("ffn.router", "mixer.dt_bias", "mixer.a_log", "mixer.d_skip", "mixer.gate")
    assert all(v.dtype == torch.float32 for k, v in model.state_dict().items()
               if k.endswith(fp32))
    if arch_id == "zamba2-1.2b":  # one shared GQA, counted once; its blocks hold no mixer
        assert sum(k.startswith("shared.") for k in got) == 4
        assert not any(".mixer." in k for k in got
                       if k.startswith(tuple(f"blocks.{i}." for i in (7, 13, 19, 25, 31, 37))))


def test_model_params_keeps_moe_and_mla_leaves_bitwise():
    """bf16 deepseek: the nested shared-expert FFN, the expert stacks of the
    scanned MoE segment (unstacked by layer), the fp32 router and the MLA
    weights cross with their bits."""
    cfg_r = dataclasses.replace(rconfigs.get_arch("deepseek-v2-lite-16b").smoke_config(),
                                dtype="bfloat16")
    cfg_p = dataclasses.replace(pconfigs.get_arch("deepseek-v2-lite-16b").smoke_config(),
                                dtype="bfloat16")
    params = jax.tree.map(np.asarray, jax.jit(lambda k: rmodels.init_params(k, cfg_r))(
        jax.random.key(4)))
    model = convert.model_params(params, cfg_p, device="cpu")
    moe_seg = params["segments"][1][0]  # layers 1-2, stacked on the repeat axis
    for rep, layer in enumerate((1, 2)):
        blk = model.blocks[layer]
        for name, got, want in (("shared.w_gate", blk.ffn.shared.w_gate,
                                 moe_seg["ffn"]["shared"]["w_gate"][rep]),
                                ("w_down", blk.ffn.w_down, moe_seg["ffn"]["w_down"][rep]),
                                ("mixer.w_uk", blk.mixer.w_uk, moe_seg["mixer"]["w_uk"][rep])):
            assert got.dtype == torch.bfloat16, name
            assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16)), name
        assert blk.ffn.router.dtype == torch.float32
        assert np.array_equal(blk.ffn.router.detach().numpy(), moe_seg["ffn"]["router"][rep])
    assert np.array_equal(model.blocks[0].ffn.w_up.view(torch.int16).numpy(),
                          params["segments"][0][0]["ffn"]["w_up"].view(np.int16))


def test_port_init_draws_the_reference_distribution():
    """Not the reference's bits (torch cannot reproduce jax.random): the same
    shapes and dtypes, truncated-normal scales and unit norms."""
    cfg = pconfigs.get_arch("phi4-mini-3.8b").smoke_config()
    g = torch.Generator()
    g.manual_seed(0)
    model = pmodels.init_params(g, cfg, device="cpu")
    ref = jax.tree.map(np.asarray, jax.jit(lambda k: rmodels.init_params(
        k, rconfigs.get_arch("phi4-mini-3.8b").smoke_config()))(jax.random.key(0)))
    w = model.blocks[0].mixer.w_q
    assert w.shape == ref["segments"][0][0]["mixer"]["w_q"].shape[1:]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-6
    assert torch.equal(model.final_norm, torch.ones(cfg.d_model))
    assert "lm_head" in ref["embed"] and model.embed.lm_head.shape == ref["embed"]["lm_head"].shape
