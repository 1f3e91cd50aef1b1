"""The port's decode loop in its graph-ready form (``repro_torch.serve.decode``,
the counterpart of the reference's ``_fused_decode_step``) on the CPU.

On the card ``generate`` replays CUDA graphs of the decode step; here the
same body runs eagerly, and these tests hold what a graph needs of it:
the cache's ``length`` (and a compressed cache's ``fac_len``, ``eng_len``)
is a 0-d int32 read on the device, no step reads a host value from a
tensor, no step moves a cache buffer, and the host's phase schedule is the
reference's ``lax.cond`` gates. The card's own test (graph tokens equal to
the eager route's) is ``tests/test_torch_cuda.py::test_cuda_generate_graphs_match_eager_route``.

Weights come from the reference's ``init_params`` (cross gates opened to
0.5) and cross through :func:`repro_torch.convert.model_params`; prompts
and patch embeddings come from numpy; the compressed cache takes the
reference's sketches (``convert.compressed_kv_sketches``). Tolerances:
greedy tokens equal; each decode step's logits within 1e-5 of the largest
|logit| (the port's model tests' bound: fp32 products summed in other
orders, other ``rsqrt``/``cos``/``sin`` ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro import serve as rserve
from repro.serve import kv_cache as rkv
from repro.serve import kv_compress as rkc
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch import models as pmodels
from repro_torch import serve as pserve
from repro_torch.kernels import ops
from repro_torch.models.blocks import FOLD, PLAIN, REFRESH
from repro_torch.serve import decode as pdecode
from repro_torch.serve import kv_cache as pkv
from repro_torch.serve import kv_compress as pkc

ARCHS = ["llama3.2-1b", "phi4-mini-3.8b", "mistral-nemo-12b", "musicgen-large", "gemma3-12b",
         "deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "mamba2-1.3b", "zamba2-1.2b",
         "llama-3.2-vision-90b"]
B, S, N = 2, 16, 6
N_COMP = 12  # 11 decode steps: a fold at step 3, the refresh at step 7, plain steps after it
KC = dict(rank=4, oversample=2, panel=8, decode_panel=4, refresh_every=8)
CLI_KC = dict(rank=16, oversample=2, panel=32, decode_panel=8, refresh_every=32, min_rank=4)
TOL = 1e-5


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype else t


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max abs err {err} > {TOL} x {scale}"


def _reference(arch_id: str, seed: int = 0):
    """The reference's config, weights (cross gates at 0.5), a numpy prompt
    and patch embeddings (``None`` without a vision tower)."""
    cfg = rconfigs.get_arch(arch_id).smoke_config()
    params = jax.jit(lambda k: rmodels.init_params(k, cfg))(jax.random.key(seed))
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.full_like(leaf, 0.5)
        if getattr(path[-1], "key", None) == "gate" else leaf, params)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vision = (rng.standard_normal((B, cfg.n_patches, cfg.d_vision)).astype(np.float32)
              if cfg.d_vision else None)
    return cfg, params, prompt, vision


def _reference_steps(cfg, params, prompt, vision, toks, cache=None):
    """The reference's decode_step logits fed ``toks`` (its generate's
    tokens), from its prefill cache or from ``cache``."""
    n = toks.shape[1]
    if cache is None:
        _, cache = jax.jit(lambda p, t, v: rmodels.prefill(p, cfg, t, S + n, vision=v))(
            params, prompt, vision)
    step = jax.jit(lambda p, c, t: rmodels.decode_step(p, cfg, c, t))
    out = []
    for i in range(n - 1):
        lg, cache = step(params, cache, jnp.asarray(toks[:, i : i + 1]))
        out.append(np.asarray(lg))
    return out


def _port_run(model, cfg, prompt, n, vision=None, **kw):
    logits = []
    toks = pserve.generate(model, cfg, _t(prompt), n,
                           vision=None if vision is None else _t(vision),
                           on_step=lambda i, lg: logits.append(lg.clone()), **kw)
    return toks, logits


@pytest.mark.parametrize("arch_id", ARCHS)
def test_generate_tokens_and_step_logits_match_reference(arch_id):
    """Greedy ``generate`` gives the reference's ``generate`` tokens, and the
    logits of each of its decode steps (the device length, the eager route
    of the graphs' body) the reference's ``decode_step`` logits fed the
    same tokens."""
    cfg_r, params, prompt, vision = _reference(arch_id)
    cfg_p = pconfigs.get_arch(arch_id).smoke_config()
    want = np.asarray(rserve.generate(params, cfg_r, jnp.asarray(prompt), N,
                                      vision=None if vision is None else jnp.asarray(vision)))
    ref_logits = _reference_steps(cfg_r, params, prompt, vision, want)
    model = convert.model_params(jax.tree.map(np.asarray, params), cfg_p, device="cpu")
    stats = {}
    got, logits = _port_run(model, cfg_p, prompt, N, vision, stats=stats)
    assert np.array_equal(got.numpy(), want)
    assert len(logits) == N - 1
    for i, (g, w) in enumerate(zip(logits, ref_logits)):
        _close(g, w, f"{arch_id} decode step {i}")
    assert stats == dict(route="eager", eager_steps=N - 1, refresh_steps=0, graphs=0, replays=0,
                         pool_bytes=0)


@pytest.mark.parametrize("adaptive", [False, True], ids=["uniform", "adaptive"])
def test_compressed_generate_tokens_and_step_logits_match_reference(adaptive):
    """llama3.2-1b with the compressed cache through a fold, the refresh and
    plain steps after it: ``generate``'s tokens are the reference's, each
    step's logits its ``decode_step``'s on the cache its ``generate``
    converts (the sketches handed across)."""
    cfg_r, params, prompt, _ = _reference("llama3.2-1b")
    cfg_p = pconfigs.get_arch("llama3.2-1b").smoke_config()
    kc_r = rkc.KVCompressionConfig(**KC, adaptive=adaptive)
    kc_p = pkc.KVCompressionConfig(**KC, adaptive=adaptive)
    key = jax.random.key(1)
    want = np.asarray(rserve.generate(params, cfg_r, jnp.asarray(prompt), N_COMP, key=key,
                                      kv_compress=kc_r))
    _, cache = jax.jit(lambda p, t: rmodels.prefill(p, cfg_r, t, S + N_COMP))(params, prompt)
    cache = rkv.compress_prefill_cache(jax.random.fold_in(key, N_COMP), cfg_r, cache, kc_r)
    sketches = {0: convert.compressed_kv_sketches(cache["segments"][0][0], device="cpu")}
    ref_logits = _reference_steps(cfg_r, params, prompt, None, want, cache)
    model = convert.model_params(jax.tree.map(np.asarray, params), cfg_p, device="cpu")
    stats = {}
    got, logits = _port_run(model, cfg_p, prompt, N_COMP, kv_compress=kc_p, kv_sketches=sketches,
                            stats=stats)
    assert np.array_equal(got.numpy(), want)
    for i, (g, w) in enumerate(zip(logits, ref_logits)):
        _close(g, w, f"decode step {i}")
    assert stats["refresh_steps"] == 1 and stats["eager_steps"] == N_COMP - 1


@pytest.mark.parametrize("kc", [CLI_KC, KC], ids=["cli", "small"])
def test_decode_schedule_is_the_reference_gates(kc):
    """80 appends to the reference's compressed cache: each step's phase
    (plain, fold at window o, refresh) read from its ``eng_len`` and
    ``fac_len`` before and after the step equals ``decode_schedule``'s."""
    kc_r = rkc.KVCompressionConfig(**kc)
    n, hd = 80, 16
    cache = rkv.init_compressed_kv(jax.random.key(0), kc_r, batch=1, n_kv_heads=1, head_dim=hd,
                                   n_max=n + 1)
    step = jax.jit(lambda c, q, k, v, ln: c.append_attend(q, k, v, ln))
    x = jnp.asarray(np.random.default_rng(0).standard_normal((n, 1, 1, 1, hd)), jnp.float32)
    gates = []
    for t in range(n):
        eng, fac = int(cache.eng_len), int(cache.fac_len)
        _, cache = step(cache, x[t], x[t], x[t], jnp.asarray(t, jnp.int32))
        if int(cache.fac_len) != fac:
            gates.append((REFRESH, eng - fac))
        elif int(cache.eng_len) != eng:
            gates.append((FOLD, eng - fac))
        else:
            gates.append((PLAIN, None))
    assert pkv.decode_schedule(pkc.KVCompressionConfig(**kc), n) == gates
    assert {p for p, _ in gates} == {PLAIN, FOLD, REFRESH}
    assert pkv.decode_schedule(None, 5) == [(PLAIN, None)] * 5


def _converted(arch_id: str, kc=None, n_tokens: int = N_COMP):
    """A port model (the port's own seeded weights), a prompt and its
    prefilled (and, with ``kc``, converted) cache: ``(cfg, model, cache)``."""
    cfg = pconfigs.get_arch(arch_id).smoke_config()
    g = torch.Generator().manual_seed(0)
    model = pmodels.init_params(g, cfg, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    vision = (torch.randn((B, cfg.n_patches, cfg.d_vision), generator=g)
              if cfg.d_vision else None)
    _, cache = pmodels.prefill(model, cfg, prompt, S + n_tokens, vision)
    if kc is not None:
        cache = pserve.compress_prefill_cache(g, cfg, cache, kc)
    return cfg, model, cache


def _body(model, cfg, cache, temperature=0.0):
    """The graphs' body on ``cache``, with its token buffer and output."""
    tok = torch.zeros((B, 1), dtype=torch.int32)
    out = torch.zeros((B, N_COMP), dtype=torch.int32)
    step_i = torch.ones((), dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    return lambda phase: pdecode._fused_decode_step(model, cfg, cache, tok, gen, step_i,
                                                    temperature, False, out=out, phase=phase)


def _no_host_reads(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a tensor was read on the host")

    for name in ("item", "__int__", "__index__", "__bool__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_decode_step_reads_no_host_value(arch_id, monkeypatch):
    """One decode step of every arch's dense cache (sampling at temperature
    0.8 included) with ``Tensor.item``, ``__int__``, ``__index__``,
    ``__bool__`` and ``tolist`` raising: no value goes to the host."""
    cfg, model, cache = _converted(arch_id)
    body = _body(model, cfg, cache, temperature=0.8)
    with monkeypatch.context() as m:
        _no_host_reads(m)
        body(PLAIN)
    assert int(cache["length"]) == S + 1


def test_compressed_plain_and_fold_steps_read_no_host_value(monkeypatch):
    """The compressed cache's plain steps and its fold step (kernel 1's
    stacked launches through their plain versions, the window gathered at
    the device offsets) under the same guard; its refresh step is the one
    eager step, and stays outside it."""
    kc = pkc.KVCompressionConfig(**KC)
    cfg, model, cache = _converted("llama3.2-1b", kc)
    body = _body(model, cfg, cache)
    for phase, _ in pkv.decode_schedule(kc, 4):
        with monkeypatch.context() as m:
            _no_host_reads(m)
            body(phase)
    layer = cache["layers"][0]
    assert phase == FOLD and (int(layer.eng_len), int(layer.fac_len)) == (S + 4, S)


def _pointers(cache) -> list:
    return [t.data_ptr() for t in pkv._leaves(cache)]


@pytest.mark.parametrize("arch_id,compressed",
                         [("llama3.2-1b", True), ("mamba2-1.3b", False), ("zamba2-1.2b", False),
                          ("deepseek-v2-lite-16b", False), ("gemma3-12b", False)])
def test_decode_steps_keep_every_cache_buffer_in_place(arch_id, compressed):
    """Every tensor of the cache (Mamba-2's conv windows and state, the
    compressed cache's engines, factors, recent window and counters, the
    length) keeps its storage through plain steps, a fold and a refresh."""
    kc = pkc.KVCompressionConfig(**KC) if compressed else None
    cfg, model, cache = _converted(arch_id, kc)
    body = _body(model, cfg, cache)
    before = _pointers(cache)
    layers = list(cache["layers"])
    phases = pkv.decode_schedule(kc, N_COMP - 1)
    for phase, _ in phases:
        body(phase)
        assert _pointers(cache) == before
        assert all(a is b for a, b in zip(cache["layers"], layers))
    assert int(cache["length"]) == S + N_COMP - 1
    if compressed:
        assert REFRESH in {p for p, _ in phases}
        layer = cache["layers"][0]
        assert (int(layer.eng_len), int(layer.fac_len)) == (S + 8, S + 8)


def test_sample_token_draws_the_bits_of_multinomial():
    """At temperature > 0 the draw is ``torch.multinomial``'s one-sample draw
    from the same generator state, bit for bit."""
    logits = torch.randn((4, 1, 50), generator=torch.Generator().manual_seed(0))
    for t in (0.5, 1.0):
        got = pserve.sample_token(torch.Generator().manual_seed(7), logits, t)
        probs = torch.softmax(logits[:, 0] / t, dim=-1)
        want = torch.multinomial(probs, 1, generator=torch.Generator().manual_seed(7))
        assert got.dtype == torch.int32 and torch.equal(got.long(), want)


def test_captured_launches_count_once_per_replay():
    """A capture records the launches its wrappers made and takes them back
    out of ``LAUNCHES``; each replay adds them."""
    ops.reset_launches()
    ops.LAUNCHES["countsketch"] += 1
    with ops.captured_launches() as rec:
        ops.LAUNCHES["countsketch_batched"] += 8
    assert rec["countsketch_batched"] == 8 and rec["countsketch"] == 0
    assert ops.LAUNCHES["countsketch_batched"] == 0 and ops.LAUNCHES["countsketch"] == 1
    for _ in range(3):
        ops.add_launches(rec)
    assert ops.LAUNCHES["countsketch_batched"] == 24
    ops.reset_launches()


def test_eager_route_is_the_cpu_route():
    """``eager_route()`` changes nothing on the CPU, where every step is
    eager: the same tokens and stats inside it as outside."""
    cfg, model, _ = _converted("llama3.2-1b")
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(4))
    s1, s2 = {}, {}
    a = pserve.generate(model, cfg, prompt, 5, stats=s1)
    with ops.eager_route():
        b = pserve.generate(model, cfg, prompt, 5, stats=s2)
    assert torch.equal(a, b) and s1 == s2 and s1["route"] == "eager"
    assert not ops._EAGER


def test_length_is_a_device_int32_from_every_entry_point():
    """``init_cache`` and ``prefill`` give a 0-d int32 length; a compressed
    layer's counters are 0-d int32 too, its window grid at the prompt's end."""
    cfg, model, cache = _converted("llama3.2-1b", pkc.KVCompressionConfig(**KC))
    assert cache["length"].shape == () and cache["length"].dtype == torch.int32
    fresh = pmodels.init_cache(cfg, B, 8, device="cpu")["length"]
    assert fresh.shape == () and fresh.dtype == torch.int32 and int(fresh) == 0
    layer = cache["layers"][0]
    assert isinstance(layer, pserve.CompressedKV) and layer.base == S
    for t in (layer.fac_len, layer.eng_len):
        assert t.shape == () and t.dtype == torch.int32 and int(t) == S
