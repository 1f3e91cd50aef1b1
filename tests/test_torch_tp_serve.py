"""Serving under a (data, model) mesh (``generate`` under
``activation_sharding``, the compressed KV cache on a rank's heads,
``--mesh d x m`` of ``repro_torch.launch.serve``) against the JAX
reference's one-device ``repro.serve.generate``, in gloo ranks on the CPU.

The models are ``tests/test_torch_tp.py``'s: each arch's smoke config at
``tiny_cfg``'s widths (d_model 128, d_ff 512, 8 query and 4 KV heads of 16,
vocab 512), fp32, from the reference's ``init_params`` through ``convert``
(each rank cut by ``shard_params``): llama3.2-1b (3 ``ATTN`` layers),
gemma3-12b's last two layers (an ``ATTN_LOCAL`` ring of 32 slots that the
36 positions wrap, an untied ``lm_head``, soft-capped logits) and
musicgen-large's last layer (a GELU FFN, as many KV heads as query heads).
A batch of 4 × 24 numpy tokens, 12 new tokens; each data rank serves its
rows (``shard_batch``).

* Dense, at 1×2 and 2×1 (two ranks), for the three archs: greedy tokens
  equal to the reference's; each decode step's logits (``on_step``, fed the
  same tokens), prefill's last logits and the prefill cache's block
  (``convert.dense_cache(..., mesh=)``) within 1e-5 of the largest entry
  (the port's model tests' bound: fp32 products summed in another order).
* The compressed cache (``tests/test_torch_decode_graph.py``'s schedule:
  a fold at step 3, the refresh at step 7), uniform and adaptive, with the
  reference's sketches handed in whole, so the ranks' own selection of
  their heads is what is tested: tokens equal; each head's factors
  (reconstruction and σ) within 1e-4 of the largest entry, the adaptive
  ranks equal (``tests/test_torch_serve.py``'s bounds).
* Sampling at temperature 0.8: every rank's tokens are its rows of the
  one-rank port run's from the same seed.
* Data-only meshes serve deepseek-v2-lite (``dense_moe``) and mamba2 smoke
  configs at 2×1 against the reference. At 1×2 Mamba-2, shared and cross
  attention and the MoE archs pass the checks (``tests/test_torch_ep.py``
  and ``tests/test_torch_tp_hybrid.py`` serve them on the model axis); at
  model axis 3 a split head raises ``ValueError``.
* Controls that must fail the gates: ``_gqa_decode`` without its
  ``reduce_from_tp``; the vocab gather with its shards in the wrong order.
* The CLI at ``--mesh 1x2 --kv-compress 4`` in two ranks gives the ``1x1``
  CLI's tokens.
* 2×2 (four ranks): llama dense and compressed against the reference and
  against 2×1.

The ranks are spawned processes running :func:`_rank`, meeting at a file of
their own, one spawn per world; the JAX reference runs in this process.
"""

import dataclasses
import datetime
import queue
import shutil
import tempfile
import time

import numpy as np
import pytest
import torch

from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch import models as pmodels
from repro_torch import serve as pserve
from repro_torch.distributed import Mesh, activation_sharding
from repro_torch.distributed import sharding as ps
from repro_torch.serve import kv_cache as pkv

TINY = dict(d_model=128, d_ff=512, n_heads=8, n_kv_heads=4, head_dim=16, vocab_size=512)
ARCHS = {"llama3.2-1b": TINY, "gemma3-12b": dict(TINY, logit_softcap=30.0),
         "musicgen-large": dict(TINY, n_kv_heads=8)}
LAYERS = {"gemma3-12b": 2, "musicgen-large": 1}
LLAMA = "llama3.2-1b"
DATA_ONLY = ["deepseek-v2-lite-16b", "mamba2-1.3b"]  # their smoke configs, at 2x1
B, S, N = 4, 24, 12
KC = dict(rank=4, oversample=2, panel=8, decode_panel=4, refresh_every=8)
KC_ADAPTIVE = dict(KC, adaptive=True, min_rank=2)
TEMPERATURE, SAMPLE_SEED = 0.8, 5
TOL, FAC_TOL = 1e-5, 1e-4
SHAPES = [(1, 2), (2, 1)]
CLI = ["--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "10", "--kv-compress",
       "4"]


def _cfg(arch: str, mod=pconfigs):
    """``arch``'s smoke config (either package's), at this file's size for
    the dense archs."""
    cfg = mod.get_arch(arch).smoke_config()
    if arch not in ARCHS:
        return cfg
    cfg = dataclasses.replace(cfg, **ARCHS[arch])
    n = LAYERS.get(arch, cfg.n_layers)
    return dataclasses.replace(cfg, n_layers=n, pattern=cfg.pattern[len(cfg.pattern) - n:])


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"
    return err / scale


def _rows(x, shape, rank):
    """Rank ``rank``'s rows of a whole batch on a ``shape`` mesh."""
    d = shape[0]
    at = rank // shape[1]
    return x[at * len(x) // d:(at + 1) * len(x) // d]


def _recon(v_s, sigma, u):
    return np.einsum("...sr,...r,...dr->...sd", *(np.asarray(x, np.float64) for x in (v_s, sigma,
                                                                                      u)))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _model(case, cfg, mesh):
    return convert.model_params(case["params"], cfg, "cpu", mesh=mesh)


def _generate(model, cfg, prompt, mesh, **kw):
    logits, stats = [], {}
    with activation_sharding(mesh):
        toks = pserve.generate(model, cfg, prompt, N, stats=stats,
                               on_step=lambda i, lg: logits.append(lg.numpy().copy()), **kw)
    return dict(tokens=toks.numpy(), logits=logits, route=stats["route"])


def _dense(case, arch, mesh):
    """Greedy ``generate`` and a separate prefill (its logits and cache
    block) of ``arch`` on this rank."""
    cfg = _cfg(arch)
    model = _model(case, cfg, mesh)
    prompt = ps.shard_batch(torch.from_numpy(case["prompt"]), mesh)
    out = _generate(model, cfg, prompt, mesh, dense_moe=True)
    with activation_sharding(mesh):
        lg, cache = pmodels.prefill(model, cfg, prompt, S + N, dense_moe=True)
    out["prefill_logits"] = lg.numpy()
    out["cache"] = [{k: v.numpy() for k, v in layer.items()} for layer in cache["layers"]]
    return out


def _compressed(case, adaptive, mesh):
    """Greedy ``generate`` with the compressed cache on the reference's
    sketches (whole), and the factors of a separate conversion."""
    cfg = _cfg(LLAMA)
    kc = pserve.KVCompressionConfig(**(KC_ADAPTIVE if adaptive else KC))
    sketches = case["sketches"][adaptive]
    model = _model(case, cfg, mesh)
    prompt = ps.shard_batch(torch.from_numpy(case["prompt"]), mesh)
    out = _generate(model, cfg, prompt, mesh, kv_compress=kc, kv_sketches=sketches)
    with activation_sharding(mesh):
        _, cache = pmodels.prefill(model, cfg, prompt, S + N)
        cache = pserve.compress_prefill_cache(None, cfg, cache, kc, sketches=sketches)
    out["factors"] = [{name: tuple(getattr(getattr(c, name), f).numpy()
                                   for f in ("v_s", "sigma", "u"))
                       for name in ("k_fac", "v_fac")} for c in cache["layers"]]
    return out


def _sampled(case, mesh):
    cfg = _cfg(LLAMA)
    model = _model(case, cfg, mesh)
    prompt = ps.shard_batch(torch.from_numpy(case["prompt"]), mesh)
    g = torch.Generator()
    g.manual_seed(SAMPLE_SEED)
    return _generate(model, cfg, prompt, mesh, gen=g, temperature=TEMPERATURE)


def _control(case, kind, mesh):
    """1×2 with one collective broken on this rank: ``reduce`` —
    ``_gqa_decode`` without its ``reduce_from_tp`` (the decode steps'
    logits, fed the prompt's tokens); ``gather`` — the vocab's shards
    gathered in the wrong order (prefill's logits)."""
    from repro_torch.models import blocks, transformer

    cfg = _cfg(LLAMA)
    model = _model(case, cfg, mesh)
    prompt = ps.shard_batch(torch.from_numpy(case["prompt"]), mesh)
    real_decode, real_gather = blocks._gqa_decode, transformer.gather_vocab

    def unreduced(*a, **kw):
        blocks.reduce_from_tp = lambda x: x
        try:
            return real_decode(*a, **kw)
        finally:
            blocks.reduce_from_tp = ps.reduce_from_tp

    def reversed_shards(logits):
        whole = real_gather(logits)
        return torch.cat(torch.chunk(whole, mesh.shape["model"], dim=-1)[::-1], dim=-1)

    if kind == "reduce":
        blocks._gqa_decode = unreduced
    else:
        transformer.gather_vocab = reversed_shards
    try:
        with activation_sharding(mesh):
            lg, cache = pmodels.prefill(model, cfg, prompt, S + N)
            steps = []
            for i in range(N - 1):
                tok = torch.from_numpy(case["prompt"][:, i:i + 1])
                steps.append(pmodels.decode_step(model, cfg, cache, tok)[0].numpy())
    finally:
        blocks._gqa_decode, transformer.gather_vocab = real_decode, real_gather
    return dict(prefill_logits=lg.numpy(), logits=steps)


def _rank(rank, world, store, jobs, out_q):
    """One gloo rank: each job of ``jobs["run"]`` in turn on its mesh —
    ``("dense", arch, shape)``, ``("compressed", adaptive, shape)``,
    ``("sampled", shape)``, ``("control", kind)`` or ``("cli", argv)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(2)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        results = {}
        for job in jobs["run"]:
            kind = job[0]
            if kind == "cli":
                from repro_torch.launch.serve import main

                results[job] = main(list(job[1])).numpy()
                continue
            mesh = make_host_mesh(*(job[-1] if kind != "control" else (1, 2)))
            if kind == "dense":
                results[job] = _dense(jobs["cases"][job[1]], job[1], mesh)
            elif kind == "compressed":
                results[job] = _compressed(jobs["cases"][LLAMA], job[1], mesh)
            elif kind == "sampled":
                results[job] = _sampled(jobs["cases"][LLAMA], mesh)
            else:
                results[job] = _control(jobs["cases"][LLAMA], job[1], mesh)
        out_q.put((rank, results))
    finally:
        dist.destroy_process_group()


class _Ranks:
    """:func:`_rank` in ``world`` spawned processes, started at once and
    collected by :meth:`results` (so the reference runs here meanwhile),
    meeting at a file of their own (``tests/test_torch_tp.py``'s way)."""

    def __init__(self, world: int, jobs: dict):
        mp = torch.multiprocessing
        self.world, self.out_q = world, mp.get_context("spawn").Queue()
        self.store = tempfile.mkdtemp()
        self.procs = mp.start_processes(_rank, args=(world, f"{self.store}/store", jobs,
                                                     self.out_q),
                                        nprocs=world, join=False, start_method="spawn")

    def results(self, timeout: float = 240.0) -> dict:
        results, deadline = {}, time.monotonic() + timeout
        try:
            while len(results) < self.world:
                try:
                    rank, out = self.out_q.get(timeout=1.0)
                    results[rank] = out
                except queue.Empty:
                    self.procs.join(timeout=0)  # raises if a rank failed
                    assert time.monotonic() < deadline, "ranks did not report"
            while not self.procs.join(timeout=1.0):
                assert time.monotonic() < deadline, "ranks did not exit"
        finally:
            for p in self.procs.processes:
                if p.is_alive():
                    p.terminate()
            shutil.rmtree(self.store, ignore_errors=True)
        return results


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------


def _jax():
    import jax
    import jax.numpy as jnp

    from repro import configs as rconfigs
    from repro import models as rmodels
    from repro import serve as rserve
    from repro.serve import kv_cache as rkv
    from repro.serve import kv_compress as rkc

    return jax, jnp, rconfigs, rmodels, rserve, rkv, rkc


def _case(arch: str) -> dict:
    """What the ranks need of the reference's model of ``arch``: its
    weights (numpy) and the prompt."""
    jax, jnp, rconfigs, rmodels, rserve, rkv, rkc = _jax()
    cfg = _cfg(arch, rconfigs)
    params = jax.jit(lambda k: rmodels.init_params(k, cfg))(jax.random.key(0))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return dict(params=jax.tree.map(np.asarray, params), prompt=prompt, jax_params=params)


def _conversions(case: dict) -> None:
    """The reference's compressed runs of llama, uniform and adaptive, into
    ``case``: its ``generate`` step by step (prefill, jitted; the conversion with
    ``fold_in(key, n_tokens)``; ``sample_token``; ``_fused_decode_step``
    per token), keeping the conversion's sketches (whole, handed to the
    ranks), its factors and the tokens."""
    from repro.serve import decode as rdecode

    jax, jnp, rconfigs, rmodels, rserve, rkv, rkc = _jax()
    cfg, params, key = _cfg(LLAMA, rconfigs), case["jax_params"], jax.random.key(1)
    case["sketches"], case["compressed"] = {}, {}
    lg, cache0 = jax.jit(lambda p, t: rmodels.prefill(p, cfg, t, S + N))(params, case["prompt"])
    for adaptive in (False, True):
        kc = rkc.KVCompressionConfig(**(KC_ADAPTIVE if adaptive else KC))
        cache = dict(cache0, length=jnp.array(cache0["length"]))  # the loop donates its cache
        cache = rkv.compress_prefill_cache(jax.random.fold_in(key, N), cfg, cache, kc)
        ckv = cache["segments"][0][0]
        case["sketches"][adaptive] = {0: convert.compressed_kv_sketches(ckv, "cpu")}
        factors = {name: tuple(np.asarray(getattr(getattr(ckv, name), f))
                               for f in ("v_s", "sigma", "u")) for name in ("k_fac", "v_fac")}
        toks, k = [rserve.sample_token(key, lg, 0.0)], key
        for i in range(N - 1):
            tok, cache, k = rdecode._fused_decode_step(params, cfg, cache, toks[-1], k,
                                                       jnp.asarray(i, jnp.int32), 0.0, False)
            toks.append(tok)
        case["compressed"][adaptive] = dict(tokens=np.asarray(jnp.concatenate(toks, axis=1)),
                                            factors=factors)


def _reference(arch: str, case: dict) -> dict:
    """The reference's one-device runs of ``arch`` on the prompt: greedy
    tokens, prefill's logits and cache, each decode step's logits fed its
    tokens (not for the data-only archs); for llama also the compressed
    runs (:func:`_conversions`) and the decode steps' logits fed the
    prompt's tokens (the controls')."""
    jax, jnp, rconfigs, rmodels, rserve, rkv, rkc = _jax()
    cfg, params, prompt = _cfg(arch, rconfigs), case["jax_params"], case["prompt"]
    toks = np.asarray(rserve.generate(params, cfg, jnp.asarray(prompt), N, dense_moe=True))
    out = dict(tokens=toks)
    if arch in DATA_ONLY:
        return out
    lg0, cache0 = jax.jit(lambda p, t: rmodels.prefill(p, cfg, t, S + N))(params, prompt)
    step = jax.jit(lambda p, c, t: rmodels.decode_step(p, cfg, c, t))

    def forced(feed):
        cache, logits = cache0, []
        for i in range(N - 1):
            lg, cache = step(params, cache, jnp.asarray(feed[:, i:i + 1]))
            logits.append(np.asarray(lg))
        return logits

    out.update(logits=forced(toks), prefill_logits=np.asarray(lg0),
               cache=jax.tree.map(np.asarray, cache0))
    if arch == LLAMA:
        out["control_logits"] = forced(prompt)
        out["compressed"] = case["compressed"]
    return out


def _shipped(case: dict) -> dict:
    return {k: v for k, v in case.items() if k not in ("jax_params", "compressed")}


@pytest.fixture(scope="module")
def runs():
    """``(reference runs by arch, two ranks' results, four ranks' results,
    the one-rank port run at temperature 0.8)``. Three spawns run while the
    reference converts and generates here: two ranks of the dense, sampled,
    control, CLI and data-only jobs as soon as the weights are drawn, then,
    once the reference's conversions give the sketches, two ranks of the
    compressed jobs and four of 2×2."""
    cases = {arch: _case(arch) for arch in list(ARCHS) + DATA_ONLY}
    run = [("dense", arch, shape) for arch in ARCHS for shape in SHAPES]
    run += [("sampled", shape) for shape in SHAPES]
    run += [("control", "reduce"), ("control", "gather"), ("cli", tuple(CLI + ["--mesh", "1x2"]))]
    run += [("dense", arch, (2, 1)) for arch in DATA_ONLY]
    dense = _Ranks(2, dict(cases={a: _shipped(c) for a, c in cases.items()}, run=run))
    _conversions(cases[LLAMA])
    llama = {LLAMA: _shipped(cases[LLAMA])}
    comp = _Ranks(2, dict(cases=llama, run=[("compressed", adaptive, shape)
                                            for adaptive in (False, True) for shape in SHAPES]))
    four = _Ranks(4, dict(cases=llama, run=[("dense", LLAMA, (2, 2)), ("compressed", False, (2, 2)),
                                            ("compressed", True, (2, 2))]))
    refs = {arch: _reference(arch, case) for arch, case in cases.items()}
    cfg = _cfg(LLAMA)
    model = convert.model_params(llama[LLAMA]["params"], cfg, "cpu")
    g = torch.Generator()
    g.manual_seed(SAMPLE_SEED)
    sampled = pserve.generate(model, cfg, torch.from_numpy(llama[LLAMA]["prompt"]), N, gen=g,
                              temperature=TEMPERATURE).numpy()
    two = dense.results()
    for rank, res in comp.results().items():
        two[rank].update(res)
    return refs, two, four.results(), sampled


@pytest.fixture(scope="module")
def refs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def two_ranks(runs):
    return runs[1]


@pytest.fixture(scope="module")
def four_ranks(runs):
    return runs[2]


@pytest.fixture(scope="module")
def sampled_one_rank(runs):
    return runs[3]


def _check_dense(res, ref, cfg, shape, rank, what):
    assert np.array_equal(res["tokens"], _rows(ref["tokens"], shape, rank)), what
    assert res["route"] == "eager" and len(res["logits"]) == N - 1
    for i, (g, w) in enumerate(zip(res["logits"], ref["logits"])):
        _close(g, _rows(w, shape, rank), what=f"{what} decode step {i}")
    _close(res["prefill_logits"], _rows(ref["prefill_logits"], shape, rank),
           what=f"{what} prefill logits")
    mesh = Mesh(dict(zip(("data", "model"), shape)), rank)
    want = convert.dense_cache(ref["cache"], cfg, "cpu", mesh=mesh)
    assert len(res["cache"]) == len(want["layers"])
    for got, w in zip(res["cache"], want["layers"]):
        assert set(got) == set(w)
        for name in got:
            _close(got[name], w[name].float(), what=f"{what} cache {name}")


def _check_compressed(res, ref, shape, rank, adaptive, what):
    assert np.array_equal(res["tokens"], _rows(ref["tokens"], shape, rank)), what
    d, m = shape
    di, mi = rank // m, rank % m
    for layer, got in enumerate(res["factors"]):
        for name, (v_s, sigma, u) in got.items():
            Bl, KVl = sigma.shape[:2]
            blk = lambda x: x[layer, di * Bl:(di + 1) * Bl, mi * KVl:(mi + 1) * KVl]  # noqa: E731
            want = [blk(x) for x in ref["factors"][name]]
            _close(sigma, want[1], FAC_TOL, f"{what} layer {layer} {name} sigma")
            _close(_recon(v_s, sigma, u), _recon(*want), FAC_TOL,
                   f"{what} layer {layer} {name} reconstruction")
            if adaptive:
                assert np.array_equal((sigma > 0).sum(-1), (want[1] > 0).sum(-1)), what


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_generate_dense_matches_reference(refs, two_ranks, arch, shape):
    for rank, res in two_ranks.items():
        _check_dense(res[("dense", arch, shape)], refs[arch], _cfg(arch), shape, rank,
                     f"{arch} {shape} rank {rank}")


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["uniform", "adaptive"])
def test_generate_compressed_matches_reference(refs, two_ranks, adaptive, shape):
    """The reference's sketches handed in whole: each rank keeps its heads'
    and gets the reference's tokens and factors for them."""
    ref = refs[LLAMA]["compressed"][adaptive]
    for rank, res in two_ranks.items():
        _check_compressed(res[("compressed", adaptive, shape)], ref, shape, rank, adaptive,
                          f"{shape} rank {rank}")


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
def test_sampled_tokens_are_the_one_rank_runs(two_ranks, sampled_one_rank, shape):
    for rank, res in two_ranks.items():
        got = res[("sampled", shape)]["tokens"]
        assert np.array_equal(got, _rows(sampled_one_rank, shape, rank)), (shape, rank)
    if shape == (1, 2):
        assert np.array_equal(two_ranks[0][("sampled", shape)]["tokens"],
                              two_ranks[1][("sampled", shape)]["tokens"])


@pytest.mark.parametrize("arch", DATA_ONLY)
def test_data_axis_serves_every_arch(refs, two_ranks, arch):
    for rank, res in two_ranks.items():
        r = res[("dense", arch, (2, 1))]
        assert np.array_equal(r["tokens"], _rows(refs[arch]["tokens"], (2, 1), rank)), rank
        assert r["route"] == "eager" and len(r["logits"]) == N - 1


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b", "llama-3.2-vision-90b"])
def test_model_axis_raises_beyond_the_dense_stack(arch):
    """At model axis 2 Mamba-2, shared and cross attention pass the run
    time's checks: ``init_cache`` holds a rank's SSM heads and ``conv_x``
    channels (``conv_bc`` whole) and its KV heads of a shared or cross
    K/V cache, and ``prefill``, ``decode_step`` and ``generate`` run until
    their first collective, which a mesh without process groups refuses
    (``tests/test_torch_tp_hybrid.py`` runs them in ranks). At model axis 3
    a head would split: every entry point raises ``ValueError`` before any
    weight is read."""
    cfg = pconfigs.get_arch(arch).smoke_config()
    g = torch.Generator()
    g.manual_seed(0)
    mesh = Mesh({"data": 1, "model": 2}, 1)
    model = pmodels.init_params(g, cfg, device="cpu", mesh=mesh)
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    vision = torch.zeros((2, cfg.n_patches, cfg.d_vision)) if cfg.d_vision else None
    H, K = cfg.ssm_heads, cfg.ssm_conv
    with activation_sharding(mesh):
        cache = pmodels.init_cache(cfg, 2, 8, device="cpu")
        for layer in cache["layers"]:
            if "ssm" in layer:
                assert layer["ssm"].shape == (2, H // 2, cfg.ssm_state, cfg.d_inner // H)
                assert layer["conv_x"].shape == (2, K - 1, cfg.d_inner // 2)
                assert layer["conv_bc"].shape == (2, K - 1, 2 * cfg.ssm_groups * cfg.ssm_state)
            else:
                assert layer["k"].shape[2] == cfg.n_kv_heads // 2
        for call in (lambda: pmodels.prefill(model, cfg, tokens, 8, vision),
                     lambda: pmodels.decode_step(model, cfg, cache, tokens[:, :1]),
                     lambda: pserve.generate(model, cfg, tokens, 2, vision=vision)):
            with pytest.raises(ValueError, match="process group"):
                call()
    meta = pmodels.Transformer(torch.Generator(), cfg, torch.device("meta"))
    with activation_sharding(Mesh({"data": 1, "model": 3})):
        for call in (lambda: pmodels.init_cache(cfg, 2, 8, device="cpu"),
                     lambda: pmodels.prefill(meta, cfg, tokens, 8, vision),
                     lambda: pmodels.decode_step(meta, cfg, {}, tokens[:, :1]),
                     lambda: pserve.generate(meta, cfg, tokens, 2, vision=vision)):
            with pytest.raises(ValueError, match="heads"):
                call()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"])
def test_model_axis_admits_moe_and_mla(arch):
    """At model axis 2 the MoE archs pass the run time's checks: ``init_cache``
    holds a rank's KV heads of a GQA cache and the whole latent of an MLA
    one, and ``prefill``, ``decode_step`` and ``generate`` run until their
    first collective, which a mesh without process groups refuses
    (``tests/test_torch_ep.py`` runs them in ranks)."""
    cfg = pconfigs.get_arch(arch).smoke_config()
    g = torch.Generator()
    g.manual_seed(0)
    mesh = Mesh({"data": 1, "model": 2}, 1)
    model = pmodels.init_params(g, cfg, device="cpu", mesh=mesh)
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    with activation_sharding(mesh):
        cache = pmodels.init_cache(cfg, 2, 8, device="cpu")
        for layer in cache["layers"]:
            if "latent" in layer:
                assert layer["latent"].shape == (2, 8, cfg.kv_lora_rank + cfg.rope_head_dim)
            else:
                assert layer["k"].shape == (2, 8, cfg.n_kv_heads // 2, cfg.head_dim)
        for call in (lambda: pmodels.prefill(model, cfg, tokens, 8),
                     lambda: pmodels.decode_step(model, cfg, cache, tokens[:, :1]),
                     lambda: pserve.generate(model, cfg, tokens, 2)):
            with pytest.raises(ValueError, match="process group"):
                call()


@pytest.mark.parametrize("kind", ["reduce", "gather"])
def test_the_controls_fail_the_gates(refs, two_ranks, kind):
    """``_gqa_decode`` without its ``reduce_from_tp`` breaks every decode
    step's logits; the vocab's shards gathered in the wrong order break
    prefill's."""
    ref = refs[LLAMA]
    for res in two_ranks.values():
        r = res[("control", kind)]
        if kind == "reduce":
            _close(r["prefill_logits"], ref["prefill_logits"])  # prefill is untouched
            pairs = list(zip(r["logits"], ref["control_logits"]))
        else:
            pairs = [(r["prefill_logits"], ref["prefill_logits"])]
        for got, want in pairs:
            with pytest.raises(AssertionError):
                _close(got, want, 100 * TOL)


def test_launch_serve_cli_at_mesh_1x2_matches_1x1(two_ranks, capsys):
    from repro_torch.launch import serve as launch

    want = launch.main(CLI).numpy()
    assert "mesh 1x1" in capsys.readouterr().out
    for res in two_ranks.values():
        assert np.array_equal(res[("cli", tuple(CLI + ["--mesh", "1x2"]))], want)


def test_two_by_two_matches_the_reference_and_two_by_one(refs, two_ranks, four_ranks):
    """2×2: each rank's tokens, logits and cache block against the
    reference, and its tokens against the 2×1 rank of its data index."""
    ref = refs[LLAMA]
    for rank, res in four_ranks.items():
        _check_dense(res[("dense", LLAMA, (2, 2))], ref, _cfg(LLAMA), (2, 2), rank,
                     f"2x2 rank {rank}")
        other = two_ranks[rank // 2]
        assert np.array_equal(res[("dense", LLAMA, (2, 2))]["tokens"],
                              other[("dense", LLAMA, (2, 1))]["tokens"])
        for adaptive in (False, True):
            got = res[("compressed", adaptive, (2, 2))]
            _check_compressed(got, ref["compressed"][adaptive], (2, 2), rank, adaptive,
                              f"2x2 rank {rank}")
            assert np.array_equal(got["tokens"],
                                  other[("compressed", adaptive, (2, 1))]["tokens"])


# ---------------------------------------------------------------------------
# in one process: a rank's place without collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, rank", [((2, 1), 1), ((1, 2), 1), ((2, 2), 2)],
                         ids=["2x1-rank1", "1x2-rank1", "2x2-rank2"])
def test_rank_sketches_are_its_heads_of_the_whole_draw(shape, rank):
    """A rank draws the whole stack's sketches (its generator advancing as
    the one-rank run's) and keeps its rows' and KV heads' sketches, with
    the window orders built so far."""
    R, Bl, KVl, hd, n = 2, 2, 3, 8, 20
    kc = pserve.KVCompressionConfig(**KC)
    d, m = shape
    g_whole, g_rank = torch.Generator(), torch.Generator()
    g_whole.manual_seed(3)
    g_rank.manual_seed(3)
    whole = pkv._stacked_sketches(g_whole, R * Bl * d * KVl * m, hd, n, kc)
    with activation_sharding(Mesh(dict(zip(("data", "model"), shape)), rank)):
        mine = pkv._rank_sketches(g_rank, R, Bl, KVl, hd, n, kc, None)
        whole.omega.index_windows(4)
        handed = pkv._rank_sketches(None, R, Bl, KVl, hd, n, kc, whole)
    assert torch.equal(g_whole.get_state(), g_rank.get_state())
    di, mi = rank // m, rank % m
    heads = [(r * Bl * d + di * Bl + b) * KVl * m + mi * KVl + k
             for r in range(R) for b in range(Bl) for k in range(KVl)]
    for sk in (mine, handed):
        for i, h in enumerate(heads):
            a, w = sk.head(i), whole.head(h)
            assert torch.equal(a.g_r.mat, w.g_r.mat) and torch.equal(a.s_r.hashes, w.s_r.hashes)
            assert torch.equal(a.psi.signs, w.psi.signs)
    perm, start = whole.omega._windows[(4, 0)]
    p = whole.omega.p
    rows = [h * p + j for h in heads for j in range(p)]
    assert torch.equal(handed.omega._windows[(4, 0)][0], perm[rows])
    assert torch.equal(handed.omega._windows[(4, 0)][1], start[rows])


def test_sampling_draws_the_whole_batchs_noise_and_keeps_its_rows():
    logits = torch.randn((4, 1, 32), generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    want = pserve.sample_token(g, logits, TEMPERATURE)
    for rank in (0, 1):
        g = torch.Generator().manual_seed(1)
        with activation_sharding(Mesh({"data": 2, "model": 1}, rank)):
            got = pserve.sample_token(g, logits[2 * rank:2 * rank + 2], TEMPERATURE)
        assert torch.equal(got, want[2 * rank:2 * rank + 2])


def test_shard_batch_and_cache_cut_a_ranks_rows_and_heads():
    mesh = Mesh({"data": 2, "model": 2}, rank=3)
    x = torch.arange(8 * 3).reshape(8, 3)
    assert torch.equal(ps.shard_batch(x, mesh), x[4:])
    assert ps.shard_batch(None, mesh) is None
    with pytest.raises(ValueError, match="split"):
        ps.shard_batch(x[:3], mesh)
    kv = torch.arange(4 * 5 * 6 * 2.0).reshape(4, 5, 6, 2)
    cut = ps.shard_cache({"layers": [{"k": kv, "v": kv}], "length": torch.tensor(5)}, mesh)
    assert torch.equal(cut["layers"][0]["k"], kv[2:, :, 3:])
