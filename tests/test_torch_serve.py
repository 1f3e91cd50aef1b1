"""The port's serving path (``repro_torch.serve``) and its stacked
Algorithm-3 engine against the JAX reference on shared inputs.

Sketches are drawn by the reference (its documented key derivation) and
cross through :mod:`repro_torch.convert`; histories and weights come from
numpy or the reference. SVD factors are unique only up to column signs, so
factors compare by reconstruction ``V_s Σ Uᵀ`` and by σ. Tolerances:

* the stacked engine against the per-head port engine, on the CPU: equal
  bit for bit (the same operations in the same order per head);
* reconstructions and σ against the reference: 1e-4 of the largest entry
  (fp32 QR, core solve and SVD in LAPACK against XLA's, over fp32 sketch
  sums taken in another order);
* engine accumulators C, R, M against the reference: 1e-4 absolute, the
  reference's own test's bound for its fold path;
* attention outputs and logits: 1e-4 of the largest entry.
"""

import dataclasses

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
from repro.stream.adaptive import allocate_shared_budget as r_allocate
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch import models as pmodels
from repro_torch import serve as pserve
from repro_torch.core import svd as psvd
from repro_torch.cur.streaming import streaming_cur_init
from repro_torch.kernels import ops
from repro_torch.serve import kv_cache as pkv
from repro_torch.serve import kv_compress as pkc
from repro_torch.stream import allocate_shared_budget as p_allocate
from repro_torch.stream import engine as peng

TOL = 1e-4


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype else t


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def _recon(fac):
    v_s, sig, u = (np.asarray(x, np.float64) for x in (fac.v_s, fac.sigma, fac.u))
    return np.einsum("...sr,...r,...dr->...sd", v_s, sig, u)


def _lowrank(rng, shape, rank, scales=None):
    """(..., S, d) histories of the given rank; ``scales`` per leading item."""
    *lead, S, d = shape
    h = rng.standard_normal((*lead, S, rank)) @ rng.standard_normal((*lead, rank, d))
    h = h + 1e-3 * rng.standard_normal(h.shape)
    if scales is not None:
        h = h * np.asarray(scales).reshape(*lead, 1, 1)
    return h.astype(np.float32)


# ---------------------------------------------------------------------------
# configuration and sizing
# ---------------------------------------------------------------------------


def test_kv_config_checks_and_sizes_match_reference():
    for kw in (dict(refresh_every=30, decode_panel=8), dict(adaptive=True, rank=4, min_rank=8)):
        with pytest.raises(ValueError):
            rkc.KVCompressionConfig(**kw)
        with pytest.raises(ValueError):
            pkc.KVCompressionConfig(**kw)
    for kw in (dict(), dict(rank=16, oversample=2), dict(rank=4, oversample=2, adaptive=True),
               dict(rank=8, adaptive=True, max_rank=12), dict(rank=64, oversample=4)):
        r, p = rkc.KVCompressionConfig(**kw), pkc.KVCompressionConfig(**kw)
        assert dataclasses.asdict(r) == dataclasses.asdict(p)
        for d in (16, 64, 128):
            assert pkc._sizes(d, p) == rkc._sizes(d, r)
            assert pkc._fac_width(d, p) == rkc._fac_width(d, r)


# ---------------------------------------------------------------------------
# the stacked engine
# ---------------------------------------------------------------------------

SIZES = dict(c=8, r=8, c0=16, r0=16, s_c=24, s_r=24)


def _stacked(N, m, n, seed=0, panel=None):
    g = torch.Generator()
    g.manual_seed(seed)
    st = psvd.spsvd_stacked_init(g, N, m, n, sizes=SIZES, osnap_p=4, panel=panel, device="cpu")
    A = torch.randn((N, m, n), generator=g)
    return st, A


# The stacked finalize's factors against the per-head one's: its batched
# sketched core solve (``_solve_least_squares``' batched ``Q.mT @ Y``) takes
# another CPU BLAS route than one matrix's product above 2 threads, so S, U
# and V leave the per-head ones there by rounding (at 3-8 threads: S 4.7e-7
# of the largest σ, U 2.0e-6, V 1.2e-6; bit for bit at 1 and 2 threads).
FINALIZE_TOL = 1e-5


def test_stacked_engine_equals_the_per_head_engine_bitwise():
    """Whole panels through ``spsvd_stacked_scan``, then a ragged tail
    panel: every head's C, R and M are the per-head engine's on
    ``sketches.head(n)``, bit for bit; its factors S (relative to the
    largest σ), U and V (unit columns) within :data:`FINALIZE_TOL` of the
    per-head finalize's at any thread count."""
    N, m, n, L = 5, 16, 70, 16
    st, A = _stacked(N, m, n)
    psvd.spsvd_stacked_scan(st, A, n // L, L)
    psvd.spsvd_stacked_update(st, A[:, :, 64:])
    U, S, V = psvd.spsvd_stacked_finalize(st, k=4)
    for i in range(N):
        h = psvd.spsvd_engine_init(None, m, n, sizes=SIZES, osnap_p=4, sketches=st.sk.head(i),
                                   device="cpu")
        for off in range(0, 64, L):
            peng.panel_update(h, A[i][:, off : off + L])
        peng.panel_update(h, A[i][:, 64:])
        u, s, v = psvd.spsvd_engine_finalize(h, k=4)
        for got, want in ((st.C[i], h.C), (st.R[i], h.R), (st.M[i], h.M)):
            assert torch.equal(got, want)
        for got, want, scale in ((S[i], s, float(s.abs().max())), (U[i], u, 1.0), (V[i], v, 1.0)):
            assert float((got - want).abs().max()) <= FINALIZE_TOL * scale


def _count_kernel1_calls(monkeypatch):
    calls = {"n": 0}
    for name in ("countsketch_batched", "countsketch_batched_fold"):
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, **kw):
            calls["n"] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    return calls


def test_stacked_engine_calls_kernel_1_a_number_of_times_independent_of_heads(monkeypatch):
    """Each wrapper call is one launch on the card: four per panel (Ψ, S_C,
    the Ω window, the S_R fold) and two per finalize, for any N."""
    calls = _count_kernel1_calls(monkeypatch)
    counts = []
    for N in (1, 3, 12):
        calls["n"] = 0
        st, A = _stacked(N, 16, 64)
        psvd.spsvd_stacked_scan(st, A, 4, 16)
        psvd.spsvd_stacked_finalize(st)
        counts.append(calls["n"])
    assert counts == [4 * 4 + 2] * 3


def test_stacked_sketch_items_and_windows_keep_their_orders():
    """``items`` views carry their heads' slices of the window orders, and a
    window of an indexed grid takes its slice of them, equal to the orders
    it would sort for itself."""
    g = torch.Generator()
    g.manual_seed(1)
    from repro_torch.core.sketching import StackedOSNAPSketch

    S = StackedOSNAPSketch.draw(g, 6, 9, 50, p=3)
    S.index_windows(8, base=10)
    sub = S.items(2, 5)
    for off in (10, 18, 42):
        win = sub.cols(off, 8)
        assert win._order, off
        perm, start = win._order[0]
        fresh_perm, fresh_start = StackedOSNAPSketch(hashes=win.hashes, signs=win.signs,
                                                     s=9).order()
        assert torch.equal(perm, fresh_perm) and torch.equal(start, fresh_start)
    assert not S.cols(11, 8)._order  # off the grid: sorted at use


def test_engine_scan_panels_is_the_per_panel_loop_bitwise():
    """``scan_panels`` (the reference's name) equals a loop of
    ``panel_update`` bit for bit, on the SP-SVD ops (per-panel body) and on
    fixed streaming CUR (Route A)."""
    g = torch.Generator()
    g.manual_seed(2)
    m, n, L = 24, 96, 16
    A = torch.randn((m, n), generator=g)
    sizes = dict(c=6, r=6, c0=12, r0=12, s_c=18, s_r=18)
    a = psvd.spsvd_engine_init(g, m, n, sizes=sizes, osnap_p=2, device="cpu")
    b = peng.fresh_state(a)
    peng.scan_panels(a, A, 4, L)
    for off in range(0, 4 * L, L):
        peng.panel_update(b, A[:, off : off + L])
    ci = torch.arange(0, n, 16, dtype=torch.int32)[:6]
    ri = torch.arange(0, m, 4, dtype=torch.int32)[:6]
    c = streaming_cur_init(g, m, n, ci, ri, s_c=18, s_r=18, sketch="countsketch", device="cpu")
    d = peng.fresh_state(c)
    peng.scan_panels(c, A, 5, L)
    for off in range(0, 5 * L, L):
        peng.panel_update(d, A[:, off : off + L])
    for x, y in ((a, b), (c, d)):
        assert x.offset == y.offset
        assert torch.equal(x.C, y.C) and torch.equal(x.R, y.R) and torch.equal(x.M, y.M)
    with pytest.raises(ValueError):
        peng.scan_panels(c, A, 2, L)  # past the operand


# ---------------------------------------------------------------------------
# prefill compression against the reference
# ---------------------------------------------------------------------------


def test_compress_history_matches_reference():
    rng = np.random.default_rng(20)
    hist = _lowrank(rng, (200, 32), 6)
    kc_r = rkc.KVCompressionConfig(rank=8, oversample=2, panel=64)
    kc_p = pkc.KVCompressionConfig(rank=8, oversample=2, panel=64)
    key = jax.random.key(21)
    want = rkc.compress_history(key, jnp.asarray(hist), kc_r)
    ctx = rkc._engine_init(key, 32, 200, kc_r, panel=64).ctx
    got = pkc.compress_history(None, _t(hist), kc_p,
                               sketches=convert.spsvd_sketches(ctx, device="cpu"))
    _close(got.sigma, want.sigma, what="sigma")
    _close(_recon(got), _recon(want), what="reconstruction")
    _close(pkc.compression_error(_t(hist), got), rkc.compression_error(jnp.asarray(hist), want),
           1e-3, "error")


def _head_batch_sketches(key, B, KV, d, S, kc):
    keys = jax.random.split(key, B * KV).reshape(B, KV)
    states = jax.vmap(jax.vmap(lambda k: rkc._engine_init(k, d, S, kc)))(keys)
    return convert.stacked_spsvd_sketches(states.ctx, device="cpu")


@pytest.mark.parametrize("adaptive", [False, True], ids=["uniform", "adaptive"])
def test_compress_head_batch_matches_reference(adaptive):
    """B·KV heads of distinct ranks and scales (no near-tied σ² marginals),
    a ragged tail panel; adaptive: the same per-head ranks."""
    B, KV, S, d = 2, 3, 100, 16
    rng = np.random.default_rng(7)
    hist = np.concatenate([_lowrank(rng, (B, 1, S, d), r, scales=[1.0 + r, 2.0 + r])
                           for r in (2, 4, 7)], axis=1)
    kw = dict(rank=4, oversample=2, panel=32, adaptive=adaptive, min_rank=2)
    kc_r, kc_p = rkc.KVCompressionConfig(**kw), pkc.KVCompressionConfig(**kw)
    key = jax.random.key(3)
    want = rkc.compress_head_batch(key, jnp.asarray(hist), kc_r)
    sk = _head_batch_sketches(key, B, KV, d, S, kc_r)
    got = pkc.compress_head_batch(None, _t(hist), kc_p, sketches=sk)
    assert got.v_s.shape == (B, KV, S, pkc._fac_width(d, kc_p))
    _close(got.sigma, want.sigma, what="sigma")
    _close(_recon(got), _recon(want), what="reconstruction")
    if adaptive:
        ranks = (got.sigma > 0).sum(-1)
        assert torch.equal(ranks, _t((np.asarray(want.sigma) > 0).sum(-1)))
        assert bool((ranks.sum(-1) <= KV * kc_p.rank).all())


def test_compress_head_batch_records_the_registry_metrics():
    from repro_torch.obs.metrics import MetricsRegistry

    B, KV, S, d = 1, 2, 64, 16
    hist = _t(_lowrank(np.random.default_rng(4), (B, KV, S, d), 3))
    reg = MetricsRegistry()
    g = torch.Generator()
    kc = pkc.KVCompressionConfig(rank=4, oversample=2, panel=32, adaptive=True, min_rank=2)
    fac = pserve.compress_head_batch(g, hist, kc, registry=reg)
    errs = pserve.compression_error(hist, fac)
    assert reg.counters["serve/kv_heads_compressed"] == B * KV
    np.testing.assert_allclose(sorted(reg.histograms["serve/kv_rel_err"]),
                               sorted(errs.reshape(-1).tolist()), rtol=1e-6)
    assert len(reg.histograms["serve/kv_head_rank"]) == B * KV
    r = fac.sigma.shape[-1]
    assert reg.gauges["serve/kv_compression_ratio"] == pytest.approx((S * d) / ((S + d + 1) * r))


def test_rank_allocation_matches_allocate_shared_budget():
    """The batched allocation is ``allocate_shared_budget`` per request (the
    port's and the reference's), ties and dead marginals included."""
    rng = np.random.default_rng(9)
    sigma = np.sort(rng.random((4, 3, 8)).astype(np.float32), axis=-1)[..., ::-1].copy()
    sigma[1, 2] = sigma[1, 1]  # a tie across heads
    sigma[2, :, 5:] = 0.0  # dead marginals
    kc = pkc.KVCompressionConfig(rank=3, adaptive=True, min_rank=1)
    masked, alloc = pkc._allocate_ranks(_t(sigma), kc)
    for b in range(4):
        want = p_allocate(_t(sigma[b] ** 2), 3 * kc.rank, floor=1, cap=8)
        assert torch.equal(alloc[b], want)
        ref = r_allocate(jnp.asarray(sigma[b] ** 2), 3 * kc.rank, floor=1, cap=8)
        assert np.array_equal(alloc[b].numpy(), np.asarray(ref))
    _, ref_alloc = rkc._allocate_ranks(jnp.asarray(sigma), rkc.KVCompressionConfig(
        rank=3, adaptive=True, min_rank=1))
    assert np.array_equal(alloc.numpy(), np.asarray(ref_alloc))
    keep = np.arange(8) < alloc.numpy()[..., None]
    assert np.array_equal(masked.numpy(), np.where(keep, sigma, 0))


def test_lowrank_decode_attention_and_error_match_reference():
    rng = np.random.default_rng(11)
    B, KV, G, S, d, r = 2, 2, 3, 40, 16, 5
    fac = [rkc.LowRankKV(*(jnp.asarray(rng.standard_normal(s).astype(np.float32)) for s in
                           ((B, KV, S, r), (B, KV, r), (B, KV, d, r)))) for _ in range(2)]
    pfac = [pkc.LowRankKV(*(_t(x) for x in (f.v_s, f.sigma, f.u))) for f in fac]
    q = rng.standard_normal((B, KV, G, d)).astype(np.float32)
    for length in (1, 23, S):
        want = rkc.lowrank_decode_attention(jnp.asarray(q), fac[0], fac[1], jnp.asarray(length))
        got = pkc.lowrank_decode_attention(_t(q), pfac[0], pfac[1], length)
        _close(got, want, what=f"length {length}")
    hist = rng.standard_normal((S, d)).astype(np.float32)
    one = rkc.LowRankKV(fac[0].v_s[0, 0], fac[0].sigma[0, 0], fac[0].u[0, 0])
    pone = pkc.LowRankKV(pfac[0].v_s[0, 0], pfac[0].sigma[0, 0], pfac[0].u[0, 0])
    _close(pkc.compression_error(_t(hist), pone), rkc.compression_error(jnp.asarray(hist), one),
           1e-5, "compression_error")


# ---------------------------------------------------------------------------
# the decode-native compressed cache against the reference
# ---------------------------------------------------------------------------


def test_compressed_cache_append_attend_matches_reference():
    """A converted layer (the reference's ``_convert_one`` key derivation,
    sketches handed across) appends 10 tokens: folds at +4 and +8, the
    refresh at +8; each step's attention output, then the engines and the
    refreshed factors against the reference's."""
    B, KV, G, hd, n_max, prompt, T = 1, 2, 2, 16, 64, 22, 10
    kw = dict(rank=4, oversample=2, panel=8, decode_panel=4, refresh_every=8)
    kc_r, kc_p = rkc.KVCompressionConfig(**kw), pkc.KVCompressionConfig(**kw)
    rng = np.random.default_rng(0)
    hist = _lowrank(rng, (B, KV, n_max, hd), 3)
    k_dense = hist.transpose(0, 2, 1, 3).copy()
    v_dense = k_dense[..., ::-1].copy()
    ref = rkv._convert_one(jax.random.key(42), jnp.asarray(k_dense), jnp.asarray(v_dense),
                           prompt_len=prompt, kc=kc_r)
    sk = convert.compressed_kv_sketches(ref, device="cpu")
    layer = {"k": _t(k_dense), "v": _t(v_dense)}
    (got,) = pkv._convert_stack(None, [layer], prompt, kc_p, sk)
    _close(_recon(got.k_fac), _recon(ref.k_fac), what="converted K factors")
    _close(_recon(got.v_fac), _recon(ref.v_fac), what="converted V factors")
    step = jax.jit(lambda c, q, k, v, ln: c.append_attend(q, k, v, ln))
    q_seq = rng.standard_normal((B, T, KV * G, hd)).astype(np.float32)
    for t, (phase, _) in enumerate(pkv.decode_schedule(kc_p, T)):
        pos = prompt + t
        args = [q_seq[:, t : t + 1], k_dense[:, pos : pos + 1], v_dense[:, pos : pos + 1]]
        o_ref, ref = step(ref, *(jnp.asarray(a) for a in args), jnp.asarray(pos, jnp.int32))
        o = got.append_attend(*(_t(a) for a in args), torch.tensor(pos, dtype=torch.int32),
                              phase)
        _close(o, o_ref, what=f"attention at step {t}")
        assert (int(got.eng_len), int(got.fac_len)) == (int(ref.eng_len), int(ref.fac_len))
    assert (int(got.eng_len), int(got.fac_len)) == (prompt + 8, prompt + 8)
    for name in ("C", "R", "M"):
        want = np.asarray(getattr(ref.k_eng, name)).reshape(getattr(got.k_eng, name).shape)
        np.testing.assert_allclose(getattr(got.k_eng, name).numpy(), want, atol=1e-4)
    _close(_recon(got.v_fac), _recon(ref.v_fac), what="refreshed V factors")


def test_init_compressed_kv_and_cache_nbytes_count_the_engine_state():
    kc = pkc.KVCompressionConfig(rank=4, oversample=2, decode_panel=4, refresh_every=8)
    g = torch.Generator()
    B, KV, hd, n_max = 2, 2, 16, 48
    c = pserve.init_compressed_kv(g, kc, batch=B, n_kv_heads=KV, head_dim=hd, n_max=n_max,
                                  device="cpu")
    sz = pkc._sizes(hd, kc)
    N, fw, p = B * KV, pkc._fac_width(hd, kc), pkc.OSNAP_P
    eng = N * (hd * sz["c"] + sz["r"] * n_max + sz["s_c"] * sz["s_r"]  # C, R, M
               + sz["r"] * sz["r0"] + sz["c"] * sz["c0"]  # G_R, G_C
               + 2 * p * (2 * hd + 2 * n_max))  # hashes and signs of Ψ, S_C, Ω, S_R
    fac = N * (n_max * fw + fw + hd * fw)
    recent = B * kc.refresh_every * KV * hd
    counters = 2  # fac_len, eng_len: 0-d int32
    assert pserve.cache_nbytes(c) == 4 * (2 * eng + 2 * fac + 2 * recent + counters)
    assert (int(c.fac_len), int(c.eng_len)) == (0, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pserve.init_compressed_kv(g, kc, batch=B, n_kv_heads=KV, head_dim=hd, n_max=n_max)


# ---------------------------------------------------------------------------
# generation, dense and compressed
# ---------------------------------------------------------------------------

N_TOKENS = 12
GEN_KC = dict(rank=4, oversample=2, panel=8, decode_panel=4, refresh_every=8)


@pytest.fixture(scope="module")
def llama():
    cfg_r = rconfigs.get_arch("llama3.2-1b").smoke_config()
    cfg_p = pconfigs.get_arch("llama3.2-1b").smoke_config()
    params = jax.jit(lambda k: rmodels.init_params(k, cfg_r))(jax.random.key(0))
    prompt = np.random.default_rng(0).integers(0, cfg_r.vocab_size, (2, 24)).astype(np.int32)
    model = convert.model_params(jax.tree.map(np.asarray, params), cfg_p, device="cpu")
    return cfg_r, cfg_p, params, model, prompt


def test_generate_dense_matches_reference(llama):
    cfg_r, cfg_p, params, model, prompt = llama
    want = rserve.generate(params, cfg_r, jnp.asarray(prompt), N_TOKENS)
    got = pserve.generate(model, cfg_p, _t(prompt), N_TOKENS)
    assert got.dtype == torch.int32 and got.shape == (2, N_TOKENS)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_generate_compressed_matches_reference(llama):
    """Greedy tokens with the compressed cache equal the reference's, and
    the logits of every decode step (fed the same tokens) agree; the
    conversion's sketches are the reference's, drawn with
    ``fold_in(key, n_tokens)`` as its ``generate`` draws them."""
    cfg_r, cfg_p, params, model, prompt = llama
    kc_r, kc_p = rkc.KVCompressionConfig(**GEN_KC), pkc.KVCompressionConfig(**GEN_KC)
    key = jax.random.key(1)
    want = np.asarray(rserve.generate(params, cfg_r, jnp.asarray(prompt), N_TOKENS, key=key,
                                      kv_compress=kc_r))
    lg, cache = jax.jit(lambda p, t: rmodels.prefill(p, cfg_r, t, 24 + N_TOKENS))(params, prompt)
    cache = rkv.compress_prefill_cache(jax.random.fold_in(key, N_TOKENS), cfg_r, cache, kc_r)
    ckv = cache["segments"][0][0]
    sketches = {0: convert.compressed_kv_sketches(ckv, device="cpu")}
    got = pserve.generate(model, cfg_p, _t(prompt), N_TOKENS, kv_compress=kc_p,
                          kv_sketches=sketches)
    assert np.array_equal(got.numpy(), want)

    plg, pcache = pmodels.prefill(model, cfg_p, _t(prompt), 24 + N_TOKENS)
    pcache = pserve.compress_prefill_cache(None, cfg_p, pcache, kc_p, sketches=sketches)
    assert all(isinstance(c, pserve.CompressedKV) for c in pcache["layers"])
    step = jax.jit(lambda p, c, t: rmodels.decode_step(p, cfg_r, c, t))
    for t, (phase, _) in enumerate(pserve.decode_schedule(kc_p, N_TOKENS - 1)):
        tok = want[:, t : t + 1]
        lg, cache = step(params, cache, jnp.asarray(tok))
        plg, pcache = pmodels.decode_step(model, cfg_p, pcache, _t(tok), phase=phase)
        _close(plg, lg, what=f"decode step {t}")
    layer = pcache["layers"][1]
    assert (int(layer.eng_len), int(layer.fac_len)) == (24 + 8, 24 + 8)  # two folds, one refresh


def test_sample_token_ties_and_temperature():
    logits = torch.tensor([[[0.5, 2.0, 2.0, -1.0]], [[3.0, 3.0, 3.0, 3.0]]])
    assert pserve.sample_token(None, logits).tolist() == [[1], [0]]
    g = torch.Generator()
    g.manual_seed(0)
    draws = torch.cat([pserve.sample_token(g, logits, 1.0) for _ in range(200)])
    assert draws.dtype == torch.int32 and int(draws.min()) >= 0 and int(draws.max()) < 4
    assert set(draws[1::2].reshape(-1).tolist()) == {0, 1, 2, 3}


def test_launch_serve_runs_on_the_cpu_and_takes_only_a_1x1_mesh(capsys):
    from repro_torch.launch import serve as launch

    out = launch.main(["--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "6",
                       "--kv-compress", "4"])
    assert out.shape == (2, 6)
    assert "compressed kv @ rank 4" in capsys.readouterr().out
    with pytest.raises(ValueError, match="1x1"):
        launch.main(["--device", "cpu", "--mesh", "4x2"])


# ---------------------------------------------------------------------------
# MoE and MLA serving (deepseek-v2-lite, smoke config)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def deepseek():
    cfg_r = rconfigs.get_arch("deepseek-v2-lite-16b").smoke_config()
    cfg_p = pconfigs.get_arch("deepseek-v2-lite-16b").smoke_config()
    params = jax.jit(lambda k: rmodels.init_params(k, cfg_r))(jax.random.key(2))
    prompt = np.random.default_rng(2).integers(0, cfg_r.vocab_size, (2, 24)).astype(np.int32)
    model = convert.model_params(jax.tree.map(np.asarray, params), cfg_p, device="cpu")
    return cfg_r, cfg_p, params, model, prompt


def test_generate_deepseek_matches_reference(deepseek):
    """Greedy tokens through MLA's latent cache and the capacity dispatch
    (``generate``'s default), then with ``kv_compress``: MLA latents are not
    converted, so the tokens stay the reference's."""
    cfg_r, cfg_p, params, model, prompt = deepseek
    want = np.asarray(rserve.generate(params, cfg_r, jnp.asarray(prompt), N_TOKENS))
    got = pserve.generate(model, cfg_p, _t(prompt), N_TOKENS)
    assert np.array_equal(got.numpy(), want)
    kc_r, kc_p = rkc.KVCompressionConfig(**GEN_KC), pkc.KVCompressionConfig(**GEN_KC)
    want_c = np.asarray(rserve.generate(params, cfg_r, jnp.asarray(prompt), N_TOKENS,
                                        kv_compress=kc_r))
    got_c = pserve.generate(model, cfg_p, _t(prompt), N_TOKENS, kv_compress=kc_p)
    assert np.array_equal(want_c, want) and np.array_equal(got_c.numpy(), want)


def test_compress_prefill_cache_passes_mla_latents_through(deepseek):
    """No layer converts; every latent is the same tensor, bit for bit the
    reference's; ``cache_nbytes`` counts the latents."""
    from repro_torch.obs.metrics import MetricsRegistry

    cfg_r, cfg_p, params, model, prompt = deepseek
    n_max = 24 + N_TOKENS
    _, ref_cache = jax.jit(lambda p, t: rmodels.prefill(p, cfg_r, t, n_max))(params, prompt)
    ref_out = rkv.compress_prefill_cache(jax.random.key(0), cfg_r, ref_cache,
                                         rkc.KVCompressionConfig(**GEN_KC))
    _, cache = pmodels.prefill(model, cfg_p, _t(prompt), n_max)
    reg = MetricsRegistry()
    out = pserve.compress_prefill_cache(torch.Generator(), cfg_p, cache,
                                        pkc.KVCompressionConfig(**GEN_KC), registry=reg)
    assert reg.counters["serve/kv_layers_converted"] == 0
    want = convert.dense_cache(jax.tree.map(np.asarray, ref_out), cfg_p, device="cpu")
    width = cfg_p.kv_lora_rank + cfg_p.rope_head_dim
    for got, before, ref in zip(out["layers"], cache["layers"], want["layers"]):
        assert set(got) == {"latent"} and got["latent"] is before["latent"]
        assert got["latent"].shape == (2, n_max, width)
        np.testing.assert_allclose(got["latent"].numpy(), ref["latent"].numpy(), atol=1e-5)
    assert pserve.cache_nbytes(out["layers"]) == cfg_p.n_layers * 2 * n_max * width * 4
    assert reg.gauges["serve/kv_cache_bytes"] == pserve.cache_nbytes(out)
    assert pserve.cache_nbytes(pmodels.init_cache(cfg_p, 2, n_max, device="cpu")) == \
        pserve.cache_nbytes(out)


def test_launch_serve_passes_dense_moe_for_deepseek(monkeypatch, capsys):
    """``--arch deepseek-v2-lite-16b`` serves its smoke config through the
    dropless MoE path, as the reference CLI."""
    from repro_torch.launch import serve as launch

    seen = {}

    def spy(*a, **kw):
        seen.update(kw)
        return pserve.generate(*a, **kw)

    monkeypatch.setattr(launch, "generate", spy)
    out = launch.main(["--device", "cpu", "--arch", "deepseek-v2-lite-16b", "--batch", "2",
                       "--prompt-len", "12", "--gen", "6"])
    assert out.shape == (2, 6) and seen["dense_moe"] is True
    assert "deepseek-v2-lite-16b-smoke" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Mamba-2, shared attention and cross-attention serving (smoke configs)
# ---------------------------------------------------------------------------

SSM_ARCHS = ["mamba2-1.3b", "zamba2-1.2b"]
VISION_ARCH = "llama-3.2-vision-90b"


@pytest.fixture(scope="module", params=SSM_ARCHS + [VISION_ARCH])
def hybrid(request):
    """A reference model (the vision arch's cross gates set to 0.5, as its
    init's 0 makes a cross layer add nothing), the port's copy, a prompt
    and, for the vision arch, numpy patch embeddings."""
    arch = request.param
    cfg_r = rconfigs.get_arch(arch).smoke_config()
    cfg_p = pconfigs.get_arch(arch).smoke_config()
    params = jax.jit(lambda k: rmodels.init_params(k, cfg_r))(jax.random.key(5))
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.full_like(leaf, 0.5)
        if getattr(path[-1], "key", None) == "gate" else leaf, params)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg_r.vocab_size, (2, 24)).astype(np.int32)
    vision = (rng.standard_normal((2, cfg_r.n_patches, cfg_r.d_vision)).astype(np.float32)
              if cfg_r.d_vision else None)
    model = convert.model_params(jax.tree.map(np.asarray, params), cfg_p, device="cpu")
    return arch, cfg_r, cfg_p, params, model, prompt, vision


def _vis(vision):
    return None if vision is None else _t(vision)


def test_generate_ssm_shared_and_cross_match_reference(hybrid):
    """Greedy tokens through Mamba-2's O(1) state, zamba2's shared-attention
    caches and the vision arch's static cross K/V equal the reference's."""
    arch, cfg_r, cfg_p, params, model, prompt, vision = hybrid
    want = rserve.generate(params, cfg_r, jnp.asarray(prompt), N_TOKENS, vision=vision)
    got = pserve.generate(model, cfg_p, _t(prompt), N_TOKENS, vision=_vis(vision))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_kv_compress_converts_only_attn_layers(hybrid):
    """The reference converts only ``ATTN`` layers: zamba2's shared-attention
    caches, every Mamba-2 state and the cross K/V pass through, the same
    tensors. Both packages count the ``ATTN`` layers
    (``serve/kv_layers_converted``): none for mamba2 and zamba2, whose
    compressed runs launch kernel 1 never and give the dense run's tokens."""
    from repro.obs.metrics import MetricsRegistry as RRegistry
    from repro_torch.obs.metrics import MetricsRegistry

    arch, cfg_r, cfg_p, params, model, prompt, vision = hybrid
    kc_r, kc_p = rkc.KVCompressionConfig(**GEN_KC), pkc.KVCompressionConfig(**GEN_KC)
    n_attn = sum(spec.mixer == pmodels.ATTN for spec in cfg_p.pattern)
    assert n_attn == (4 if arch == VISION_ARCH else 0)
    n_max = 24 + N_TOKENS
    _, ref_cache = jax.jit(lambda p, t, v: rmodels.prefill(p, cfg_r, t, n_max, vision=v))(
        params, prompt, vision)
    reg_r, reg_p = RRegistry(), MetricsRegistry()
    rkv.compress_prefill_cache(jax.random.key(0), cfg_r, ref_cache, kc_r, registry=reg_r)
    _, cache = pmodels.prefill(model, cfg_p, _t(prompt), n_max, _vis(vision))
    ops.reset_launches()
    out = pserve.compress_prefill_cache(torch.Generator(), cfg_p, cache, kc_p, registry=reg_p)
    assert reg_r.counters["serve/kv_layers_converted"] == n_attn
    assert reg_p.counters["serve/kv_layers_converted"] == n_attn
    for spec, got, before in zip(pmodels.layer_specs(cfg_p), out["layers"], cache["layers"]):
        if spec.mixer != pmodels.ATTN:
            assert got is before
    if n_attn:
        return
    assert ops.LAUNCHES["countsketch_batched"] == 0
    dense = np.asarray(rserve.generate(params, cfg_r, jnp.asarray(prompt), N_TOKENS))
    want = np.asarray(rserve.generate(params, cfg_r, jnp.asarray(prompt), N_TOKENS,
                                      kv_compress=kc_r))
    got = pserve.generate(model, cfg_p, _t(prompt), N_TOKENS, kv_compress=kc_p)
    assert np.array_equal(want, dense) and np.array_equal(got.numpy(), dense)


def test_dense_cache_of_ssm_and_cross_continues_the_reference_decode(hybrid):
    """A reference prefill cache (Mamba-2 conv windows and fp32 state,
    zamba2's shared K/V, cross K/V) converted to the port's per-layer cache
    decodes three steps as the reference does from it."""
    arch, cfg_r, cfg_p, params, model, prompt, vision = hybrid
    n_max = 24 + 4
    lg, cache = jax.jit(lambda p, t, v: rmodels.prefill(p, cfg_r, t, n_max, vision=v))(
        params, prompt, vision)
    pcache = convert.dense_cache(jax.tree.map(np.asarray, cache), cfg_p, device="cpu")
    kinds = {s.mixer for s in cfg_p.pattern}
    for spec, layer in zip(pmodels.layer_specs(cfg_p), pcache["layers"]):
        if spec.mixer == pmodels.MAMBA2:
            assert layer["ssm"].dtype == torch.float32 and layer["conv_x"].dtype == cfg_p.param_dtype
        if spec.mixer == pmodels.CROSS:
            assert layer["k"].shape == (2, cfg_p.n_patches, cfg_p.n_kv_heads, cfg_p.head_dim)
    assert pmodels.MAMBA2 in kinds or pmodels.CROSS in kinds
    step = jax.jit(lambda p, c, t: rmodels.decode_step(p, cfg_r, c, t))
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    for t in range(3):
        lg, cache = step(params, cache, tok)
        plg, pcache = pmodels.decode_step(model, cfg_p, pcache, _t(tok))
        _close(plg, lg, what=f"decode step {t}")
        tok = jnp.argmax(lg, -1).astype(jnp.int32)


def test_launch_serve_passes_vision_for_the_vlm(monkeypatch, capsys):
    """``--arch llama-3.2-vision-90b`` draws patch embeddings from the
    modality stub and passes them to ``generate`` as ``vision``, as the
    reference CLI; a text arch passes none."""
    from repro_torch.launch import serve as launch

    seen = {}

    def spy(*a, **kw):
        seen.update(kw)
        return pserve.generate(*a, **kw)

    monkeypatch.setattr(launch, "generate", spy)
    cfg = pconfigs.get_arch(VISION_ARCH).smoke_config()
    out = launch.main(["--device", "cpu", "--arch", VISION_ARCH, "--batch", "2",
                       "--prompt-len", "12", "--gen", "4"])
    assert out.shape == (2, 4)
    assert seen["vision"].shape == (2, cfg.n_patches, cfg.d_vision)
    assert seen["vision"].dtype == cfg.param_dtype and "vision-90b-smoke" in capsys.readouterr().out
    launch.main(["--device", "cpu", "--arch", "mamba2-1.3b", "--batch", "2", "--prompt-len", "12",
                 "--gen", "4"])
    assert seen["vision"] is None
