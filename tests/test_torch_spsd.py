"""SPSD approximation (Algorithm 2: batch, streaming, adaptive, symmetric CUR)
and the engine's symmetric mode: the port against the JAX reference.

Both packages get the same kernel matrix, column indices and sketches
(drawn by the reference, handed across through numpy). Index sets and C
(copies of K's entries) must be equal; M and ``ScC`` within 1e-5 relative
(the same fp32 terms, summed in other orders); X within 1e-4 relative
(other LAPACK QR and eigensolvers behind the core solve and the PSD
projection). Within the port the chunk and per-panel routes agree bitwise
on C and within 1e-6 on M.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import clustered_points, tune_rbf_sigma  # noqa: E402
from repro import spsd as jspsd  # noqa: E402
from repro.core.leverage import leverage_scores as j_leverage  # noqa: E402
from repro.core.sketching import RowSampling as JRowSampling  # noqa: E402
from repro.cur import SELECTION_POLICIES  # noqa: E402
from repro.cur import symmetric_cur as j_symmetric_cur  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.spsd.batch import _leverage_pair as j_leverage_pair  # noqa: E402
from repro.stream.engine import stream_panels as j_stream  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import spsd as tspsd  # noqa: E402
from repro_torch.cur import cur_relative_error, spsd_to_cur, symmetric_cur  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.stream.engine import PanelOps, stream_panels, truncated_R  # noqa: E402

N = 240
_SPIKES = (17, 60, 133, 201)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _port(S):
    return convert.sketch_from_arrays(*convert.sketch_arrays(S), device="cpu")


@pytest.fixture(scope="module")
def K():
    """The reference's streaming-SPSD fixture: low rank plus a ridge plus
    four heavy, localised columns."""
    base = 0.01 * jax.random.normal(jax.random.key(0), (N, 64))
    K = base @ base.T + 0.001 * jnp.eye(N)
    for i, p in enumerate(_SPIKES):
        v = jnp.zeros((N,)).at[p].set(1.0) + 0.05 * jax.random.normal(jax.random.key(10 + i), (N,))
        K = K + 9.0 * jnp.outer(v, v)
    return np.array(K)


@pytest.fixture(scope="module")
def rbf():
    """An RBF kernel over 300 clustered points (σ from the median squared
    distance): ``(X, σ, K)`` as numpy arrays."""
    X = np.array(clustered_points(jax.random.key(1), 300, 16, n_clusters=8, spread=0.6))
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    sigma = float(1.0 / np.median(d2))
    K = np.array(jspsd.rbf_kernel_oracle(jnp.asarray(X), sigma)(None, None))
    return X, sigma, K


# ---------------------------------------------------------------------------
# the engine's symmetric mode
# ---------------------------------------------------------------------------


def test_symmetric_ops_reject_r_hooks():
    with pytest.raises(ValueError, match="symmetric"):
        PanelOps(name="bad", core_sketches=lambda ctx: (None, None), update_c=lambda *a: a[:2],
                 r_block=lambda *a: None, symmetric=True)
    with pytest.raises(ValueError, match="symmetric"):
        PanelOps(name="bad", core_sketches=lambda ctx: (None, None), update_c=lambda *a: a[:2],
                 update_r=lambda *a: None, symmetric=True)
    with pytest.raises(ValueError, match="exactly one"):
        PanelOps(name="bad2", core_sketches=lambda ctx: (None, None), update_c=lambda *a: a[:2])


@pytest.mark.parametrize("route", ["chunk", "per-panel"])
def test_symmetric_truncated_r_is_c_transpose(K, route):
    """R stays the (0, n_pad) placeholder through a stream with a ragged
    tail (240 = 4·50 + 40), and ``truncated_R`` is ``Cᵀ``."""
    ci = np.array([3, 17, 60, 99], np.int32)
    jst = jspsd.streaming_spsd_init(jax.random.key(1), N, jnp.asarray(ci), s=48, panel=50)
    st = tspsd.streaming_spsd_init(None, N, ci, sketches=(_port(jst.ctx.S1), _port(jst.ctx.S2)),
                                   panel=50, device="cpu")
    st = stream_panels(st, torch.from_numpy(K), 50, route=route)
    assert st.R.shape == (0, 250) and st.offset == 250  # the padded tail counts
    assert torch.equal(truncated_R(st), st.C.T)
    np.testing.assert_array_equal(st.C.numpy(), K[:, ci])


# ---------------------------------------------------------------------------
# batch Algorithm 2 and its baselines
# ---------------------------------------------------------------------------


def test_oracles_match_reference(rbf):
    X, sigma, K = rbf
    oracle = tspsd.rbf_kernel_oracle(torch.from_numpy(X), sigma)
    assert _rel(oracle(None, None), K) < 1e-5
    rows, cols = np.array([5, 0, 299, 5]), np.array([7, 8, 100])
    want = np.asarray(jspsd.rbf_kernel_oracle(jnp.asarray(X), sigma)(jnp.asarray(rows),
                                                                      jnp.asarray(cols)))
    assert _rel(oracle(torch.from_numpy(rows), torch.from_numpy(cols)), want) < 1e-5
    got = tspsd.matrix_oracle(torch.from_numpy(K))(torch.from_numpy(rows), torch.from_numpy(cols))
    np.testing.assert_array_equal(got.numpy(), K[rows][:, cols])


def _reference_batch(method, key, oracle, n, c, s):
    """Run the reference's ``method`` and return ``(result, port kwargs)``:
    the indices it drew and the sketches it drew, redrawn as it draws them."""
    res = getattr(jspsd, method)(key, oracle, n, c, *([s] if s else []))
    kw = dict(col_idx=convert.indices(res.col_idx, "cpu"))
    if method == "fast_spsd_wang":
        _, k_s = jax.random.split(key)
        probs = j_leverage(res.C)
        kw["sketch"] = _port(JRowSampling.draw(k_s, s, n, probs=probs / jnp.sum(probs),
                                               dtype=jnp.float32))
    elif method == "faster_spsd":
        _, k1, k2 = jax.random.split(key, 3)
        kw["sketches"] = convert.sketch_pair(j_leverage_pair(k1, k2, res.C, s), "cpu")
    return res, kw


@pytest.mark.parametrize("method,s", [("nystrom", None), ("optimal_core", None),
                                      ("fast_spsd_wang", 120), ("faster_spsd", 120)])
def test_batch_spsd_matches_reference(rbf, method, s):
    X, sigma, K = rbf
    n, c = K.shape[0], 24
    res_j, kw = _reference_batch(method, jax.random.key(5), jspsd.rbf_kernel_oracle(
        jnp.asarray(X), sigma), n, c, s)
    oracle = tspsd.rbf_kernel_oracle(torch.from_numpy(X), sigma)
    res = getattr(tspsd, method)(None, oracle, n, c, *([s] if s else []), **kw)
    np.testing.assert_array_equal(res.col_idx.numpy(), np.asarray(res_j.col_idx))
    assert _rel(res.C, res_j.C) < 1e-5  # the oracle's entries (fp32 sums in its GEMM)
    assert _rel(res.X, res_j.X) < 1e-4
    assert res.entries_observed == res_j.entries_observed
    Kt = torch.from_numpy(K)
    assert abs(float(tspsd.spsd_error_ratio(Kt, res)) - float(jspsd.spsd_error_ratio(
        jnp.asarray(K), res_j))) < 1e-4
    if method != "nystrom":  # the projected cores are PSD
        ev = torch.linalg.eigvalsh(0.5 * (res.X + res.X.T).double())
        assert float(ev.min()) > -1e-5 * float(ev.max())


def test_batch_spsd_validation(K):
    oracle = tspsd.matrix_oracle(torch.from_numpy(K))
    g = torch.Generator().manual_seed(0)
    for fn in (lambda: tspsd.nystrom(g, oracle, N, N + 1),
               lambda: tspsd.optimal_core(g, oracle, N, 0),
               lambda: tspsd.fast_spsd_wang(g, oracle, N, N + 5, 100),
               lambda: tspsd.faster_spsd(g, oracle, N, -1, 100)):
        with pytest.raises(ValueError, match="0 < c <= n"):
            fn()
    for fn in (lambda: tspsd.fast_spsd_wang(g, oracle, N, 10, 0),
               lambda: tspsd.faster_spsd(g, oracle, N, 10, -3)):
        with pytest.raises(ValueError, match="s > 0"):
            fn()
    with pytest.raises(ValueError, match="col_idx has"):
        tspsd.faster_spsd(g, oracle, N, 8, 64, col_idx=torch.arange(5))
    cs = convert.sketch_from_arrays("countsketch", dict(hashes=np.zeros(N, np.int32),
                                                        signs=np.ones(N, np.float32), s=64), "cpu")
    with pytest.raises(TypeError, match="RowSampling"):
        tspsd.faster_spsd(g, oracle, N, 8, 64, sketches=(cs, cs))
    with pytest.raises(TypeError, match="RowSampling"):
        tspsd.fast_spsd_wang(g, oracle, N, 8, 64, sketch=cs)


def test_port_draws_and_entry_accounting(K):
    """The port's own draws: every method finite, the Theorem-3 entry counts,
    and Algorithm 2 no worse than Nyström here."""
    Kt = torch.from_numpy(K)
    oracle = tspsd.matrix_oracle(Kt)
    g = torch.Generator().manual_seed(3)
    c, s = 20, 120
    res = {m: getattr(tspsd, m)(g, oracle, N, c, *([s] if "spsd" in m else []))
           for m in ("nystrom", "optimal_core", "fast_spsd_wang", "faster_spsd")}
    assert res["faster_spsd"].entries_observed == N * c + s * s
    assert res["fast_spsd_wang"].entries_observed == N * c + s * s
    assert res["nystrom"].entries_observed == N * c
    assert res["optimal_core"].entries_observed == N * N
    for r in res.values():
        assert bool(torch.isfinite(r.X).all())
        idx = r.col_idx.tolist()
        assert len(set(idx)) == c and max(idx) < N
    a, b = tspsd.leverage_sampling_sketches(g, res["faster_spsd"].C, s)
    assert a.s == b.s == s and not torch.equal(a.idx, b.idx)


def test_rank_deficient_kernel_duplicated_points():
    """The configuration of the reference's failing
    ``test_rank_deficient_kernel_duplicated_points`` (51 identical points,
    so C is exactly rank-deficient), on the reference's indices and
    sketches: the port is held to what the reference returns, not to that
    test's assertion. Every X is finite. Nyström, the optimal core and
    Algorithm 2 give the reference's ``spsd_error_ratio`` within 1e-3 (X
    itself is not compared: the floored solves amplify the last bits of the
    two QR routines). ``fast_spsd_wang`` samples 6 copies of the duplicated
    column, whose floored pivots divide rounding noise: the reference's X
    reaches ~3e8 and its error ratio exceeds 1 (the assertion it fails);
    the port's does the same, at another value of that noise."""
    n, d = 300, 16
    X = clustered_points(jax.random.key(40), n, d, n_clusters=8, spread=0.5)
    X = X.at[50:100].set(X[0])
    sigma = tune_rbf_sigma(X, k=10, target_eta=0.75)
    joracle = jspsd.rbf_kernel_oracle(X, sigma)
    K = np.array(joracle(None, None))
    oracle = tspsd.rbf_kernel_oracle(torch.from_numpy(np.array(X)), sigma)
    c, s = 24, 120
    for method, s_ in (("nystrom", None), ("optimal_core", None), ("fast_spsd_wang", s),
                       ("faster_spsd", s)):
        res_j, kw = _reference_batch(method, jax.random.key(41), joracle, n, c, s_)
        res = getattr(tspsd, method)(None, oracle, n, c, *([s_] if s_ else []), **kw)
        assert bool(torch.isfinite(res.X).all()), method
        want = float(jspsd.spsd_error_ratio(jnp.asarray(K), res_j))
        got = float(tspsd.spsd_error_ratio(torch.from_numpy(K), res))
        assert np.isfinite(got), method
        if method == "fast_spsd_wang":
            assert want > 1.0 and got > 1.0, (got, want)
            assert float(res.X.abs().max()) > 1e6 and float(jnp.abs(res_j.X).max()) > 1e6
        else:
            assert abs(got - want) < 1e-3, (method, got, want)


# ---------------------------------------------------------------------------
# streaming SPSD, fixed and adaptive
# ---------------------------------------------------------------------------


def _check_stream(jst, jres, states, res):
    np.testing.assert_array_equal(states["chunk"].ctx.col_idx.numpy(), np.asarray(jst.ctx.col_idx))
    assert torch.equal(states["chunk"].C, states["per-panel"].C)
    assert _rel(states["chunk"].M, states["per-panel"].M) < 1e-6
    for st in states.values():
        np.testing.assert_array_equal(st.C.numpy(), np.asarray(jst.C))
        assert _rel(st.M, jst.M) < 1e-5
    assert _rel(res.X, jres.X) < 1e-4
    assert res.entries_observed == jres.entries_observed == N * N


@pytest.mark.parametrize("sketch,panel", [("countsketch", 60), ("countsketch", 64),
                                          ("gaussian", 64)])
def test_streaming_spsd_matches_reference(K, sketch, panel):
    ci = np.asarray(jax.random.choice(jax.random.key(4), N, (20,), replace=False)).astype(np.int32)
    jst = jspsd.streaming_spsd_init(jax.random.key(7), N, jnp.asarray(ci), s=120, sketch=sketch,
                                    panel=panel)
    sketches = (_port(jst.ctx.S1), _port(jst.ctx.S2))
    jst = j_stream(jst, jnp.asarray(K), panel)
    jres = jspsd.streaming_spsd_finalize(jst)
    states = {route: stream_panels(tspsd.streaming_spsd_init(None, N, ci, sketches=sketches,
                                                             panel=panel, device="cpu"),
                                   torch.from_numpy(K), panel, route=route)
              for route in ("chunk", "per-panel")}
    _check_stream(jst, jres, states, tspsd.streaming_spsd_finalize(states["chunk"]))


def test_streaming_matches_batch_faster_spsd(K):
    """The reference's acceptance contract, in the port: on the same columns
    and the same leverage sampling pair (the reference's), the streamed X
    equals batch ``faster_spsd``'s within 1e-4 of its largest entry, ragged
    tail included, and both equal the reference's."""
    idx = jax.random.choice(jax.random.key(4), N, (20,), replace=False).astype(jnp.int32)
    pair = jspsd.leverage_sampling_sketches(jax.random.key(5), jnp.take(K, idx, axis=1), 120)
    want = jspsd.faster_spsd(jax.random.key(6), jspsd.matrix_oracle(jnp.asarray(K)), N, 20, 120,
                             col_idx=idx, sketches=pair)
    sketches = convert.sketch_pair(pair, "cpu")
    Kt = torch.from_numpy(K)
    res_b = tspsd.faster_spsd(None, tspsd.matrix_oracle(Kt), N, 20, 120,
                              col_idx=convert.indices(idx, "cpu"), sketches=sketches)
    assert _rel(res_b.X, want.X) < 1e-4
    scale = float(res_b.X.abs().max())
    for panel in (60, 64):
        st = tspsd.streaming_spsd_init(None, N, convert.indices(idx, "cpu"), sketches=sketches,
                                       panel=panel, device="cpu")
        res_s = tspsd.streaming_spsd_finalize(stream_panels(st, Kt, panel))
        assert torch.equal(res_s.C, res_b.C)
        assert float((res_s.X - res_b.X).abs().max()) <= 1e-4 * scale
        assert abs(float(tspsd.spsd_error_ratio(Kt, res_s))
                   - float(tspsd.spsd_error_ratio(Kt, res_b))) < 1e-4


ADAPTIVE_CASES = {
    "countsketch-route-a": dict(c=8, kw=dict(sketch="countsketch", panel_cap=2)),
    "gaussian-route-b": dict(c=8, kw=dict(sketch="gaussian", panel_cap=2), force=True),
    # two slots for four planted columns: the last one evicts a weaker slot
    "eviction": dict(c=2, kw=dict(sketch="countsketch", panel_cap=1, swap_gain=1.1)),
}


@pytest.mark.parametrize("case", list(ADAPTIVE_CASES))
def test_adaptive_spsd_matches_reference(K, case, monkeypatch):
    """Route A (CountSketch), Route B forced on both sides (the reference's
    ``panel_update`` in interpret mode against the port's plain kernel 3,
    which every panel must go through, M of s × s) and eviction (the
    per-panel body)."""
    cfg = ADAPTIVE_CASES[case]
    kw, c = cfg["kw"], cfg["c"]
    jst = jspsd.adaptive_spsd_init(jax.random.key(11), N, c, s=96, panel=40, **kw)
    sketches = (_port(jst.ctx.S_C), _port(jst.ctx.S_R))
    force = cfg.get("force", False)
    calls = []
    kernel_3 = tops.panel_update
    monkeypatch.setattr(tops, "panel_update", lambda *a, **k: calls.append(a) or kernel_3(*a, **k))
    jops._FORCE_KERNEL_ROUTE = force
    tops._FORCE_KERNEL_ROUTE = force
    try:
        jst = j_stream(jst, jnp.asarray(K), 40)
        states = {route: stream_panels(tspsd.adaptive_spsd_init(None, N, c, panel=40,
                                                                sketches=sketches, device="cpu",
                                                                **kw),
                                       torch.from_numpy(K), 40, route=route)
                  for route in ("chunk", "per-panel")}
    finally:
        jops._FORCE_KERNEL_ROUTE = False
        tops._FORCE_KERNEL_ROUTE = False
    jres = jspsd.adaptive_spsd_finalize(jst)
    res = tspsd.adaptive_spsd_finalize(states["chunk"])
    _check_stream(jst, jres, states, res)
    for st in states.values():
        assert _rel(st.ctx.ScC, jst.ctx.ScC) < 1e-5
        assert int(st.ctx.n_evicted) == int(jst.ctx.n_evicted)
        assert st.R.shape == (0, N)
    if c == 8:
        assert set(_SPIKES) <= set(res.col_idx.tolist())
    assert len(calls) == (12 if force else 0)  # 6 panels, both routes
    if force:
        assert calls[0][5].shape == (96, 96)  # M is s × s
    if "swap_gain" in kw:
        assert int(jst.ctx.n_evicted) > 0


def test_adaptive_spsd_unfilled_slots_are_inert():
    """The reference's inertness case on its sketches: unfilled slots have
    col_idx −1, zero C columns and zero X rows and columns; X is PSD and
    equal to the reference's within 1e-4."""
    B = 0.01 * jax.random.normal(jax.random.key(14), (N, 32))
    K = B @ B.T + 1e-4 * jnp.eye(N)
    v = jnp.zeros((N,)).at[13].set(1.0)
    K = np.array(K + 9.0 * jnp.outer(v, v))
    kw = dict(s=64, panel=40, panel_cap=1, min_gain=5.0)
    jst = jspsd.adaptive_spsd_init(jax.random.key(15), N, 6, **kw)
    sketches = (_port(jst.ctx.S_C), _port(jst.ctx.S_R))
    jres = jspsd.adaptive_spsd_finalize(j_stream(jst, jnp.asarray(K), 40))
    st = tspsd.adaptive_spsd_init(None, N, 6, sketches=sketches, device="cpu",
                                  **{k: v for k, v in kw.items() if k != "s"})
    res = tspsd.adaptive_spsd_finalize(stream_panels(st, torch.from_numpy(K), 40))
    idx = res.col_idx.numpy()
    np.testing.assert_array_equal(idx, np.asarray(jres.col_idx))
    assert (idx == -1).any() and 13 in idx.tolist()
    unfilled = torch.from_numpy(idx == -1)
    assert bool(torch.isfinite(res.X).all())
    assert not res.X[unfilled].any() and not res.X[:, unfilled].any()
    assert not res.C[:, unfilled].any()
    assert _rel(res.X, jres.X) < 1e-4
    ev = torch.linalg.eigvalsh(0.5 * (res.X + res.X.T).double())
    assert float(ev.min()) > -1e-5 * float(ev.max())


def test_streaming_init_validation():
    with pytest.raises(ValueError, match="col_idx entries"):
        tspsd.streaming_spsd_init(torch.Generator(), N, [0, N], panel=40, device="cpu")
    with pytest.raises(ValueError, match="col_idx entries"):
        tspsd.streaming_spsd_init(torch.Generator(), N, [-1, 5], panel=40, device="cpu")
    with pytest.raises(ValueError, match="0 < c <= n"):
        tspsd.adaptive_spsd_init(torch.Generator(), N, 0, panel=40, device="cpu")
    with pytest.raises(ValueError, match="0 < c <= n"):
        tspsd.adaptive_spsd_init(torch.Generator(), N, N + 1, panel=40, device="cpu")
    with pytest.raises(ValueError, match="s > 0"):
        tspsd.adaptive_spsd_init(torch.Generator(), N, 8, s=-3, panel=40, device="cpu")
    with pytest.raises(NotImplementedError):
        tspsd.streaming_spsd_init(torch.Generator(), N, [1], telemetry=True, device="cpu")
    with pytest.raises(NotImplementedError):
        tspsd.adaptive_spsd_init(torch.Generator(), N, 4, telemetry=True, device="cpu")
    with pytest.raises(NotImplementedError):  # SRHT has no column windows
        tspsd.streaming_spsd_init(torch.Generator(), 64, [1], s=16, sketch="srht", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tspsd.streaming_spsd_init(torch.Generator(), N, [1])


def test_port_streams_on_its_own_draws(K):
    """The port's own draws: the adaptive stream finds the planted columns
    and beats the fixed uniform stream at equal budget (the reference's
    claim), both cores PSD."""
    Kt = torch.from_numpy(K)
    g = torch.Generator().manual_seed(11)
    st = tspsd.adaptive_spsd_init(g, N, 8, s=96, panel=40, panel_cap=2, device="cpu")
    res_a = tspsd.adaptive_spsd_finalize(stream_panels(st, Kt, 40))
    assert set(_SPIKES) <= set(res_a.col_idx.tolist())
    ci = torch.randperm(N, generator=g)[:8]
    st = tspsd.streaming_spsd_init(g, N, ci, s=96, panel=40, device="cpu")
    res_u = tspsd.streaming_spsd_finalize(stream_panels(st, Kt, 40))
    assert float(tspsd.spsd_error_ratio(Kt, res_a)) < float(tspsd.spsd_error_ratio(Kt, res_u))


# ---------------------------------------------------------------------------
# symmetric CUR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", SELECTION_POLICIES)
def test_symmetric_cur_matches_reference(K, policy):
    """The reference's selection and core sketches (redrawn from its keys)
    handed across: X within 1e-4, the entry count, and the CUR adapter."""
    key, c = jax.random.key(18), 12
    want = j_symmetric_cur(key, jnp.asarray(K), c, policy=policy)
    _, k_core = jax.random.split(key)
    _, k1, k2 = jax.random.split(k_core, 3)
    s = min(10 * c, N)
    sketches = convert.sketch_pair(j_leverage_pair(k1, k2, want.C, s), "cpu")
    Kt = torch.from_numpy(K)
    res = symmetric_cur(None, Kt, policy=policy, col_idx=convert.indices(want.col_idx, "cpu"),
                        sketches=sketches)
    np.testing.assert_array_equal(res.C.numpy(), np.asarray(want.C))
    assert _rel(res.X, want.X) < 1e-4
    assert res.entries_observed == want.entries_observed == N * c + s * s
    err = float(tspsd.spsd_error_ratio(Kt, res))
    cur = spsd_to_cur(res)
    assert torch.equal(cur.R, res.C.T) and torch.equal(cur.row_idx, cur.col_idx)
    assert abs(float(cur_relative_error(Kt, cur)) - err) < 1e-5
    if policy == "pivoted_qr":  # deterministic: the port selects what the reference does
        own = symmetric_cur(None, Kt, c, policy=policy, sketches=sketches)
        np.testing.assert_array_equal(own.col_idx.numpy(), np.asarray(want.col_idx))


def test_symmetric_cur_exact_core_and_validation(K):
    key = jax.random.key(19)
    want = j_symmetric_cur(key, jnp.asarray(K), 12, policy="leverage", method="exact")
    Kt = torch.from_numpy(K)
    res = symmetric_cur(None, Kt, col_idx=convert.indices(want.col_idx, "cpu"), method="exact")
    assert res.entries_observed == N * N
    assert _rel(res.X, want.X) < 1e-4
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="square"):
        symmetric_cur(g, Kt[:, :100], 8)
    with pytest.raises(ValueError, match="col_idx"):
        symmetric_cur(g, Kt)
    with pytest.raises(ValueError, match="unknown method"):
        symmetric_cur(g, Kt, 8, method="bogus")
    res = symmetric_cur(g, Kt, 12, policy="leverage")  # the port's own draws
    assert float(tspsd.spsd_error_ratio(Kt, res)) < 0.15
