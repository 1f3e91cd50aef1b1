"""Single-pass SVD (Algorithm 3) and its baseline (Algorithm 4): the port
against the JAX reference on the reference's sketches.

Tolerances (relative Frobenius): the accumulators C, R and M within 1e-5
(the same fp32 terms, summed in other orders); Σ and the unique product
``U diag(Σ) Vᵀ`` within 1e-4 (other LAPACK QR/SVD routines behind the
finalize). U and V are never compared column by column: their columns'
signs are not unique. Within the port, the chunk and per-panel routes give
the same bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import svd as jsvd  # noqa: E402
from repro.core.sketching import draw_sketch as j_draw  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.stream.engine import stream_panels as j_stream  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import svd as tsvd  # noqa: E402
from repro_torch.core.sketching import index_windows  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.stream.engine import stream_panels  # noqa: E402

M_ROWS, N_COLS = 300, 250
SIZES = dict(c=30, r=30, c0=90, r0=90, s_c=90, s_r=90)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _product(U, S, V):
    U, S, V = (np.asarray(x, np.float64) for x in (U, S, V))
    return (U * S[None, :]) @ V.T


@pytest.fixture(scope="module")
def A():
    A = jdata.powerlaw_matrix(jax.random.key(0), M_ROWS, N_COLS, 1.0)
    noise = 1e-3 * np.random.default_rng(0).standard_normal(A.shape)
    return (np.asarray(A) + noise).astype(np.float32)


def _reference_stream(A, panel, key=1, sizes=SIZES):
    """The reference's streamed state and its factors, and the port's copy
    of its sketches."""
    m, n = A.shape
    jst = jsvd.sp_svd_init(jax.random.key(key), m, n, sizes=sizes, panel=panel)
    sketches = convert.spsvd_sketches(jst.ctx, "cpu")
    jst = j_stream(jst, jnp.asarray(A), panel)
    return jst, jsvd.sp_svd_finalize(jst), sketches


@pytest.mark.parametrize("panel", [50, 64])  # 250 = 5·50, and 3·64 + a 58-column tail
def test_sp_svd_matches_reference(A, panel):
    jst, (jU, jS, jV), sketches = _reference_stream(A, panel)
    states = {}
    for route in ("chunk", "per-panel"):
        st = tsvd.sp_svd_init(None, M_ROWS, N_COLS, sizes=SIZES, panel=panel, sketches=sketches,
                              device="cpu")
        states[route] = stream_panels(st, torch.from_numpy(A), panel, route=route)
    for x, y in zip((states["chunk"].C, states["chunk"].R, states["chunk"].M),
                    (states["per-panel"].C, states["per-panel"].R, states["per-panel"].M)):
        assert torch.equal(x, y)
    st = states["chunk"]
    assert st.R.shape == (SIZES["r"], -(-N_COLS // panel) * panel)
    for got, want in ((st.C, jst.C), (st.R, jst.R), (st.M, jst.M)):
        assert _rel(got, want) < 1e-5
    U, S, V = tsvd.sp_svd_finalize(st)
    assert _rel(S, jS) < 1e-4
    assert _rel(_product(U, S, V), _product(jU, jS, jV)) < 1e-4
    eye = np.eye(U.shape[1])
    np.testing.assert_allclose((U.T @ U).numpy(), eye, atol=1e-4)
    np.testing.assert_allclose((V.T @ V).numpy(), eye, atol=1e-4)
    assert bool(torch.all(S[:-1] >= S[1:]))


def test_fast_sp_svd_fixed_rank_and_routes_match_reference(A):
    """One-shot ``fast_sp_svd`` on the reference's sketches, truncated to
    rank 10: shapes, Σ and the product as above; the routes give the same
    bits."""
    key = jax.random.key(3)
    jU, jS, jV = jsvd.fast_sp_svd(key, jnp.asarray(A), sizes=SIZES, panel=64, fixed_rank=10)
    sketches = convert.spsvd_sketches(
        jsvd.sp_svd_init(key, M_ROWS, N_COLS, sizes=SIZES, panel=64).ctx, "cpu")
    outs = [tsvd.fast_sp_svd(None, torch.from_numpy(A), sizes=SIZES, panel=64, fixed_rank=10,
                             route=route, sketches=sketches) for route in ("chunk", "per-panel")]
    U, S, V = outs[0]
    assert U.shape == (M_ROWS, 10) and S.shape == (10,) and V.shape == (N_COLS, 10)
    assert all(torch.equal(x, y) for x, y in zip(*outs))
    assert _rel(S, jS) < 1e-4
    assert _rel(_product(U, S, V), _product(jU, jS, jV)) < 1e-4


def test_panel_size_invariance(A):
    """Unpadded sketches, two panel widths: the port's factors agree with
    each other and with the reference's at either width."""
    m, n = A.shape
    jst = jsvd.sp_svd_init(jax.random.key(2), m, n, sizes=SIZES)
    sketches = convert.spsvd_sketches(jst.ctx, "cpu")
    ref = jsvd.sp_svd_finalize(j_stream(jst, jnp.asarray(A), 50))  # 250 = 5·50: no padding
    prods = []
    for panel in (64, 200):
        out = tsvd.fast_sp_svd(None, torch.from_numpy(A), sizes=SIZES, panel=panel,
                               sketches=sketches)
        prods.append(_product(*out))
        assert _rel(prods[-1], _product(*ref)) < 1e-4
    assert _rel(prods[0], prods[1]) < 1e-4


def test_practical_sp_svd_matches_reference(A):
    """Algorithm 4 on the reference's Ψ̃ and Ω̃ (drawn as it draws them)."""
    key = jax.random.key(4)
    jU, jS, jV = jsvd.practical_sp_svd(key, jnp.asarray(A), c=30, r=30, fixed_rank=20)
    k_psi, k_om = jax.random.split(key)
    sketches = convert.sketch_pair((j_draw(k_psi, "gaussian", 30, M_ROWS),
                                    j_draw(k_om, "gaussian", 30, N_COLS)), "cpu")
    U, S, V = tsvd.practical_sp_svd(None, torch.from_numpy(A), c=30, r=30, fixed_rank=20,
                                    sketches=sketches)
    assert U.shape == (M_ROWS, 20) and V.shape == (N_COLS, 20)
    assert _rel(S, jS) < 1e-4
    assert _rel(_product(U, S, V), _product(jU, jS, jV)) < 1e-4


def test_svd_error_ratio_matches_reference(A):
    jU, jS, jV = jsvd.fast_sp_svd(jax.random.key(5), jnp.asarray(A), sizes=SIZES, panel=64)
    want = float(jsvd.svd_error_ratio(jnp.asarray(A), jU, jS, jV, 10))
    got = float(tsvd.svd_error_ratio(torch.from_numpy(A), *(convert.to_tensor(x, "cpu")
                                                             for x in (jU, jS, jV)), 10))
    assert abs(got - want) < 1e-4 * max(1.0, abs(want))


def test_port_draws_run_and_fast_beats_practical(A):
    """The port's own draws (no reference arrays): §6.3's ordering at equal
    budget, averaged over three seeds, and finite factors."""
    At = torch.from_numpy(A)
    fast, prac = [], []
    for t in range(3):
        g = torch.Generator().manual_seed(t)
        out = tsvd.fast_sp_svd(g, At, sizes=SIZES, panel=64)
        assert all(bool(torch.isfinite(x).all()) for x in out)
        fast.append(float(tsvd.svd_error_ratio(At, *out, 10)))
        prac.append(float(tsvd.svd_error_ratio(At, *tsvd.practical_sp_svd(g, At, c=30, r=30), 10)))
    assert np.mean(fast) < np.mean(prac), (fast, prac)
    assert tsvd.sp_svd_sizes(64, 0.5) == dict(c=384, r=384, c0=1292, r0=1292, s_c=544, s_r=544)
    assert tsvd.sp_svd_sizes(64, 0.5) == jsvd.sp_svd_sizes(64, 0.5)
    with pytest.raises(ValueError):
        tsvd.sp_svd_init(g, 10, 10, device="cpu")


def test_omega_windows_take_the_streams_chunk_orders(monkeypatch):
    """Ω's windows are indexed once per stream: after ``index_windows(S, L,
    chunks=True)`` a window on the grid carries the view kernel's chunk
    orders (equal to its own ``window_orders``), so neither it nor any later
    panel sorts; a window off the chunk grid sorts its own."""
    jsk = j_draw(jax.random.key(6), "osnap", 40, 1100)
    S = convert.sketch_from_arrays(*convert.sketch_arrays(jsk), device="cpu").pad_cols(1536)
    index_windows(S, 512, chunks=True)
    sorts = []
    orig = tops.window_orders
    monkeypatch.setattr(tops, "window_orders", lambda *a: sorts.append(a) or orig(*a))
    for off in (0, 512, 1024):
        for part, whole in zip(S.cols(off, 512).parts(), S.parts()):
            perm, start = part.chunk_orders()
            want = orig(whole.hashes[off : off + 512], 40, tops.VIEW_CHUNK)
            assert torch.equal(perm, want[0]) and torch.equal(start, want[1])
            assert part._order  # the panel-wide order too
    assert not sorts
    S.cols(128, 512).parts()[0].chunk_orders()  # off the chunk grid
    assert len(sorts) == 1


def test_sp_svd_stream_indexes_omega_once(A, monkeypatch):
    """The engine indexes Ω (and S_R) per stream: the stream's windows of Ω
    carry the view kernel's chunk orders, built by one sort per part."""
    seen = []
    orig = tsvd.OSNAPSketch.cols

    def cols(self, off, size):
        win = orig(self, off, size)
        seen.append(win)
        return win

    monkeypatch.setattr(tsvd.OSNAPSketch, "cols", cols)
    g = torch.Generator().manual_seed(7)
    sizes = dict(SIZES, c0=96, r0=96)  # Ω's windows told apart from S_R's by their s
    st = tsvd.sp_svd_init(g, M_ROWS, 1024, sizes=sizes, panel=512, device="cpu")
    A2 = torch.from_numpy(np.tile(A, (1, 5))[:, :1024].copy())
    stream_panels(st, A2, 512)
    omega_wins = [w for w in seen if w.s == sizes["c0"]]
    assert len(omega_wins) == 2
    for w in omega_wins:
        for part in w.parts():
            assert tops.VIEW_CHUNK in part._windows


def test_sparse_matrix_matches_reference_profile():
    """The SP-SVD benchmark's sparse dataset: shape, dtype and density as the
    reference's (the values come from another generator)."""
    want = np.asarray(jdata.sparse_matrix(jax.random.key(0), 400, 300, density=0.05))
    got = tdata.sparse_matrix(0, 400, 300, density=0.05, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32 and want.dtype == np.float32
    d_got, d_want = float((got != 0).float().mean()), float((want != 0).mean())
    assert abs(d_got - 0.05) < 0.005 and abs(d_want - 0.05) < 0.005
    assert tdata.sparse_matrix(1, 64, 64, device="cpu", dtype=torch.bfloat16).dtype == torch.bfloat16
    assert torch.equal(got, tdata.sparse_matrix(0, 400, 300, density=0.05, device="cpu"))
