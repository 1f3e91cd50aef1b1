"""Leverage scores and the selection policies of the port against the JAX reference.

The reference's sketches (its CountSketch and JL Gaussian, drawn from the
same keys it draws them from) are handed to the port through numpy, so both
sides compute from the same randomness. Tolerances, of the largest entry:
1e-4 for leverage scores (QR and triangular solves from two LAPACKs, fp32),
1e-5 for the selection distributions (sums to 1, entries ~1/n; the two
SVDs agree to fp32 rounding on a matrix with a spectral gap at k). Weighted
draws without replacement are ``torch.multinomial`` in the port and Gumbel
top-k in the reference: the same distribution, not the same bits, so the
draws are checked for validity, and ``pivoted_qr`` (deterministic) for
exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import leverage as jlev  # noqa: E402
from repro.core.sketching import CountSketch as JCountSketch  # noqa: E402
from repro.core.sketching import draw_sketch as jdraw  # noqa: E402
from repro.cur import selection as jsel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.leverage import approx_leverage_scores, leverage_scores  # noqa: E402
from repro_torch.cur.selection import select_columns, select_rows  # noqa: E402


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.max(np.abs(want))))


def _sketch(S):
    return convert.sketch_from_arrays(*convert.sketch_arrays(S), "cpu")


def _spiked(seed, m, n, k, gap=20.0):
    """``U diag(σ) Vᵀ`` with σ = gap on the first k directions, decaying
    after: a clear spectral gap at k."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, min(m, n))))
    V, _ = np.linalg.qr(rng.standard_normal((n, min(m, n))))
    sv = np.where(np.arange(min(m, n)) < k, gap, 1.0 / (1.0 + np.arange(min(m, n))))
    return ((U * sv) @ V.T).astype(np.float32)


def test_leverage_scores_match_reference():
    A = np.random.default_rng(1).standard_normal((90, 12)).astype(np.float32)
    got = leverage_scores(torch.from_numpy(A))
    _close(got, jlev.leverage_scores(jnp.asarray(A)), 1e-4)
    assert abs(float(got.sum()) - 12.0) < 1e-3  # Σℓ = rank


def test_approx_leverage_scores_match_reference_on_its_sketches():
    m, n = 120, 10
    A = np.random.default_rng(2).standard_normal((m, n)).astype(np.float32)
    key = jax.random.key(3)
    want = jlev.approx_leverage_scores(key, jnp.asarray(A))
    # the reference's own draws: split(key) → CountSketch (s = 4n) and the JL Gaussian
    k1, k2 = jax.random.split(key)
    S = jdraw(k1, "countsketch", min(m, max(4 * n, n + 8)), m)
    jl = max(8, int(np.ceil(np.log2(m))) * 2)
    G = jax.random.normal(k2, (n, jl), jnp.float32) / jnp.sqrt(jl)
    got = approx_leverage_scores(None, torch.from_numpy(A), sketch=_sketch(S),
                                 jl=convert.to_tensor(np.asarray(G), "cpu"))
    _close(got, want, 1e-4)
    own = approx_leverage_scores(torch.Generator().manual_seed(4), torch.from_numpy(A))
    assert own.shape == (m,) and bool(torch.isfinite(own).all())


@pytest.mark.parametrize("policy", ["leverage", "approx_leverage"])
def test_leverage_policies_probs_match_reference(policy):
    m, n, c, k = 60, 80, 8, 5
    A = _spiked(5, m, n, k)
    key = jax.random.key(6)
    want = jsel.select_columns(key, jnp.asarray(A), c, policy, k=k)
    sketch = None
    if policy == "approx_leverage":  # the reference's CountSketch: split(key)[1]
        sketch = _sketch(JCountSketch.draw(jax.random.split(key)[1], max(4 * k, k + 8), m))
    got = select_columns(torch.Generator().manual_seed(7), torch.from_numpy(A), c, policy,
                         k=k, sketch=sketch)
    _close(got.probs, want.probs, 1e-5)
    idx = got.idx.numpy()
    assert got.idx.dtype == torch.int32 and len(set(idx.tolist())) == c
    assert idx.min() >= 0 and idx.max() < n
    rows = select_rows(torch.Generator().manual_seed(8), torch.from_numpy(A), c, policy, k=k)
    assert rows.probs.shape == (m,) and int(rows.idx.max()) < m


def test_pivoted_qr_indices_equal_reference():
    rng = np.random.default_rng(9)
    A = (rng.standard_normal((50, 40)) * np.linspace(3.0, 0.5, 40)).astype(np.float32)
    want = jsel.select_columns(jax.random.key(0), jnp.asarray(A), 12, "pivoted_qr")
    got = select_columns(None, torch.from_numpy(A), 12, "pivoted_qr")
    assert got.probs is None
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    want_r = jsel.select_rows(jax.random.key(0), jnp.asarray(A), 10, "pivoted_qr")
    np.testing.assert_array_equal(select_rows(None, torch.from_numpy(A), 10, "pivoted_qr").idx.numpy(),
                                  np.asarray(want_r.idx))


def test_weighted_draws_are_distinct_and_skip_zero_probability_columns():
    g = torch.Generator().manual_seed(10)
    A = torch.zeros((4, 30))
    probs = torch.rand(30, generator=g)
    probs[::3] = 0.0  # 10 columns can never be drawn while others remain
    for _ in range(20):
        idx = select_columns(g, A, 20, probs=probs).idx
        assert len(set(idx.tolist())) == 20 and int(idx.min()) >= 0 and int(idx.max()) < 30
        assert bool((probs[idx.long()] > 0).all())
    # fewer positive weights than draws: all of them first, then zero-weight columns
    idx = select_columns(g, A, 25, probs=probs).idx
    assert len(set(idx.tolist())) == 25
    assert bool((probs[idx[:20].long()] > 0).all()) and bool((probs[idx[20:].long()] == 0).all())
    with pytest.raises(ValueError):
        select_columns(g, A, 5, "no_such_policy")
