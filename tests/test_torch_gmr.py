"""Algorithm 1 (Fast GMR), ρ, the §6.1 norm estimator and the shared-budget
allocator: the port against the JAX reference.

Matrices and sketches are drawn by the reference (the same key splits its
``fast_gmr`` and ``sketched_fro_norm`` make) and handed to the port through
numpy. The port's X̃ must be within 1e-4 of the reference's, relative to
its norm (the same fp32 terms, other LAPACK QR routines behind the solves),
and the scalar metrics within 1e-4 relative; the reference's own claims
(Theorem 1's small error ratio, shrinking with the sketch size, ρ positive,
the norm estimate within 15 %) must hold for the port's outputs too.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import error_ratio as j_error_ratio  # noqa: E402
from repro.core import fast_gmr as j_fast_gmr  # noqa: E402
from repro.core import fast_gmr_core as j_fast_gmr_core  # noqa: E402
from repro.core import rho as j_rho  # noqa: E402
from repro.core import sketched_fro_norm as j_sketched_fro_norm  # noqa: E402
from repro.core.sketching import draw_sketch as j_draw  # noqa: E402
from repro.stream.adaptive import allocate_shared_budget as j_allocate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (error_ratio, fast_gmr, fast_gmr_core, rho,  # noqa: E402
                              sketched_fro_norm)
from repro_torch.stream import allocate_shared_budget  # noqa: E402


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@functools.partial(jax.jit, static_argnames=("m", "n", "c", "r"))
def _problem(key, m=300, n=250, c=12, r=12, decay=1.0):
    """The reference test's problem: a decaying spectrum, C = A·G_C, R = G_R·A."""
    ks = jax.random.split(key, 3)
    rank = min(m, n)
    U, _ = jnp.linalg.qr(jax.random.normal(ks[0], (m, rank)))
    V, _ = jnp.linalg.qr(jax.random.normal(ks[1], (n, rank)))
    sv = jnp.arange(1, rank + 1, dtype=jnp.float32) ** -decay
    A = (U * sv[None]) @ V.T
    GC = jax.random.normal(jax.random.fold_in(key, 5), (n, c))
    GR = jax.random.normal(jax.random.fold_in(key, 6), (r, m))
    return A, A @ GC, GR @ A


# the reference jitted: eagerly it compiles op by op, seconds per call
_j_fast_gmr = jax.jit(j_fast_gmr, static_argnums=(4, 5), static_argnames=("sketch_c",))
_j_error_ratio = jax.jit(j_error_ratio)


def _t(x):
    return convert.to_tensor(np.asarray(x), "cpu")


def _port(S):
    return convert.sketch_from_arrays(*convert.sketch_arrays(S), device="cpu")


def _fast_gmr_pair(key, A, C, R, s_c, s_r, sketch):
    """The reference's ``fast_gmr`` and the port's on the reference's draws
    (its key split, in its order)."""
    m, n = A.shape
    k_c, k_r = jax.random.split(key)
    S_C = j_draw(k_c, sketch, s_c, m, dtype=A.dtype)
    S_R = j_draw(k_r, sketch, s_r, n, dtype=A.dtype)
    X_ref = _j_fast_gmr(key, A, C, R, s_c, s_r, sketch_c=sketch)
    X = fast_gmr(None, _t(A), _t(C), _t(R), s_c, s_r, sketches=(_port(S_C), _port(S_R)))
    return X_ref, X


@pytest.mark.parametrize(
    "sketch",
    ["gaussian", "countsketch", "osnap", pytest.param("srht", marks=pytest.mark.slow)],
)
def test_fast_gmr_relative_error(sketch):
    """Theorem 1 at s = 120 (the reference's case): X̃ equal to the
    reference's, and its error ratio small (mean of 3 draws below 0.35)."""
    A, C, R = _problem(jax.random.key(2))
    At, Ct, Rt = _t(A), _t(C), _t(R)
    errs = []
    for t in range(3):
        X_ref, X = _fast_gmr_pair(jax.random.key(50 + t), A, C, R, 120, 120, sketch)
        assert _rel(X, X_ref) < 1e-4, (sketch, t)
        e, e_ref = float(error_ratio(At, Ct, X, Rt)), float(_j_error_ratio(A, C, X_ref, R))
        assert abs(e - e_ref) <= 1e-4 * max(1.0, abs(e_ref)), (sketch, e, e_ref)
        errs.append(e)
    assert np.mean(errs) < 0.35, (sketch, errs)


def test_error_decreases_with_sketch_size():
    A, C, R = _problem(jax.random.key(3))
    At, Ct, Rt = _t(A), _t(C), _t(R)
    means = []
    for s in (24, 72, 144):
        errs = []
        for t in range(4):
            X_ref, X = _fast_gmr_pair(jax.random.key(70 + t), A, C, R, s, s, "gaussian")
            assert _rel(X, X_ref) < 1e-4, (s, t)
            errs.append(float(error_ratio(At, Ct, X, Rt)))
        means.append(np.mean(errs))
    assert means[2] < means[0], means


@pytest.mark.parametrize("seed,decay", [(0, 0.3), (12345, 0.9), (2**30, 1.5)])
def test_error_ratio_nonnegative(seed, decay):
    """error_ratio ≥ −ε for any sketched solution (X* is the minimiser), and
    the port's ratio equals the reference's on the same X̃."""
    A, C, R = _problem(jax.random.key(seed), m=120, n=100, c=6, r=6, decay=decay)
    X_ref, X = _fast_gmr_pair(jax.random.fold_in(jax.random.key(seed), 1), A, C, R, 40, 40,
                              "gaussian")
    e = float(error_ratio(_t(A), _t(C), X, _t(R)))
    e_ref = float(_j_error_ratio(A, C, X_ref, R))
    assert e > -1e-3
    assert abs(e - e_ref) <= 1e-3 * max(1.0, abs(e_ref)), (e, e_ref)


def test_rho_positive_and_finite():
    A, C, R = _problem(jax.random.key(4))
    val, want = float(rho(_t(A), _t(C), _t(R))), float(j_rho(A, C, R))
    assert 0 < val < 100
    assert abs(val - want) <= 1e-4 * want, (val, want)


def test_fast_gmr_core_matches_full():
    """The core solve from pre-sketched pieces equals ``fast_gmr`` on the
    same sketches, and the reference's core on them."""
    A, C, R = _problem(jax.random.key(6))
    k1, k2 = jax.random.split(jax.random.key(7))
    S_C = j_draw(k1, "gaussian", 100, A.shape[0])
    S_R = j_draw(k2, "gaussian", 100, A.shape[1])
    X_ref = j_fast_gmr_core(S_C.apply(C), S_R.apply_t(S_C.apply(A)), S_R.apply_t(R))
    P_C, P_R = _port(S_C), _port(S_R)
    At, Ct, Rt = _t(A), _t(C), _t(R)
    X1 = fast_gmr_core(P_C.apply(Ct), P_R.apply_t(P_C.apply(At)), P_R.apply_t(Rt))
    X2 = fast_gmr(None, At, Ct, Rt, 100, 100, sketches=(P_C, P_R))
    assert torch.equal(X1, X2)
    assert _rel(X1, X_ref) < 1e-4
    assert float(error_ratio(At, Ct, X1, Rt)) < 0.5


def test_sketched_fro_norm():
    A = jax.random.normal(jax.random.key(8), (400, 300))
    k1, k2 = jax.random.split(jax.random.key(9))
    S1 = j_draw(k1, "countsketch", 2000, 400, dtype=A.dtype)
    S2 = j_draw(k2, "countsketch", 2000, 300, dtype=A.dtype)
    want = float(j_sketched_fro_norm(jax.random.key(9), A, 2000, 2000))
    est = float(sketched_fro_norm(None, _t(A), 2000, 2000, sketches=(_port(S1), _port(S2))))
    true = float(jnp.linalg.norm(A))
    assert abs(est - want) <= 1e-5 * want, (est, want)
    assert abs(est - true) / true < 0.15


def test_port_draws_run_end_to_end():
    """The port's own draws: ``fast_gmr`` and ``sketched_fro_norm`` from a
    generator, and the generator or the pair must be given."""
    A, C, R = (_t(x) for x in _problem(jax.random.key(11), m=120, n=100, c=6, r=6))
    g = torch.Generator().manual_seed(0)
    for kind in ("gaussian", "countsketch", "osnap"):
        X = fast_gmr(g, A, C, R, 48, 48, sketch_c=kind)
        assert X.shape == (6, 6) and bool(torch.isfinite(X).all())
        assert float(error_ratio(A, C, X, R)) > -1e-3
    est = float(sketched_fro_norm(g, A, 100, 100))
    assert abs(est - float(torch.linalg.norm(A))) / float(torch.linalg.norm(A)) < 0.5
    with pytest.raises(ValueError):
        fast_gmr(None, A, C, R, 48, 48)
    with pytest.raises(ValueError):
        sketched_fro_norm(None, A, 100, 100)


BUDGET_CASES = {
    # (scores, budget, floor, cap): ties at equal gains across groups and
    # within one, dead (non-positive) marginals, a floor and a cap
    "ties": (np.array([[4.0, 2.0, 2.0, 1.0], [4.0, 2.0, 1.0, 0.5], [2.0, 2.0, 2.0, 2.0]]), 6, 0,
             None),
    "floor_cap": (np.array([[9.0, 5.0, 3.0, 3.0], [3.0, 3.0, 3.0, 1.0], [8.0, 0.0, 0.0, 0.0]]), 7, 1,
                  3),
    "dead_tail": (np.array([[1.0, 0.0, -1.0], [0.5, 0.5, 0.0]]), 6, 0, None),
    "all_tied": (np.ones((4, 5)), 7, 0, None),
    "floor_only": (np.ones((3, 2)), 3, 1, None),
}


@pytest.mark.parametrize("case", list(BUDGET_CASES))
def test_allocate_shared_budget_matches_reference(case):
    """Equal to the reference's allocation, ties to the lower flat index as
    ``jax.lax.top_k`` gives them."""
    scores, budget, floor, cap = BUDGET_CASES[case]
    want = np.asarray(j_allocate(jnp.asarray(scores, jnp.float32), budget, floor=floor, cap=cap))
    got = allocate_shared_budget(torch.tensor(scores, dtype=torch.float32), budget, floor=floor,
                                 cap=cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_allocate_shared_budget_tie_order_and_errors():
    """Among tied marginals the lower group wins; the reference's errors."""
    got = allocate_shared_budget(torch.full((3, 2), 5.0), 2)
    assert got.tolist() == [2, 0, 0]  # flat indices 0 and 1 both belong to group 0
    got = allocate_shared_budget(torch.full((3, 2), 5.0), 4, cap=1)
    assert got.tolist() == [1, 1, 1]
    for kw in (dict(budget=2, floor=1), dict(budget=9, floor=-1), dict(budget=9, floor=3, cap=2)):
        budget = kw.pop("budget")
        with pytest.raises(ValueError):
            j_allocate(jnp.ones((3, 4)), budget, **kw)
        with pytest.raises(ValueError):
            allocate_shared_budget(torch.ones((3, 4)), budget, **kw)


def test_packages_export_the_reference_names():
    """The names whose absence was fault F2 (and F1's), exported by the
    port's packages as by the reference's; ``repro_torch.obs`` exports the
    reference's ``__all__``."""
    import importlib

    import repro.obs

    for pkg, names in (("core", ("fast_gmr", "rho", "sketched_fro_norm")),
                       ("stream", ("AdaptiveRowState", "allocate_shared_budget")),
                       ("cur", ("StreamingCURState", "adaptive_cur_init", "adaptive_cur_finalize"))):
        ref, port = (importlib.import_module(f"{root}.{pkg}") for root in ("repro", "repro_torch"))
        for name in names:
            assert name in ref.__all__ and name in port.__all__, (pkg, name)
            assert callable(getattr(port, name)), (pkg, name)
    port_obs = importlib.import_module("repro_torch.obs")
    assert sorted(port_obs.__all__) == sorted(repro.obs.__all__)
