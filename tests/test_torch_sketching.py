"""Port sketches and GMR solves against the JAX reference on shared arrays.

Sketches are drawn by the reference and handed to the port through numpy
(:mod:`repro_torch.convert`); operands are drawn with numpy from a seed.
Tolerances: sketch applies 1e-6 relative (Frobenius) — both sides sum the
same fp32 terms, in possibly different orders; least-squares solves 1e-4
relative — the two packages use different LAPACK QR routines.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import gmr as jgmr  # noqa: E402
from repro.core.sketching import draw_sketch as jdraw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gmr as tgmr  # noqa: E402

KINDS = ["gaussian", "countsketch", "osnap"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def to_port(kind, S):
    """The reference sketch ``S`` as the port's object, on the CPU."""
    if kind == "gaussian":
        arrays = {"mat": np.asarray(S.mat)}
    else:
        arrays = {"hashes": np.asarray(S.hashes), "signs": np.asarray(S.signs), "s": S.s}
    return convert.sketch_from_arrays(kind, arrays, "cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_sketch_apply_matches_reference(kind):
    s, m, n = 48, 200, 70
    Sj = jdraw(jax.random.key(3), kind, s, m)
    St = to_port(kind, Sj)
    rng = np.random.default_rng(1)
    A = rng.standard_normal((m, n)).astype(np.float32)
    At = rng.standard_normal((n, m)).astype(np.float32)
    short = A[: m - 13]  # a shorter operand uses the sketch's first columns
    assert _rel(St.apply(torch.from_numpy(A)), Sj.apply(jnp.asarray(A))) < 1e-6
    assert _rel(St.apply_t(torch.from_numpy(At)), Sj.apply_t(jnp.asarray(At))) < 1e-6
    assert _rel(St.apply(torch.from_numpy(short)), Sj.apply(jnp.asarray(short))) < 1e-6
    np.testing.assert_array_equal(St.materialize().numpy(), np.asarray(Sj.materialize()))


@pytest.mark.parametrize("kind", KINDS)
def test_sketch_cols_and_pad_cols_match_reference(kind):
    s, m = 32, 150
    Sj = jdraw(jax.random.key(4), kind, s, m).pad_cols(180)
    St = to_port(kind, jdraw(jax.random.key(4), kind, s, m)).pad_cols(180)
    assert St.m == Sj.m == 180
    rng = np.random.default_rng(2)
    for off, size in [(0, 40), (40, 40), (140, 40)]:  # the last window reaches the padding
        X = rng.standard_normal((9, size)).astype(np.float32)
        got = St.cols(off, size).apply_t(torch.from_numpy(X))
        want = Sj.cols(off, size).apply_t(jnp.asarray(X))
        assert _rel(got, want) < 1e-6, (off, size)
    np.testing.assert_array_equal(St.cols(140, 40).materialize().numpy()[:, 10:], 0.0)
    with pytest.raises(ValueError):
        St.cols(150, 40)


def test_countsketch_chunk_and_panel_apply_are_bitwise_equal():
    """Each column's sketch depends on that column alone: sketching a whole
    chunk equals sketching its panels one at a time, bit for bit."""
    St = to_port("countsketch", jdraw(jax.random.key(5), "countsketch", 40, 256))
    A = torch.from_numpy(np.random.default_rng(3).standard_normal((256, 160)).astype(np.float32))
    whole = St.apply(A)
    parts = torch.cat([St.apply(A[:, j : j + 40]) for j in range(0, 160, 40)], dim=1)
    assert torch.equal(whole, parts)


def _gmr_operands(rng, zero=False):
    B = rng.standard_normal((60, 8)).astype(np.float32)
    Y = rng.standard_normal((60, 30)).astype(np.float32)
    return (np.zeros_like(B) if zero else B), Y


@pytest.mark.parametrize("zero", [False, True])
def test_solve_least_squares_matches_reference(zero):
    B, Y = _gmr_operands(np.random.default_rng(4), zero)
    got = tgmr._solve_least_squares(torch.from_numpy(B), torch.from_numpy(Y)).numpy()
    want = np.asarray(jgmr._solve_least_squares(jnp.asarray(B), jnp.asarray(Y)))
    assert np.all(np.isfinite(got))
    assert _rel(got, want) < 1e-4


def test_exact_gmr_and_fast_core_match_reference():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((90, 70)).astype(np.float32)
    C = A[:, [3, 10, 22, 40, 41, 66]]
    R = A[[1, 5, 17, 60, 80], :]
    got = tgmr.exact_gmr(*(torch.from_numpy(x) for x in (A, C, R))).numpy()
    want = np.asarray(jgmr.exact_gmr(*(jnp.asarray(x) for x in (A, C, R))))
    assert _rel(got, want) < 1e-4
    ScC = rng.standard_normal((24, 6)).astype(np.float32)
    M = rng.standard_normal((24, 20)).astype(np.float32)
    RSr = rng.standard_normal((5, 20)).astype(np.float32)
    got = tgmr.fast_gmr_core(*(torch.from_numpy(x) for x in (ScC, M, RSr))).numpy()
    want = np.asarray(jgmr.fast_gmr_core(*(jnp.asarray(x) for x in (ScC, M, RSr))))
    assert _rel(got, want) < 1e-4


def test_fast_core_all_zero_operand_is_finite():
    """A sketched block wiped to zero (CountSketch collisions, unfilled
    slots) gives a finite core, never NaN — as in the reference."""
    ScC = np.zeros((24, 6), np.float32)
    M = np.random.default_rng(6).standard_normal((24, 20)).astype(np.float32)
    RSr = np.zeros((5, 20), np.float32)
    got = tgmr.fast_gmr_core(*(torch.from_numpy(x) for x in (ScC, M, RSr))).numpy()
    want = np.asarray(jgmr.fast_gmr_core(*(jnp.asarray(x) for x in (ScC, M, RSr))))
    assert np.all(np.isfinite(got)) and not np.any(np.isnan(got))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_error_ratio_matches_reference():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((80, 60)).astype(np.float32)
    C, R = A[:, :6], A[:5, :]
    X = rng.standard_normal((6, 5)).astype(np.float32)
    got = float(tgmr.error_ratio(*(torch.from_numpy(x) for x in (A, C, X, R))))
    want = float(jgmr.error_ratio(*(jnp.asarray(x) for x in (A, C, X, R))))
    assert abs(got - want) < 1e-4 * max(1.0, abs(want))
