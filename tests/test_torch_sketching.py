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
from repro.core.sketching import GaussianSketch as JGaussian  # noqa: E402
from repro.core.sketching import draw_sketch as jdraw  # noqa: E402
from repro.core.sketching import fwht as jfwht  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gmr as tgmr  # noqa: E402
from repro_torch.core.sketching import draw_sketch, fwht  # noqa: E402

KINDS = ["gaussian", "countsketch", "osnap"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def to_port(kind, S):
    """The reference sketch ``S`` as the port's object, on the CPU."""
    got_kind, arrays = convert.sketch_arrays(S)
    assert got_kind == kind
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


# ---------------------------------------------------------------------------
# SRHT, row sampling, composed sketches (one-shot CUR's families)
# ---------------------------------------------------------------------------

# port kind of the reference's draw_sketch kind
NEW_KINDS = {"srht": "srht", "uniform": "rowsampling", "leverage": "rowsampling",
             "osnap+gaussian": "composed"}


def _draw_reference(kind, s, m, seed):
    probs = None
    if kind == "leverage":  # a few zero-probability rows, never sampled
        probs = np.random.default_rng(seed).random(m).astype(np.float32)
        probs[::7] = 0.0
        probs = jnp.asarray(probs)
    return jdraw(jax.random.key(seed), kind, s, m, probs=probs)


def test_fwht_matches_reference():
    x = np.random.default_rng(10).standard_normal((64, 5)).astype(np.float32)
    assert _rel(fwht(torch.from_numpy(x)), jfwht(jnp.asarray(x))) < 1e-6
    with pytest.raises(ValueError):
        fwht(torch.zeros(48, 2))


@pytest.mark.parametrize("kind", list(NEW_KINDS))
def test_new_families_match_reference(kind):
    """apply / apply_t / materialize / cols / pad_cols on the same arrays,
    within 1e-5 (fp32 sums of the same terms, possibly in other orders)."""
    s, m, n = 24, 100, 30  # m is not a power of two: SRHT pads to 128
    Sj = _draw_reference(kind, s, m, 11)
    St = to_port(NEW_KINDS[kind], Sj)
    rng = np.random.default_rng(12)
    A = rng.standard_normal((m, n)).astype(np.float32)
    At = rng.standard_normal((n, m)).astype(np.float32)
    assert St.s == s and St.m == m
    # jit: the reference's eager fwht compiles op by op, for seconds
    want = jax.jit(lambda S, a, at: (S.apply(a), S.apply_t(at), S.materialize()))(
        Sj, jnp.asarray(A), jnp.asarray(At))
    assert _rel(St.apply(torch.from_numpy(A)), want[0]) < 1e-5
    assert _rel(St.apply_t(torch.from_numpy(At)), want[1]) < 1e-5
    assert _rel(St.materialize(), want[2]) < 1e-5
    if kind == "srht":
        with pytest.raises(NotImplementedError):
            St.cols(0, 10)
        return
    X = rng.standard_normal((9, 40)).astype(np.float32)
    for off in (0, 35, 90):  # the last window reaches the padding
        got = St.pad_cols(130).cols(off, 40).apply_t(torch.from_numpy(X))
        want = Sj.pad_cols(130).cols(off, 40).apply_t(jnp.asarray(X))
        assert _rel(got, want) < 1e-5, off


def test_port_draws_of_new_families():
    """The port's own draws: the right shapes, ``apply`` equal to the dense
    sketch, and leverage sampling never picks a zero-probability row."""
    g = torch.Generator().manual_seed(13)
    m = 50
    probs = torch.rand(m, generator=g)
    probs[::5] = 0.0
    A = torch.randn((m, 7), generator=g)
    for kind in NEW_KINDS:
        S = draw_sketch(g, kind, 16, m, probs=probs if kind == "leverage" else None)
        assert S.s == 16 and S.materialize().shape == (16, m)
        assert _rel(S.apply(A), S.materialize() @ A) < 1e-5, kind
    S = draw_sketch(g, "leverage", 400, m, probs=probs)
    assert bool((probs[S.idx] > 0).all())
    p = probs / probs.sum()
    torch.testing.assert_close(S.scale, 1.0 / torch.sqrt(400 * p[S.idx]))
    with pytest.raises(ValueError):
        draw_sketch(g, "leverage", 4, m)


def test_convert_keeps_dtypes_and_batched_index_sets():
    mat = jdraw(jax.random.key(14), "gaussian", 8, 20).mat.astype(jnp.bfloat16)
    St = to_port("gaussian", JGaussian(mat))
    assert St.mat.dtype == torch.bfloat16
    np.testing.assert_array_equal(St.mat.float().numpy(), np.asarray(mat.astype(jnp.float32)))
    assert to_port("gaussian", JGaussian(mat.astype(jnp.float32))).mat.dtype == torch.float32
    idx = convert.indices(np.arange(15).reshape(3, 5), "cpu")
    assert idx.shape == (3, 5) and idx.dtype == torch.int32


def test_batched_least_squares_floor_is_per_item():
    """One item all zeros, one O(1e3) in scale, one O(1): each item of the
    batched solve equals its own 2-D solve (its floor comes from its own
    diagonal, as under the reference's vmap) and the reference's vmap."""
    rng = np.random.default_rng(15)
    B = np.stack([np.zeros((40, 6)), 1e3 * rng.standard_normal((40, 6)),
                  rng.standard_normal((40, 6))]).astype(np.float32)
    Y = rng.standard_normal((3, 40, 9)).astype(np.float32)
    got = tgmr._solve_least_squares(torch.from_numpy(B), torch.from_numpy(Y))
    want = np.asarray(jax.vmap(jgmr._solve_least_squares)(jnp.asarray(B), jnp.asarray(Y)))
    for b in range(3):
        one = tgmr._solve_least_squares(torch.from_numpy(B[b]), torch.from_numpy(Y[b]))
        assert bool(torch.isfinite(got[b]).all())
        assert _rel(got[b], one) < 1e-6, b
        assert _rel(got[b], want[b]) < 1e-4, b
