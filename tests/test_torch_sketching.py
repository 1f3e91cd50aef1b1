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


def test_indexed_windows_carry_their_bucket_order():
    """After ``index_windows(L)`` a window on the L grid carries its slice of
    the stream's orders, equal to its own ``bucket_order``, the last (ragged
    only past the padding) included; a window off the grid, or of another
    width, sorts its own. OSNAP indexes and hands over its parts' orders."""
    from repro_torch.kernels.ops import bucket_order

    St = to_port("countsketch", jdraw(jax.random.key(7), "countsketch", 30, 200)).pad_cols(240)
    assert St.index_windows(40) is St
    for off, size, indexed in [(0, 40, True), (80, 40, True), (200, 40, True), (20, 40, False),
                               (40, 20, False)]:
        W = St.cols(off, size)
        assert bool(W._order) == indexed, (off, size)
        perm, start = W.order()
        want = bucket_order(St.hashes[off : off + size], St.s)
        assert torch.equal(perm, want[0]) and torch.equal(start, want[1])
    So = to_port("osnap", jdraw(jax.random.key(8), "osnap", 30, 240)).index_windows(40)
    for part, whole in zip(So.cols(120, 40).parts(), So.parts()):
        assert part._order and torch.equal(part.hashes, whole.hashes[120:160])
        assert torch.equal(part.order()[1], bucket_order(whole.hashes[120:160], 30)[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_fold_apply_t_equals_add_of_apply_t(kind, dtype):
    """The engine's M fold gives the bits of ``M.add_(S_R.cols(off,
    L).apply_t(sc_a).to(M.dtype))``, for fp32 and bf16 M (and a bf16 sc_a,
    whose apply_t rounds to bf16 before the add), with the window's
    indexed order or its own."""
    from repro_torch.core.sketching import fold_apply_t, index_windows

    rng = np.random.default_rng(9)
    dt = getattr(torch, dtype)
    S = to_port(kind, jdraw(jax.random.key(3), kind, 48, 160))
    index_windows(S, 40)
    for off in (40, 120):
        for x_dt in (torch.float32, dt):
            W = S.cols(off, 40)
            X = torch.from_numpy(rng.standard_normal((30, 40)).astype(np.float32)).to(x_dt)
            M0 = torch.from_numpy(rng.standard_normal((30, 48)).astype(np.float32)).to(dt)
            want = M0.clone().add_(W.apply_t(X).to(dt))
            got = fold_apply_t(W, X, M0.clone())
            assert got.dtype == dt and torch.equal(got, want), (off, x_dt)


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


ALL_KINDS = ["gaussian", "srht", "countsketch", "osnap", "uniform", "leverage", "osnap+gaussian"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ALL_KINDS)
def test_draw_sketch_dtypes_match_reference(kind, dtype):
    """``materialize``, ``apply`` and ``apply_t`` of a ``draw_sketch(dtype=…)``
    come out in the reference's dtype, for operands in float32 and in
    bfloat16: Gaussian, SRHT, OSNAP and their composition promote a narrower
    dtype to float32 (the reference's ``1/√k`` scale is a numpy float64
    scalar); CountSketch and uniform sampling keep it; leverage sampling
    promotes with the dtype of its (float32) probabilities."""
    s, m, n = 8, 32, 5
    probs = np.linspace(1.0, 2.0, m).astype(np.float32) if kind == "leverage" else None
    Sj = jdraw(jax.random.key(16), kind, s, m, dtype=getattr(jnp, dtype),
               probs=None if probs is None else jnp.asarray(probs))
    St = draw_sketch(torch.Generator().manual_seed(16), kind, s, m, dtype=getattr(torch, dtype),
                     probs=None if probs is None else torch.from_numpy(probs))
    A = np.ones((m, n), np.float32)
    for a_dtype in ("float32", "bfloat16"):
        # jit: the reference's eager fwht compiles op by op
        want = jax.jit(lambda S, a: (S.materialize(), S.apply(a), S.apply_t(a.T)))(
            Sj, jnp.asarray(A).astype(getattr(jnp, a_dtype)))
        At = torch.from_numpy(A).to(getattr(torch, a_dtype))
        got = (St.materialize(), St.apply(At), St.apply_t(At.T))
        assert [str(g.dtype).removeprefix("torch.") for g in got] == \
            [str(w.dtype) for w in want], (kind, dtype, a_dtype)


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
