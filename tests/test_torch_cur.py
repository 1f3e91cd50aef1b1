"""One-shot and batched CUR of the port against the JAX reference.

The reference draws the index sets and the core sketches; the port gets
them through :mod:`repro_torch.convert` and must give the same factors: C
and R bitwise (they are gathers), U within 1e-4 absolute (the reference's
own batched-vs-loop tolerance, ``tests/test_cur.py``), from fp32 solves in
two LAPACKs. On the CPU ``ops.twoside_sketch`` runs its plain version;
the CUDA kernel is checked on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cur import batched as jb  # noqa: E402
from repro.cur import cur as jc  # noqa: E402
from repro.cur.selection import select_columns as jselect_columns  # noqa: E402
from repro.cur.selection import select_rows as jselect_rows  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.cur import (  # noqa: E402
    batched_fast_cur,
    cur_relative_error,
    draw_shared_sketches,
    exact_cur,
    fast_cur,
)
from repro_torch.kernels import ops  # noqa: E402

U_TOL = 1e-4


def _t(x, dtype=None):
    return convert.to_tensor(np.asarray(x), "cpu", dtype)


def _sketch(S):
    return convert.sketch_from_arrays(*convert.sketch_arrays(S), "cpu")


def _matrix(seed, m, n):
    """σ_i ∝ 1/i, from numpy (the reference's ``powerlaw_matrix`` law)."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, min(m, n))))
    V, _ = np.linalg.qr(rng.standard_normal((n, min(m, n))))
    return jnp.asarray(((U / np.arange(1, min(m, n) + 1)) @ V.T).astype(np.float32))


@pytest.mark.parametrize("sketch", ["countsketch", "srht", "gaussian", "leverage"])
def test_fast_cur_matches_reference_on_its_indices_and_sketches(sketch):
    m, n, c, r = 80, 64, 6, 5
    A = _matrix(1, m, n)
    ci = jselect_columns(jax.random.key(2), A, c).idx
    ri = jselect_rows(jax.random.key(3), A, r).idx
    C, R = jnp.take(A, ci, axis=1), jnp.take(A, ri, axis=0)
    sketches = jc._draw_core_sketches(jax.random.key(4), C, R, 40, 36, sketch)
    # jit: the reference's eager fwht compiles op by op, for seconds
    want = jax.jit(lambda a, sk: jc.fast_cur(jax.random.key(0), a, col_idx=ci, row_idx=ri,
                                             sketches=sk))(A, sketches)
    got = fast_cur(None, _t(A), col_idx=convert.indices(ci, "cpu"),
                   row_idx=convert.indices(ri, "cpu"),
                   sketches=tuple(_sketch(S) for S in sketches))
    np.testing.assert_array_equal(got.C.numpy(), np.asarray(want.C))
    np.testing.assert_array_equal(got.R.numpy(), np.asarray(want.R))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=0, atol=U_TOL)


@pytest.mark.parametrize("sketch", ["countsketch", "leverage"])
def test_fast_cur_own_draws_and_exact_cur(sketch):
    """The port's own draws: valid indices, finite factors, and a core no
    worse than a few times the exact core's error on a power-law matrix."""
    A = _t(_matrix(5, 90, 70))
    g = torch.Generator().manual_seed(6)
    res = fast_cur(g, A, 10, 10, policy="approx_leverage", sketch=sketch)
    ex = exact_cur(A, res.col_idx, res.row_idx)
    for idx, hi in ((res.col_idx, 70), (res.row_idx, 90)):
        assert len(set(idx.tolist())) == 10 and int(idx.min()) >= 0 and int(idx.max()) < hi
    assert bool(torch.isfinite(res.U).all())
    assert float(cur_relative_error(A, res)) < 3.0 * float(cur_relative_error(A, ex)) + 1e-3
    drawn = exact_cur(A, gen=torch.Generator().manual_seed(7), c=5, r=4, policy="leverage")
    assert drawn.C.shape == (90, 5) and drawn.R.shape == (4, 70)
    with pytest.raises(ValueError):
        exact_cur(A, c=5, r=4)
    with pytest.raises(ValueError):
        fast_cur(g, A, None, 4)


def _reference_batch(dtype, use_kernel):
    B, m, n, c, r = 3, 96, 80, 8, 8
    A = jnp.stack([_matrix(30 + i, m, n) for i in range(B)]).astype(dtype)
    # the reference's bf16 draw is float32 (its 1/√s scale promotes it)
    sketches = jb.draw_shared_sketches(jax.random.key(16), m, n, 48, 48, dtype=dtype)
    res = jb.batched_fast_cur(jax.random.key(17), A, c, r, sketches=sketches,
                              use_kernel=use_kernel)
    return A, sketches, res


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_batched_fast_cur_matches_reference(dtype, use_kernel):
    """Against the reference's batched result on its shared sketches and
    per-item indices, route for route: the Pallas route (interpret mode)
    against ``ops.twoside_sketch`` (whose M both round to A's dtype), the
    einsum route against ``use_kernel=False``."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    A, sketches, want = _reference_batch(jdt, use_kernel)
    got = batched_fast_cur(None, _t(A), 8, 8, sketches=tuple(_sketch(S) for S in sketches),
                           col_idx=convert.indices(want.col_idx, "cpu"),
                           row_idx=convert.indices(want.row_idx, "cpu"),
                           use_kernel=None if use_kernel else False)
    assert got.U.shape == (3, 8, 8) and got.C.shape == (3, 96, 8) and got.R.shape == (3, 8, 80)
    np.testing.assert_array_equal(got.C.float().numpy(), np.asarray(want.C.astype(jnp.float32)))
    np.testing.assert_array_equal(got.R.float().numpy(), np.asarray(want.R.astype(jnp.float32)))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=0, atol=U_TOL)
    rel = float(cur_relative_error(_t(A).float(), got))
    assert abs(rel - float(jc.cur_relative_error(A, want))) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_fast_cur_equals_a_loop_of_fast_cur(dtype):
    """The port's batched CUR ≡ a loop of its one-shot ``fast_cur`` with the
    same shared sketches and per-item indices. In bf16 the kernel route
    rounds M to bf16 as the reference does, so the loop is held against the
    einsum route there."""
    B, m, n = 3, 64, 56
    A = torch.stack([_t(_matrix(40 + i, m, n)) for i in range(B)]).to(dtype)
    g = torch.Generator().manual_seed(8)
    sketches = draw_shared_sketches(g, m, n, 32, 32, dtype=dtype)
    assert sketches[0].mat.dtype == torch.float32  # as the reference's draw comes out
    ops.reset_launches()
    res = batched_fast_cur(g, A, 6, 6, sketches=sketches,
                           use_kernel=None if dtype == torch.float32 else False)
    assert ops.LAUNCHES["twoside_sketch"] == 0  # CPU tensors: the plain version
    for b in range(B):
        item = fast_cur(None, A[b], col_idx=res.col_idx[b], row_idx=res.row_idx[b],
                        sketches=sketches)
        assert torch.equal(item.C, res.C[b]) and torch.equal(item.R, res.R[b])
        np.testing.assert_allclose(res.U[b].numpy(), item.U.numpy(), rtol=0, atol=U_TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_batched_fast_cur_default_draw_bf16_matches_reference(use_kernel):
    """With no sketches given, a bf16 stack is sketched as the reference
    sketches it by default: its ``draw_shared_sketches`` comes out float32,
    so S_C·C, R·S_Rᵀ and M are float32 products. The port draws its own pair
    from a seeded generator; the same pair, redrawn, goes to the reference,
    whose per-item indices come back to the port."""
    B, m, n, s = 3, 96, 80, 48
    A = jnp.stack([_matrix(60 + i, m, n) for i in range(B)]).astype(jnp.bfloat16)
    pair = draw_shared_sketches(torch.Generator().manual_seed(18), m, n, s, s,
                                dtype=torch.bfloat16)
    jpair = tuple(jb.GaussianSketch(jnp.asarray(S.mat.float().numpy())) for S in pair)
    want = jb.batched_fast_cur(jax.random.key(20), A, 8, 8, sketches=jpair,
                               use_kernel=use_kernel)
    got = batched_fast_cur(torch.Generator().manual_seed(18), _t(A), 8, 8, s_c=s, s_r=s,
                           col_idx=convert.indices(want.col_idx, "cpu"),
                           row_idx=convert.indices(want.row_idx, "cpu"),
                           use_kernel=None if use_kernel else False)
    np.testing.assert_array_equal(got.C.float().numpy(), np.asarray(want.C.astype(jnp.float32)))
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=0, atol=U_TOL)
    want_pair = jb.draw_shared_sketches(jax.random.key(19), m, n, s, s, dtype=jnp.bfloat16)
    assert all(S.mat.dtype == jnp.float32 for S in want_pair)
    assert all(S.mat.dtype == torch.float32 for S in pair)


@pytest.mark.parametrize("selection", ["uniform", "approx_leverage"])
def test_batched_selection_draws_valid_per_item_indices(selection):
    B, m, n = 4, 70, 60
    A = torch.stack([_t(_matrix(50 + i, m, n)) for i in range(B)])
    res = batched_fast_cur(torch.Generator().manual_seed(9), A, 7, 5, selection=selection)
    assert res.col_idx.shape == (B, 7) and res.row_idx.shape == (B, 5)
    for b in range(B):
        assert len(set(res.col_idx[b].tolist())) == 7 and int(res.col_idx[b].max()) < n
        assert len(set(res.row_idx[b].tolist())) == 5 and int(res.row_idx[b].max()) < m
        assert torch.equal(res.C[b], A[b][:, res.col_idx[b].long()])
    assert bool(torch.isfinite(res.U).all())
    again = batched_fast_cur(torch.Generator().manual_seed(9), A, 7, 5, selection=selection)
    assert torch.equal(again.col_idx, res.col_idx) and torch.equal(again.U, res.U)
    with pytest.raises(ValueError):
        batched_fast_cur(None, A, 3, 3, selection="pivoted_qr")
    with pytest.raises(ValueError):
        batched_fast_cur(None, A[0], 3, 3)
