"""Plain versions of the port's kernels against the JAX kernels and oracles.

The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``). Here their plain versions — the functions the
wrappers take for CPU tensors — are held against the reference's Pallas
kernels run in interpret mode (as ``tests/test_kernels.py`` and
``tests/test_panel_update.py`` run them) and against ``repro.kernels.ref``,
and the arithmetic the CUDA sources implement (bucket-ordered CountSketch
sums, the pairwise admission rank) is emulated and checked against them.
Tolerances follow the reference's kernel tests: 1e-5 of the largest entry in
fp32, 3e-2 for bf16 inputs; ``slots`` must be equal exactly.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kernels as jk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.countsketch import bucket_order  # noqa: E402
from repro_torch.kernels.panel_score import BK, BM, FOLD_BN, PANEL_BN, split_plan  # noqa: E402


def _close(got, want, scale_tol, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.max(np.abs(want))) + 1e-30
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_tol * scale, err_msg=name)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# kernel 1: countsketch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 300, 200), (200, 1000, 130)])
def test_countsketch_plain_matches_pallas(shape, dtype):
    s, m, n = shape
    rng = np.random.default_rng(sum(shape))
    h = rng.integers(0, s, m).astype(np.int32)
    sg = rng.choice([-1.0, 1.0], m).astype(np.float32)
    A = rng.standard_normal((m, n)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    Aj = jnp.asarray(A).astype(jdt)
    At = _t(np.asarray(Aj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = ops.countsketch_apply(_t(h), _t(sg), At, s)
    tol = 1e-5 if dtype == "float32" else 2.5e-2
    _close(got, jk.countsketch_apply(jnp.asarray(h), jnp.asarray(sg), Aj, s, interpret=True), tol)
    _close(got, jk.countsketch_ref(jnp.asarray(h), jnp.asarray(sg), Aj, s), tol)


def _emulate_countsketch_kernel(hashes, signs, a, s):
    """The CUDA kernel's arithmetic: per (bucket, column), the bucket's rows
    in ascending order, product and sum each rounded to fp32."""
    perm, start = bucket_order(hashes, s)
    out = torch.zeros((s, a.shape[1]), dtype=torch.float32)
    for b in range(s):
        acc = torch.zeros(a.shape[1], dtype=torch.float32)
        for p in range(int(start[b]), int(start[b + 1])):
            r = int(perm[p])
            acc = acc + signs[r] * a[r].float()
        out[b] = acc
    return out


def test_countsketch_kernel_order_is_the_plain_order():
    """Bucket order + ascending rows (the kernel) gives the plain version's
    bits, and ``apply_t``'s transposed operand and output change nothing."""
    s, m, n = 12, 90, 17
    rng = np.random.default_rng(8)
    h = _t(rng.integers(0, s, m).astype(np.int32))
    sg = _t((rng.choice([-1.0, 1.0], m) / np.sqrt(2)).astype(np.float32))
    A = _t(rng.standard_normal((m, n)).astype(np.float32))
    plain = ops.countsketch_apply(h, sg, A, s)
    assert torch.equal(plain, _emulate_countsketch_kernel(h, sg, A, s))
    perm, start = bucket_order(h, s)
    assert torch.equal(start[1:] - start[:-1], torch.bincount(h.long(), minlength=s).int())
    assert torch.equal(h[perm.long()], torch.sort(h).values)
    At = A.T.contiguous()
    assert torch.equal(ops.countsketch_apply(h, sg, At.T, s, transpose_out=True), plain.T)


# ---------------------------------------------------------------------------
# kernel 4: twoside_sketch
# ---------------------------------------------------------------------------

# the reference's TWOSIDE_SHAPES (tests/test_kernels.py) as (B, s_c, m, n, s_r),
# plus one batch, which the reference vmaps over its kernel
TWOSIDE_SHAPES = [(1, 64, 300, 200, 64), (1, 128, 512, 512, 96), (1, 32, 130, 260, 48),
                  (1, 256, 1024, 384, 128), (1, 128, 256, 256, 128), (3, 48, 130, 70, 40)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", TWOSIDE_SHAPES)
def test_twoside_sketch_plain_matches_pallas(shape, dtype):
    """Tolerance, of the largest entry: 1e-5 in fp32; 2.5e-2 for bf16 inputs
    against the Pallas kernel, which rounds ``S_C·A`` to bf16 before the
    second product (the reference's own kernel-vs-oracle tolerance), and
    1e-5 against the reference's oracle, which keeps it in fp32 as the port
    does."""
    B, s_c, m, n, s_r = shape
    rng = np.random.default_rng(sum(shape))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    sc, srt = (jnp.asarray(rng.standard_normal(sh).astype(np.float32)).astype(jdt)
               for sh in ((s_c, m), (n, s_r)))
    a = jnp.asarray(rng.standard_normal((B, m, n)).astype(np.float32)).astype(jdt)
    port = [_t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype)) for x in (sc, a, srt)]
    got = ops.twoside_sketch(port[0], port[1] if B > 1 else port[1][0], port[2])
    assert got.dtype == torch.float32 and got.shape == ((B,) if B > 1 else ()) + (s_c, s_r)
    want = jax.vmap(lambda x: jk.twoside_sketch(sc, x, srt, interpret=True))(a)
    oracle = jk.twoside_sketch_ref(sc, a, srt)
    got = got.reshape(B, s_c, s_r)
    _close(got, want, 1e-5 if dtype == "float32" else 2.5e-2)
    _close(got, oracle, 1e-5)


# ---------------------------------------------------------------------------
# kernel 2: panel_score
# ---------------------------------------------------------------------------


def _basis(rng, s_c, c, filled):
    Q, _ = np.linalg.qr(rng.standard_normal((s_c, c)))
    return (Q * (np.arange(c) < filled)).astype(np.float32)


@pytest.mark.parametrize("shape", [(72, 300, 96, 16), (64, 130, 40, 8)])
def test_panel_score_plain_matches_pallas(shape):
    s_c, m, L, c = shape
    rng = np.random.default_rng(sum(shape))
    sc = rng.standard_normal((s_c, m)).astype(np.float32)
    a_l = rng.standard_normal((m, L)).astype(np.float32)
    q = _basis(rng, s_c, c, max(1, c // 2))
    got = ops.panel_score(_t(sc), _t(a_l), _t(q))
    want = jk.panel_score(jnp.asarray(sc), jnp.asarray(a_l), jnp.asarray(q), interpret=True)
    oracle = jk.panel_score_ref(jnp.asarray(sc), jnp.asarray(a_l), jnp.asarray(q))
    for g, w, o, name in zip(got, want, oracle, ("sc_a", "resid2", "energy")):
        _close(g, w, 2e-5, name)
        _close(g, o, 2e-5, name)


def test_panel_score_empty_and_full_basis():
    """Empty basis ⇒ resid2 == energy; a basis spanning the sketch space ⇒ 0."""
    s_c, m, L = 32, 200, 64
    rng = np.random.default_rng(9)
    sc = _t(rng.standard_normal((s_c, m)).astype(np.float32))
    a_l = _t(rng.standard_normal((m, L)).astype(np.float32))
    _, r2, en = ops.panel_score(sc, a_l, torch.zeros((s_c, 8)))
    assert torch.equal(r2, en)
    _, r2f, enf = ops.panel_score(sc, a_l, torch.eye(s_c))
    assert float(r2f.max()) <= 2e-3 * float(enf.max())


# ---------------------------------------------------------------------------
# kernel 3: panel_update
# ---------------------------------------------------------------------------


def _pu_inputs(seed, s_c, m, L, c, s_r, filled=None):
    rng = np.random.default_rng(seed)
    filled = max(1, c // 2) if filled is None else filled
    sc = rng.standard_normal((s_c, m)).astype(np.float32)
    a_l = rng.standard_normal((m, L)).astype(np.float32)
    srt = rng.standard_normal((L, s_r)).astype(np.float32)
    q = _basis(rng, s_c, c, filled)
    C = (rng.standard_normal((m, c)) * (np.arange(c) < filled)).astype(np.float32)
    M = rng.standard_normal((s_c, s_r)).astype(np.float32)
    kw = dict(min_gain=0.5, run_mean=0.0, true_cols=float(L), n_filled=filled,
              free=c - filled, panel_cap=3)
    return [sc, a_l, srt, q, C, M], kw


def _run_both(arrays, kw, dtype="float32"):
    """Port plain version (C/M updated in place on copies) and the Pallas
    kernel in interpret mode on the same inputs."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ja = [jnp.asarray(x).astype(jdt) if i < 3 else jnp.asarray(x) for i, x in enumerate(arrays)]
    ta = [_t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype)) if i < 3 else _t(x)
          for i, x in enumerate(ja)]
    got = ops.panel_update(*ta, **kw)
    want = jk.panel_update(*ja, interpret=True, **kw)
    return got, want, ja


def _check_update(got, want, tol=1e-5):
    for g, w, name in zip(got[:5], want[:5], ("C", "M", "sc_a", "resid2", "energy")):
        _close(g, w, tol, name)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]), err_msg="slots")


@pytest.mark.parametrize("shape", [(72, 300, 96, 16, 72), (64, 256, 40, 8, 48)])
def test_panel_update_plain_matches_pallas(shape):
    arrays, kw = _pu_inputs(sum(shape), *shape)
    got, want, ja = _run_both(arrays, kw)
    _check_update(got, want)
    oracle = jk.panel_update_ref(*ja, **kw)
    _check_update(got, oracle)
    assert int((got[5] < shape[3]).sum()) <= min(kw["panel_cap"], kw["free"])


def test_panel_update_empty_admission_mask():
    arrays, kw = _pu_inputs(5, 64, 256, 40, 8, 64)
    kw["min_gain"] = 1e9
    C0, M0 = arrays[4].copy(), arrays[5].copy()
    got, want, _ = _run_both(arrays, kw)
    _check_update(got, want)
    np.testing.assert_array_equal(got[0].numpy(), C0)
    np.testing.assert_array_equal(got[5].numpy(), np.full(40, 8))
    assert float(np.max(np.abs(got[1].numpy() - M0))) > 0.0  # M still folds


def test_panel_update_budget_exhausted():
    arrays, kw = _pu_inputs(6, 64, 256, 64, 8, 64, filled=8)
    assert kw["free"] == 0
    got, want, _ = _run_both(arrays, kw)
    _check_update(got, want)
    np.testing.assert_array_equal(got[5].numpy(), np.full(64, 8))


def test_panel_update_bf16_inputs_fp32_accum():
    arrays, kw = _pu_inputs(8, 72, 1024, 96, 16, 72)
    got, want, _ = _run_both(arrays, kw, "bfloat16")
    assert got[2].dtype == torch.float32 and got[3].dtype == torch.float32
    _check_update(got, want, 3e-2)


def test_panel_update_tied_resid2_go_to_the_lower_index():
    """Integer-valued operands make every sum exact, so duplicated panel
    columns tie exactly in ``resid2``; the lower column index must win."""
    s_c, m, L, c, s_r = 16, 64, 24, 8, 16
    rng = np.random.default_rng(11)
    sc = rng.integers(-1, 2, (s_c, m)).astype(np.float32)
    a_l = rng.integers(-2, 3, (m, L)).astype(np.float32)
    a_l[:, [5, 9, 17]] = 3 * a_l[:, [2]]  # three exact ties, heavier than the rest
    srt = rng.integers(-1, 2, (L, s_r)).astype(np.float32)
    arrays = [sc, a_l, srt, np.zeros((s_c, c), np.float32), np.zeros((m, c), np.float32),
              np.zeros((s_c, s_r), np.float32)]
    kw = dict(min_gain=1.0, run_mean=0.0, true_cols=float(L), n_filled=1, free=2, panel_cap=3)
    got, want, _ = _run_both(arrays, kw)
    _check_update(got, want)
    slots = got[5].numpy()
    r2 = got[3].numpy()
    assert r2[5] == r2[9] == r2[17] and r2[5] == r2.max()
    assert slots[5] == 1 and slots[9] == 2 and slots[17] == c  # budget of two


def _emulate_admit_kernel(resid2, energy, min_gain, run_mean, true_cols, n_filled, free,
                          panel_cap, c_total):
    """The CUDA admit kernel's pairwise-rank formula, in numpy."""
    thresh = np.float32(min_gain) * max(np.float32(run_mean),
                                        np.float32(energy.sum(dtype=np.float32) / true_cols))
    elig = resid2 > thresh
    L = resid2.shape[0]
    idx = np.arange(L)
    better = elig[:, None] & ((resid2[:, None] > resid2[None, :])
                              | ((resid2[:, None] == resid2[None, :]) & (idx[:, None] < idx[None, :])))
    rank = better.sum(axis=0)
    admit = elig & (rank < min(free, panel_cap))
    return np.where(admit, n_filled + rank, c_total).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairwise_rank_equals_stable_top_k(seed):
    """The kernel's O(L²) rank is the same selection as top_k + cumsum,
    ties included (resid2 drawn from a few values so ties are common)."""
    rng = np.random.default_rng(seed)
    L = 64
    resid2 = rng.choice(np.array([0.0, 0.5, 1.0, 2.0, 3.0], np.float32), L)
    energy = np.full(L, 0.75, np.float32)
    kw = dict(min_gain=1.0, run_mean=0.3, true_cols=float(L), n_filled=3, free=5, panel_cap=4)
    want = ref.admission_slots(_t(resid2), _t(energy), c_total=12, **kw).numpy()
    got = _emulate_admit_kernel(resid2, energy, c_total=12, **kw)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the stream-K launch plan of kernels 2 and 3 (csrc/sgemm_sm90.cuh)
# ---------------------------------------------------------------------------


# (rows, cols, k, SMs, blocks per SM, tile width): the path's sketch product
# at 1 and 2 blocks per SM, a ragged m, a 200-column panel, and the M fold
PLAN_CASES = [(1920, 256, 32768, 132, 1, PANEL_BN), (1920, 256, 32768, 132, 2, PANEL_BN),
              (1920, 256, 32771, 132, 1, PANEL_BN), (1920, 200, 32768, 132, 1, PANEL_BN),
              (1920, 200, 32768, 132, 2, PANEL_BN), (1920, 1920, 256, 132, 1, FOLD_BN)]


def _pieces(plan, t):
    """``[(block, first slab, end slab)]`` of tile ``t``, in summation order."""
    lo, hi = t * plan.slabs, (t + 1) * plan.slabs
    return [(b, max(plan.begin(b), lo) - lo, min(plan.begin(b + 1), hi) - lo)
            for b in plan.tile_blocks(t)]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_split_plan_whole_waves_whole_slabs_cover_m(case):
    """One block per resident slot, each a run of whole k-slabs no more than
    one slab longer than any other; each tile's pieces cover its k-slabs
    once, in order, which cover m exactly; partial slots never collide."""
    rows, cols, k, n_sm, bps, bn = case
    plan = split_plan(rows, cols, k, n_sm, bps, bn=bn)
    assert plan.nblocks == n_sm * bps  # a whole wave
    assert plan.tiles == -(-rows // BM) * -(-cols // bn) and plan.units == plan.tiles * plan.slabs
    assert (plan.slabs - 1) * BK < k <= plan.slabs * BK  # the slabs cover m, no more
    sizes = [plan.begin(b + 1) - plan.begin(b) for b in range(plan.nblocks)]
    assert plan.begin(0) == 0 and plan.begin(plan.nblocks) == plan.units
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    slots = set()
    for t in range(plan.tiles):
        pieces = _pieces(plan, t)
        assert pieces[0][1] == 0 and pieces[-1][2] == plan.slabs
        assert all(p[2] == q[1] for p, q in zip(pieces, pieces[1:]))  # contiguous, ascending k
        assert all(s1 > s0 for _, s0, s1 in pieces)
        for b, _, _ in pieces:
            assert plan.begin(b) < (t + 1) * plan.slabs and plan.begin(b + 1) > t * plan.slabs
            slots.add(b + t)
    assert len(slots) == sum(len(plan.tile_blocks(t)) for t in range(plan.tiles))
    assert max(slots) < plan.partial_slots


def test_split_plan_small_products_use_fewer_blocks():
    plan = split_plan(20, 3, 17, 132, 1)  # one tile of two slabs
    assert (plan.tiles, plan.slabs, plan.nblocks) == (1, 2, 2)
    with pytest.raises(ValueError):
        split_plan(20, 3, 0, 132, 1)


def _emulate_split_k(a, b, plan, bn):
    """The kernel's summation order: each block's piece of a tile summed over
    its k-range, the pieces then added in block order into a zero."""
    rows, k = a.shape
    out = torch.zeros((rows, b.shape[1]), dtype=torch.float32)
    for t in range(plan.tiles):
        r0, c0 = (t // plan.ntn) * BM, (t % plan.ntn) * bn
        acc = torch.zeros_like(out[r0:r0 + BM, c0:c0 + bn])
        for _, s0, s1 in _pieces(plan, t):
            ks = slice(s0 * BK, min(s1 * BK, k))
            acc = acc + a[r0:r0 + BM, ks].float() @ b[ks, c0:c0 + bn].float()
        out[r0:r0 + BM, c0:c0 + bn] = acc
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_k_order_emulation_matches_plain(dtype):
    """Kernels 2 and 3 sum each entry's k-range in pieces, added in block
    order: on a few SMs the pieces cross tile boundaries, and the result
    equals the plain product within 1e-5 of its largest entry (the same fp32
    terms in another order), for the sketch product and the M fold."""
    rng = np.random.default_rng(21)
    dt = getattr(torch, dtype)
    sc = torch.from_numpy(rng.standard_normal((300, 1000)).astype(np.float32))
    a_l = torch.from_numpy(rng.standard_normal((1000, 200)).astype(np.float32)).to(dt)
    q = torch.from_numpy(_basis(rng, 300, 16, 8))
    for n_sm in (1, 5, 7):
        plan = split_plan(300, 200, 1000, n_sm, 1)
        assert plan.nblocks == n_sm and plan.tiles == 3
        sc_a = _emulate_split_k(sc, a_l, plan, PANEL_BN)
        want = ops.panel_score(sc, a_l, q)[0]
        _close(sc_a, want, 1e-5, f"sketch product, {n_sm} SMs")
        srt = torch.from_numpy(rng.standard_normal((200, 150)).astype(np.float32))
        fold = split_plan(300, 150, 200, n_sm, 1, bn=FOLD_BN)
        _close(_emulate_split_k(sc_a, srt, fold, FOLD_BN), sc_a @ srt, 1e-5, f"fold, {n_sm} SMs")


def test_wrappers_take_the_kernel_dtypes_and_refuse_the_rest():
    """The (sketch, panel[, C and M]) dtypes kernels 2 and 3 take run on the
    CPU through the plain versions; the others raise, on the CPU as on the
    card."""
    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(22)
    s_c, m, L, c, s_r = 24, 64, 12, 4, 20
    base = {k: torch.from_numpy(rng.standard_normal(sh).astype(np.float32)) for k, sh in
            (("sc", (s_c, m)), ("a", (m, L)), ("srt", (L, s_r)), ("C", (m, c)), ("M", (s_c, s_r)))}
    q = torch.zeros(s_c, c)
    kw = dict(min_gain=0.5, run_mean=0.0, true_cols=float(L), n_filled=0, free=c, panel_cap=2)
    for dsc, da in ((f32, f32), (bf16, bf16), (f32, bf16)):
        out = ops.panel_score(base["sc"].to(dsc), base["a"].to(da), q)
        assert all(t.dtype == f32 for t in out)
    for dsc, da in ((bf16, f32), (torch.float64, torch.float64), (f32, torch.float16)):
        with pytest.raises(ValueError):
            ops.panel_score(base["sc"].to(dsc), base["a"].to(da), q)
    for (dsc, da), dcm in itertools.product(((f32, f32), (bf16, bf16), (f32, bf16)), (f32, bf16)):
        C, M = base["C"].to(dcm), base["M"].to(dcm)
        out = ops.panel_update(base["sc"].to(dsc), base["a"].to(da), base["srt"].to(dsc), q,
                               C, M, **kw)
        assert out[0] is C and out[1] is M and C.dtype == M.dtype == dcm
    f64 = torch.float64
    for dsc, da, dcm, dsrt, dm in ((bf16, f32, f32, bf16, f32), (f32, bf16, f32, bf16, f32),
                                   (f32, bf16, bf16, f32, f32), (f32, f32, f64, f32, f64),
                                   (f64, f64, f32, f64, f32)):
        with pytest.raises(ValueError):
            ops.panel_update(base["sc"].to(dsc), base["a"].to(da), base["srt"].to(dsrt), q,
                             base["C"].to(dcm), base["M"].to(dm), **kw)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_plain_versions_without_counting():
    ops.reset_launches()
    ops.countsketch_apply(torch.zeros(5, dtype=torch.int32), torch.ones(5), torch.ones(5, 3), 4)
    ops.panel_score(torch.ones(4, 5), torch.ones(5, 3), torch.zeros(4, 2))
    ops.twoside_sketch(torch.ones(4, 5), torch.ones(2, 5, 3), torch.ones(3, 6))
    assert ops.LAUNCHES == {"countsketch": 0, "panel_score": 0, "panel_update": 0,
                            "twoside_sketch": 0}
    assert not ops.kernel_route_enabled(torch.ones(1))


def test_wrappers_refuse_devices_without_a_kernel():
    with pytest.raises(ValueError):
        ops.panel_score(torch.ones(4, 5, device="meta"), torch.ones(5, 3, device="meta"),
                        torch.zeros(4, 2, device="meta"))
