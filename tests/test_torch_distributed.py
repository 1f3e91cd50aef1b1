"""In-process data-parallel sharding of the port's streams
(``repro_torch.stream.distributed``), against single-host streams and the
JAX reference's sharded runs.

Sketches (and Ω_test) are drawn by the reference and handed across
through numpy. Fixed-index streams: the merged C and R equal the
single-host ones bit for bit (disjoint writes into zeros), M within the
reference's own tolerances (its sums in another order). Adaptive streams:
every worker admits into its own slot range, so the merged index sets
must equal the reference's sharded run's, and the reference's quality
claims must hold.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.svd import sp_svd_init as j_svd_init  # noqa: E402
from repro.cur import streaming_cur_init as j_fixed_init  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.spsd import adaptive_spsd_init as j_aspsd_init  # noqa: E402
from repro.spsd import streaming_spsd_init as j_spsd_init  # noqa: E402
from repro.stream import adaptive_cur_init as j_adaptive_init  # noqa: E402
from repro.stream import shard_panel_ranges as j_ranges  # noqa: E402
from repro.stream import simulate_sharded_stream as j_simulate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.svd import sp_svd_finalize, sp_svd_init  # noqa: E402
from repro_torch.cur import (adaptive_cur_finalize, adaptive_cur_init,  # noqa: E402
                             cur_relative_error, streaming_cur_finalize, streaming_cur_init)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.obs import MetricsRegistry, set_registry, telemetry_summary  # noqa: E402
from repro_torch.spsd import (adaptive_spsd_finalize, adaptive_spsd_init,  # noqa: E402
                              spsd_error_ratio, streaming_spsd_finalize, streaming_spsd_init)
from repro_torch.stream import (fresh_state, merge_states, shard_panel_ranges,  # noqa: E402
                                simulate_sharded_stream, stream_panels)

SIZES = dict(c=24, r=24, c0=72, r0=72, s_c=72, s_r=72)
M, N = 220, 180


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _same_indices(pst, jst):
    for name in ("col_idx", "row_idx"):
        if hasattr(jst.ctx, name):
            assert np.array_equal(getattr(pst.ctx, name).numpy(), _np(getattr(jst.ctx, name))), \
                (name, getattr(pst.ctx, name).tolist(), _np(getattr(jst.ctx, name)).tolist())


_CACHE = {}


def _powerlaw():
    if "A" not in _CACHE:
        _CACHE["A"] = _np(jdata.powerlaw_matrix(jax.random.key(0), M, N, 1.0))
    return _CACHE["A"]


def test_shard_panel_ranges_match_reference():
    for n, panel, w in [(180, 64, 4), (180, 64, 2), (500, 100, 3), (64, 64, 4), (250, 25, 4)]:
        ranges = shard_panel_ranges(n, panel, w)
        assert ranges == j_ranges(n, panel, w)
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2 and lo % panel == 0


@pytest.mark.parametrize("workers", [2, 4])
def test_sp_svd_sharded_parity(workers):
    """Algorithm 3 sharded against single-host: R (disjoint blocks) bitwise,
    C and M (sums) and the reconstruction within the reference's tolerances."""
    A = _powerlaw()
    jst = j_svd_init(jax.random.key(8), M, N, sizes=SIZES, panel=32)
    sk = convert.spsvd_sketches(jst.ctx, "cpu")

    def init():
        return sp_svd_init(None, M, N, sizes=SIZES, panel=32, sketches=sk, device="cpu")

    single = stream_panels(init(), _t(A), 32)
    shard = simulate_sharded_stream(init(), _t(A), 32, workers)
    assert torch.equal(shard.R, single.R)
    for name in ("C", "M"):
        np.testing.assert_allclose(getattr(shard, name), getattr(single, name), atol=2e-3)
    U1, S1, V1 = sp_svd_finalize(single)
    U2, S2, V2 = sp_svd_finalize(shard)
    np.testing.assert_allclose((U1 * S1[None]) @ V1.T, (U2 * S2[None]) @ V2.T, atol=5e-3)


@pytest.mark.parametrize("workers", [2, 4])
def test_streaming_cur_sharded_parity(workers):
    """Fixed streaming CUR: C and R bitwise against single-host and the
    reference's sharded run; M within 1e-5 of both; U within 2e-3."""
    A = _powerlaw()
    ci = np.array([3, 50, 99, 120, 164, 7, 31, 88])
    ri = np.array([1, 20, 45, 80, 111, 150, 190, 210])
    j_init = lambda: j_fixed_init(jax.random.key(10), M, N, jnp.asarray(ci), jnp.asarray(ri),  # noqa: E731
                                  sketch="countsketch", panel=32)
    kw = convert.stream_init_inputs(j_init(), "cpu")
    jsh = j_simulate(j_init(), jnp.asarray(A), 32, workers)

    def init():
        return streaming_cur_init(None, M, N, ci, ri, panel=32, device="cpu", **kw)

    single = stream_panels(init(), _t(A), 32)
    for route in ("chunk", "per-panel"):
        shard = simulate_sharded_stream(init(), _t(A), 32, workers, route=route)
        assert shard.offset == N
        for name in ("C", "R"):
            assert torch.equal(getattr(shard, name), getattr(single, name))
            np.testing.assert_array_equal(getattr(shard, name).numpy(), _np(getattr(jsh, name)))
        for want in (single.M, _np(jsh.M)):
            np.testing.assert_allclose(shard.M, want, rtol=1e-5, atol=1e-5 * float(single.M.abs().max()))
        np.testing.assert_allclose(streaming_cur_finalize(shard).U,
                                   streaming_cur_finalize(single).U, atol=2e-3)


def test_merge_states_is_accumulator_sum():
    """``merge_states`` is the sum of the worker accumulators."""
    A = _t(_powerlaw())
    states = []
    for lo, hi in shard_panel_ranges(N, 32, 3):
        st = sp_svd_init(torch.Generator().manual_seed(8), M, N, sizes=SIZES, panel=32,
                         device="cpu")
        st.offset = lo
        states.append(stream_panels(st, A, 32, stop=hi))
    merged = merge_states(states)
    for name in ("C", "R", "M"):
        want = sum(getattr(s, name) for s in states)
        assert torch.equal(getattr(merged, name), want)
    assert merged.offset == N


def _spiked_adaptive(workers, force=False, m=250):
    """The reference's ``test_adaptive_sharded_still_finds_spikes`` config
    (``force``: Gaussian sketches down the forced kernel route, Route B, at
    a shape of its own so the reference compiles the forced program)."""
    B, pos = jdata.spiked_decay_matrix(jax.random.key(90), m, 200, n_spikes=4)
    ri = _np(jax.random.choice(jax.random.key(91), m, (20,), replace=False))
    kw = dict(sketch="gaussian", s_c=64, s_r=64) if force else dict(sketch="countsketch")
    jst = j_adaptive_init(jax.random.key(92), m, 200, 8, jnp.asarray(ri), panel=25, panel_cap=1,
                          **kw)
    inputs = convert.stream_init_inputs(jst, "cpu")
    jops._FORCE_KERNEL_ROUTE = force
    try:
        jsh = j_simulate(jst, B, 25, workers, jit="per-panel" if force else "scan")
    finally:
        jops._FORCE_KERNEL_ROUTE = False
    pst = adaptive_cur_init(None, m, 200, 8, ri, panel=25, panel_cap=1, device="cpu",
                            **{**kw, **inputs})
    tops._FORCE_KERNEL_ROUTE = force
    try:
        psh = simulate_sharded_stream(pst, _t(B), 25, workers)
    finally:
        tops._FORCE_KERNEL_ROUTE = False
    return _np(B), _np(pos), jsh, psh


@pytest.mark.parametrize("workers", [2, 4])
def test_adaptive_sharded_matches_reference_and_finds_spikes(workers):
    B, pos, jsh, psh = _spiked_adaptive(workers)
    _same_indices(psh, jsh)
    res = adaptive_cur_finalize(psh)
    missed = set(pos.tolist()) - set(res.col_idx.tolist())
    assert len(missed) <= 1, (res.col_idx.tolist(), pos.tolist())
    assert float(cur_relative_error(torch.from_numpy(B), res)) < 0.5
    assert int(psh.ctx.n_filled) == int(jsh.ctx.n_filled) and psh.ctx.slot_lo == 0
    np.testing.assert_allclose(psh.ctx.ScC, _np(jsh.ctx.ScC), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("workers", [2, 4])
def test_kernel_route_admits_within_each_workers_slot_range(workers):
    """Route B sharded: kernel 3's plain version takes ``free = slot_lo +
    c_local − n_filled``; every admitted slot lies in its worker's range and
    holds a column of that worker's panels; indices equal the reference's
    sharded run down its forced kernel route (interpret mode)."""
    B, _, jsh, psh = _spiked_adaptive(workers, force=True, m=176)
    _same_indices(psh, jsh)
    ranges = shard_panel_ranges(200, 25, workers)
    per = 8 // workers
    idx = psh.ctx.col_idx.tolist()
    assert sum(i >= 0 for i in idx) > 0
    for slot, col in enumerate(idx):
        if col >= 0:
            lo, hi = ranges[slot // per]
            assert lo <= col < hi, (slot, col, ranges)
    for slot, col in enumerate(idx):  # C holds the admitted columns in their slots
        if col >= 0:
            assert torch.equal(psh.C[:, slot], torch.from_numpy(B[:, col]))


@pytest.mark.parametrize("workers", [2, 4])
def test_v2_sharded_parity_eviction_and_rows(workers):
    """Eviction and adaptive rows, sharded: index sets equal the reference's
    sharded run; a finite factorisation that keeps the planted rows."""
    A, rpos = jdata.spiked_rows_matrix(jax.random.key(180), 300, 240)
    kw = dict(r=8, sketch="countsketch", panel=20, panel_cap=1, panel_cap_rows=1, swap_gain=2.0)
    jst = j_adaptive_init(jax.random.key(181), 300, 240, 8, None, **kw)
    inputs = convert.stream_init_inputs(jst, "cpu")
    jsh = j_simulate(jst, A, 20, workers)
    psh = simulate_sharded_stream(adaptive_cur_init(None, 300, 240, 8, None, device="cpu",
                                                    **inputs, **kw), _t(A), 20, workers)
    _same_indices(psh, jsh)
    assert int(psh.ctx.n_evicted) == int(jsh.ctx.n_evicted)
    assert int(psh.ctx.rows.n_filled) == int(jsh.ctx.rows.n_filled)
    res = adaptive_cur_finalize(psh)
    err = float(cur_relative_error(_t(A), res))
    assert np.isfinite(err) and err < 1.0, err
    missed = set(_np(rpos).tolist()) - set(res.row_idx.tolist())
    assert len(missed) <= 2
    filled = res.col_idx[res.col_idx >= 0]
    assert len(torch.unique(filled)) == len(filled)
    assert float(np.linalg.norm(res.R.numpy() - _np(jsh.R)[:, :240])) <= \
        1e-4 * float(np.linalg.norm(_np(jsh.R)))


def test_cross_worker_row_dedup():
    """Two workers admit the same heavy rows; the merge keeps the lowest slot
    with the union of both workers' columns (the whole row) and frees the
    duplicate, as the reference does."""
    m, n, panel = 200, 240, 40
    A = 0.02 * jax.random.normal(jax.random.key(400), (m, n))
    A = A.at[77, :].add(8.0 * jax.random.normal(jax.random.key(401), (n,)))
    A = A.at[131, :].add(5.0 * jax.random.normal(jax.random.key(402), (n,)))
    kw = dict(r=4, sketch="countsketch", panel=panel, panel_cap=1, panel_cap_rows=1)
    jst = j_adaptive_init(jax.random.key(403), m, n, 6, None, **kw)
    inputs = convert.stream_init_inputs(jst, "cpu")
    jsh = j_simulate(jst, A, panel, 2)
    for route in ("chunk", "per-panel"):
        st = simulate_sharded_stream(adaptive_cur_init(None, m, n, 6, None, device="cpu",
                                                       **inputs, **kw), _t(A), panel, 2,
                                     route=route)
        _same_indices(st, jsh)
        np.testing.assert_array_equal(st.ctx.rows.admit_off.numpy(), _np(jsh.ctx.rows.admit_off))
        res = adaptive_cur_finalize(st)
        idx = res.row_idx.numpy()
        filled = idx[idx >= 0]
        assert len(np.unique(filled)) == len(filled) and {77, 131} <= set(filled.tolist())
        slot = int(np.where(idx == 77)[0][0])
        np.testing.assert_allclose(res.R[slot].numpy(), _np(A)[77], atol=1e-5)
        unfilled = idx == -1
        assert unfilled.any() and not res.R[unfilled].any() and not res.U[:, unfilled].any()
        assert int(st.ctx.rows.n_filled) == len(filled)
        assert bool(torch.isfinite(res.U).all())


def test_v2_shard_budget_must_divide():
    st = adaptive_cur_init(torch.Generator().manual_seed(0), 100, 120, 10, None, r=6,
                           sketch="countsketch", panel=20, device="cpu")
    with pytest.raises(ValueError, match="row budget"):
        simulate_sharded_stream(st, torch.zeros((100, 120)), 20, 5)
    with pytest.raises(ValueError, match="column budget"):
        simulate_sharded_stream(st, torch.zeros((100, 120)), 20, 3)


_SPIKES = (17, 60, 133, 201)
NK = 240


def _kernel_matrix():
    if "K" not in _CACHE:
        base = 0.01 * jax.random.normal(jax.random.key(0), (NK, 64))
        K = base @ base.T + 0.001 * jnp.eye(NK)
        for i, p in enumerate(_SPIKES):
            v = jnp.zeros((NK,)).at[p].set(1.0) + 0.05 * jax.random.normal(
                jax.random.key(10 + i), (NK,))
            K = K + 9.0 * jnp.outer(v, v)
        _CACHE["K"] = _np(K).astype(np.float32)
    return _CACHE["K"]


@pytest.mark.parametrize("workers", [2, 4])
def test_streaming_spsd_sharded_parity(workers):
    """Tied-operand fixed stream on the reference test's leverage sampling
    pair: C bitwise against single-host and the reference's sharded run, X
    within the reference's 2e-5."""
    from repro.spsd import leverage_sampling_sketches

    K = _kernel_matrix()
    # the reference test's shared pieces: 20 columns and a leverage sampling pair
    idx = jax.random.choice(jax.random.key(4), NK, (20,), replace=False).astype(jnp.int32)
    pair = leverage_sampling_sketches(jax.random.key(5), jnp.take(jnp.asarray(K), idx, axis=1), 120)
    jst = j_spsd_init(jax.random.key(8), NK, idx, sketches=pair, panel=40)
    kw = convert.stream_init_inputs(jst, "cpu")
    idx = _np(idx)
    jsh = j_simulate(jst, jnp.asarray(K), 40, workers)

    def init():
        return streaming_spsd_init(None, NK, idx, panel=40, device="cpu", **kw)

    single = stream_panels(init(), _t(K), 40)
    shard = simulate_sharded_stream(init(), _t(K), 40, workers)
    assert torch.equal(shard.C, single.C)
    np.testing.assert_array_equal(shard.C.numpy(), _np(jsh.C))
    np.testing.assert_allclose(streaming_spsd_finalize(shard).X,
                               streaming_spsd_finalize(single).X, atol=2e-5)


@pytest.mark.parametrize("workers", [2, 4])
def test_adaptive_spsd_sharded_matches_reference(workers):
    """Adaptive SPSD sharded (slot ranges on the symmetric engine): index
    sets equal the reference's sharded run; it still finds the spikes."""
    K = _kernel_matrix()
    jst = j_aspsd_init(jax.random.key(16), NK, 8, s=96, panel=40, panel_cap=1)
    kw = convert.stream_init_inputs(jst, "cpu")
    jsh = j_simulate(jst, jnp.asarray(K), 40, workers)
    psh = simulate_sharded_stream(adaptive_spsd_init(None, NK, 8, panel=40, panel_cap=1,
                                                     device="cpu", **kw), _t(K), 40, workers)
    _same_indices(psh, jsh)
    res = adaptive_spsd_finalize(psh)
    assert len(set(_SPIKES) - set(res.col_idx.tolist())) <= 1
    assert float(spsd_error_ratio(_t(K), res)) < 0.1


def _fixed_tel(kw):
    ci = np.array([3, 17, 40, 63, 77, 90, 101, 120, 150, 170])
    ri = np.array([5, 12, 30, 44, 61, 80, 99, 140])
    return streaming_cur_init(None, M, N, ci, ri, panel=32, telemetry=True, device="cpu", **kw)


@pytest.mark.parametrize("workers", [2, 4])
def test_sharded_telemetry_merges_to_single_stream(workers):
    """Worker frames merge by summation: the fixed frame's counters equal
    the single stream's bit for bit (global formulas, disjoint panel
    writes), its scores and Ψ within 1e-5; the adaptive merged totals equal
    the merged counters and the reference's sharded frame's counters, and
    its Ψ is A·Ω_test within 1e-5."""
    A = _powerlaw()
    ci = jnp.asarray([3, 17, 40, 63, 77, 90, 101, 120, 150, 170], jnp.int32)
    ri = jnp.asarray([5, 12, 30, 44, 61, 80, 99, 140], jnp.int32)
    jst = j_fixed_init(jax.random.key(2), M, N, ci, ri, sketch="countsketch", panel=32,
                       telemetry=True)
    kw = convert.stream_init_inputs(jst, "cpu")
    single = stream_panels(_fixed_tel(kw), _t(A), 32)
    shard = simulate_sharded_stream(_fixed_tel(kw), _t(A), 32, workers)
    for name in ("admitted", "occupancy", "events", "panels_seen", "evicted", "rows_admitted"):
        assert torch.equal(getattr(shard.tel, name), getattr(single.tel, name)), name
    for name in ("panel_scores", "panel_energy", "energy_mass", "psi"):
        np.testing.assert_allclose(getattr(shard.tel, name), getattr(single.tel, name), rtol=1e-5,
                                   atol=1e-5 * float(getattr(single.tel, name).abs().max()))
    want = A.astype(np.float64) @ shard.tel.omega[:N].numpy().astype(np.float64)
    assert np.linalg.norm(shard.tel.psi.numpy() - want) <= 1e-5 * np.linalg.norm(want)
    assert torch.equal(shard.tel.omega, single.tel.omega)

    kw_a = dict(r=8, sketch="countsketch", panel=32, panel_cap=1, panel_cap_rows=1,
                swap_gain=2.0, telemetry=True)
    ja = j_adaptive_init(jax.random.key(3), M, N, 8, None, **kw_a)
    inputs = convert.stream_init_inputs(ja, "cpu")
    jsh = j_simulate(ja, jnp.asarray(A), 32, workers)
    st = simulate_sharded_stream(adaptive_cur_init(None, M, N, 8, None, device="cpu", **inputs,
                                                   **kw_a), _t(A), 32, workers)
    s = telemetry_summary(st)
    assert s["total_admitted"] == int(st.ctx.n_filled)
    ref = convert.telemetry_frame(jsh.tel, "cpu")
    for name in ("admitted", "evicted", "rows_admitted", "occupancy", "events", "panels_seen"):
        assert torch.equal(getattr(st.tel, name), getattr(ref, name)), name
    # Ψ against A·Ω_test: the reference's sharded adaptive Ψ leaves out the
    # panels of a worker whose range is one panel (its fused program steps
    # that panel without the Ψ fold), as at W = 4 here
    want = A.astype(np.float64) @ st.tel.omega[:N].numpy().astype(np.float64)
    assert np.linalg.norm(st.tel.psi.numpy() - want) <= 1e-5 * np.linalg.norm(want)


def test_sharded_run_needs_a_fresh_state_and_leaves_it_unchanged():
    """A state with ``offset != 0`` is refused; a sharded run leaves
    ``state0``'s accumulators, ctx tensors and frame as they were, and
    ``fresh_state`` shares only the sketches (and Ω_test)."""
    A = _t(_spiked_adaptive_data())
    g = torch.Generator().manual_seed(7)
    st0 = adaptive_cur_init(g, 120, 160, 8, None, r=8, sketch="countsketch", panel=20,
                            panel_cap=1, panel_cap_rows=1, swap_gain=2.0, telemetry=True,
                            device="cpu")
    snap = _tensors(st0)
    merged = simulate_sharded_stream(st0, A, 20, 4)
    after = _tensors(st0)
    assert snap.keys() == after.keys()
    for k in snap:
        assert torch.equal(snap[k], after[k]), k
    assert st0.offset == 0 and st0.ctx.c_local == 8 and int((merged.ctx.col_idx >= 0).sum()) > 0
    copy = fresh_state(st0)
    assert copy.ctx.S_C is st0.ctx.S_C and copy.tel.omega is st0.tel.omega
    assert copy.ctx.rows.sr_dense is st0.ctx.rows.sr_dense
    assert copy.C is not st0.C and copy.ctx.ScC is not st0.ctx.ScC
    assert copy.ctx.rows.row_sketch is not st0.ctx.rows.row_sketch
    assert copy.tel.psi is not st0.tel.psi
    moved = stream_panels(fresh_state(st0), A, 20, stop=40)
    with pytest.raises(ValueError, match="fresh state"):
        simulate_sharded_stream(moved, A, 20, 2)


def test_sharded_span_is_recorded():
    prev = set_registry(MetricsRegistry())
    try:
        st = streaming_cur_init(torch.Generator().manual_seed(0), M, N, np.arange(8),
                                np.arange(8), panel=32, device="cpu")
        simulate_sharded_stream(st, _t(_powerlaw()), 32, 2)
        from repro_torch.obs import default_registry

        names = [s.name for s in default_registry().spans]
    finally:
        set_registry(prev)
    assert "stream/streaming_cur/sharded_simulate" in names
    assert names.count("stream/streaming_cur/scan") == 2


def _spiked_adaptive_data():
    return _np(jdata.spiked_decay_matrix(jax.random.key(5), 120, 160)[0])


def _tensors(state, prefix="", out=None):
    """Every tensor reachable from a state (sketches included), by path."""
    out = {} if out is None else out
    if torch.is_tensor(state):
        out[prefix] = state.clone()
    elif dataclasses.is_dataclass(state) and not isinstance(state, type):
        for f in dataclasses.fields(state):
            if f.name != "ops":
                _tensors(getattr(state, f.name), f"{prefix}.{f.name}", out)
    return out
