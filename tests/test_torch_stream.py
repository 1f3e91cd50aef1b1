"""Streaming CUR, fixed and adaptive: the port against the JAX reference.

Both packages stream the same matrix with the same sketches (drawn by the
reference, handed across through numpy). Index sets must be equal, C and R
bitwise (they are copies of A's entries), M and ``ScC`` within 1e-5
relative (the same fp32 terms, possibly summed in another order) and U
within 1e-4 relative (different LAPACK QR behind the core solve). The
matrices carry white noise on top of the reference's generators so the
core solves are well conditioned and the admissions have a clear margin.
Within the port, the ``"chunk"`` and ``"per-panel"`` routes agree bitwise
for CountSketch/OSNAP and within 1e-6 for Gaussian sketches.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cur.cur import cur_relative_error as j_rel_err  # noqa: E402
from repro.cur.streaming import streaming_cur_finalize as j_fixed_fin  # noqa: E402
from repro.cur.streaming import streaming_cur_init as j_fixed_init  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.stream.adaptive import adaptive_cur_finalize as j_fin  # noqa: E402
from repro.stream.adaptive import adaptive_cur_init as j_init  # noqa: E402
from repro.stream.engine import stream_panels as j_stream  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.cur import cur_relative_error, streaming_cur_finalize, streaming_cur_init  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.stream.adaptive import adaptive_cur_finalize, adaptive_cur_init  # noqa: E402
from repro_torch.stream.engine import stream_panels  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _to_port(kind, S):
    if kind == "gaussian":
        return convert.sketch_from_arrays(kind, {"mat": np.asarray(S.mat)}, "cpu")
    arrays = {"hashes": np.asarray(S.hashes), "signs": np.asarray(S.signs), "s": S.s}
    return convert.sketch_from_arrays(kind, arrays, "cpu")


def _noisy(A, seed, noise=0.3):
    A = np.asarray(A)
    return (A + noise * np.random.default_rng(seed).standard_normal(A.shape)).astype(np.float32)


def _margin_report(ref_ctx, port_ctx, name):
    """What to print when an index set differs: the flipped entries and the
    retained scores both sides gave them (the margin of the decision)."""
    want, got = np.asarray(getattr(ref_ctx, name)), getattr(port_ctx, name).numpy()
    diff = np.nonzero(want != got)[0]
    msg = f"{name} differs at slots {diff.tolist()}: reference {want[diff].tolist()}, port {got[diff].tolist()}"
    if name == "col_idx":
        msg += (f"; retained scores reference {np.asarray(ref_ctx.slot_score)[diff].tolist()}, "
                f"port {port_ctx.slot_score[diff].tolist()}")
    return msg


def _check_against_reference(jst, jres, pst, pres, u_tol=1e-4):
    for name in ("col_idx", "row_idx"):
        assert np.array_equal(np.asarray(getattr(jst.ctx, name)), getattr(pst.ctx, name).numpy()), \
            _margin_report(jst.ctx, pst.ctx, name)
    np.testing.assert_array_equal(pres.C.numpy(), np.asarray(jres.C))
    np.testing.assert_array_equal(pres.R.numpy(), np.asarray(jres.R))
    assert _rel(pst.M, jst.M) < 1e-5
    if hasattr(jst.ctx, "ScC"):
        assert _rel(pst.ctx.ScC, jst.ctx.ScC) < 1e-5
    if u_tol is not None:
        assert _rel(pres.U, jres.U) < u_tol


def _check_routes(a, b, kind):
    for x, y in ((a.C, b.C), (a.R, b.R), (a.ctx.col_idx, b.ctx.col_idx),
                 (a.ctx.row_idx, b.ctx.row_idx)):
        assert torch.equal(x, y)
    if kind == "gaussian":
        assert _rel(a.M, b.M) < 1e-6
    else:
        assert torch.equal(a.M, b.M)


# One matrix shape for every case, so the reference compiles its programs once.
M_ROWS, N_COLS = 256, 240
ADAPTIVE_CASES = {
    "countsketch-admission": dict(data="spiked", kw=dict(c=10, sketch="countsketch",
                                  panel_cap=3), panel=40),
    "gaussian-kernel-route": dict(data="spiked", kw=dict(c=8, sketch="gaussian",
                                  s_c=64, s_r=64, panel_cap=2), panel=40, force=True),
    "osnap-admission": dict(data="spiked", kw=dict(c=10, sketch="osnap", panel_cap=3), panel=40),
    "eviction": dict(data="late", kw=dict(c=8, sketch="countsketch", panel_cap=4,
                     swap_gain=2.0), panel=40),
    "adaptive-rows": dict(data="rows", kw=dict(c=8, r=8, sketch="countsketch",
                          panel_cap=2, panel_cap_rows=1, swap_gain=2.0), panel=40),
    "ragged-tail": dict(data="spiked", kw=dict(c=10, sketch="countsketch", panel_cap=2),
                        panel=64),  # 240 = 3·64 + a 48-column tail
}


def _data(kind, seed):
    key = jax.random.key(seed)
    if kind == "spiked":
        A = jdata.spiked_decay_matrix(key, M_ROWS, N_COLS, n_spikes=12)[0]
    elif kind == "late":
        A = jdata.late_spike_matrix(key, M_ROWS, N_COLS)[0]
    else:
        A = jdata.spiked_rows_matrix(key, M_ROWS, N_COLS)[0]
    return _noisy(A, seed)


@pytest.mark.parametrize("case", list(ADAPTIVE_CASES))
def test_adaptive_cur_matches_reference(case):
    cfg = ADAPTIVE_CASES[case]
    A = _data(cfg["data"], 300)
    m, n = A.shape
    kw = dict(cfg["kw"])
    c = kw.pop("c")
    panel = cfg["panel"]
    adaptive_rows = "r" in kw
    row_idx = None if adaptive_rows else np.random.default_rng(7).choice(m, 12, replace=False)
    jst = j_init(jax.random.key(5), m, n, c, None if adaptive_rows else jnp.asarray(row_idx),
                 panel=panel, **kw)
    sketches = (_to_port(kw["sketch"], jst.ctx.S_C),
                _to_port(kw["sketch"], jst.ctx.S_R.cols(0, n)))
    force = cfg.get("force", False)
    jops._FORCE_KERNEL_ROUTE = force
    try:
        jst = j_stream(jst, jnp.asarray(A), panel)
    finally:
        jops._FORCE_KERNEL_ROUTE = False
    jres = j_fin(jst)

    states = {}
    tops._FORCE_KERNEL_ROUTE = force
    try:
        for route in ("chunk", "per-panel"):
            pst = adaptive_cur_init(
                None, m, n, c, None if adaptive_rows else convert.indices(row_idx, "cpu"),
                panel=panel, sketches=sketches, device="cpu", **kw)
            states[route] = stream_panels(pst, torch.from_numpy(A), panel, route=route)
    finally:
        tops._FORCE_KERNEL_ROUTE = False
    for route, pst in states.items():
        _check_against_reference(jst, jres, pst, adaptive_cur_finalize(pst))
    _check_routes(states["chunk"], states["per-panel"], kw["sketch"])
    assert int(states["chunk"].ctx.n_filled) == int(jst.ctx.n_filled)
    assert int(states["chunk"].ctx.n_evicted) == int(jst.ctx.n_evicted)
    if kw.get("swap_gain") is not None and not adaptive_rows:
        assert int(jst.ctx.n_evicted) > 0  # the eviction path really ran


def test_adaptive_spiked_columns_config_matches_reference_output():
    """The configuration of the reference's ``test_adaptive_admits_spiked_columns``
    (which fails against its own assertion): the port must reproduce what
    the reference actually outputs, not that assertion. U is not compared:
    the fixed rows drawn from the background make ``R S_Rᵀ`` ill-conditioned
    (condition number ~1e5), so the two QR routines' last bits are amplified."""
    from repro.cur.selection import select_rows

    B, _ = jdata.spiked_decay_matrix(jax.random.key(20), 250, 200)
    ri = select_rows(jax.random.key(21), B, 20, "uniform").idx
    jst = j_init(jax.random.key(22), 250, 200, 10, ri, sketch="countsketch", panel=40, panel_cap=3)
    sketches = (_to_port("countsketch", jst.ctx.S_C), _to_port("countsketch", jst.ctx.S_R))
    jst = j_stream(jst, B, 40)
    jres = j_fin(jst)
    pst = adaptive_cur_init(None, 250, 200, 10, convert.indices(ri, "cpu"), sketch="countsketch",
                            panel=40, panel_cap=3, sketches=sketches, device="cpu")
    pst = stream_panels(pst, torch.from_numpy(np.array(B)), 40)
    _check_against_reference(jst, jres, pst, adaptive_cur_finalize(pst), u_tol=None)


def _bf16_state_kernel_route(monkeypatch, A):
    """Stream ``A`` through an admission-only Gaussian adaptive CUR whose
    state (C, M, ``ScC``) is bf16, down the forced kernel route on both
    sides: the reference's ``panel_update`` in interpret mode against the
    port's plain versions, on sketches drawn by the reference. Every panel
    of the port must go through ``ops.panel_update``. Index sets and C
    (copies of A's entries) must be equal; M within 4e-3 relative, one bf16
    rounding step (bf16 accumulators round each panel's fp32 fold, whose
    sums, taken in another order, may round the other way), and U within
    1e-3 (a solve on those factors)."""
    m, n = A.shape
    row_idx = np.random.default_rng(8).choice(m, 12, replace=False)
    kw = dict(sketch="gaussian", s_c=64, s_r=64, panel_cap=2)
    jst = j_init(jax.random.key(6), m, n, 8, jnp.asarray(row_idx), panel=40,
                 dtype=jnp.bfloat16, **kw)
    # a bf16 draw comes out float32: the reference's 1/√s scale promotes
    assert jst.ctx.S_C.mat.dtype == jnp.float32 and jst.M.dtype == jnp.bfloat16
    sketches = (_to_port("gaussian", jst.ctx.S_C), _to_port("gaussian", jst.ctx.S_R.cols(0, n)))
    calls = []
    kernel_3 = tops.panel_update
    monkeypatch.setattr(tops, "panel_update", lambda *a, **k: calls.append(a) or kernel_3(*a, **k))
    jops._FORCE_KERNEL_ROUTE = True
    tops._FORCE_KERNEL_ROUTE = True
    try:
        jst = j_stream(jst, jnp.asarray(A), 40)
        pst = adaptive_cur_init(None, m, n, 8, convert.indices(row_idx, "cpu"), panel=40,
                                sketches=sketches, device="cpu", dtype=torch.bfloat16, **kw)
        pst = stream_panels(pst, convert.to_tensor(A, "cpu"), 40)
    finally:
        jops._FORCE_KERNEL_ROUTE = False
        tops._FORCE_KERNEL_ROUTE = False
    assert len(calls) == -(-n // 40)
    jres, pres = j_fin(jst), adaptive_cur_finalize(pst)
    assert pst.C.dtype == pst.M.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(jst.ctx.col_idx), pst.ctx.col_idx.numpy()), \
        _margin_report(jst.ctx, pst.ctx, "col_idx")
    assert int((pst.ctx.col_idx >= 0).sum()) > 0
    np.testing.assert_array_equal(pres.C.float().numpy(), np.asarray(jres.C.astype(jnp.float32)))
    assert _rel(pst.M.float(), jst.M.astype(jnp.float32)) < 4e-3
    assert _rel(pres.U.float(), jres.U.astype(jnp.float32)) < 1e-3
    return calls


def test_adaptive_bf16_gaussian_kernel_route_matches_reference(monkeypatch):
    """A bf16 stream: each panel update takes a float32 sketch with a bf16
    panel and bf16 C and M (see :func:`_bf16_state_kernel_route`)."""
    calls = _bf16_state_kernel_route(monkeypatch, _data("spiked", 303).astype(jnp.bfloat16))
    assert {(a[0].dtype, a[1].dtype, a[4].dtype) for a in calls} == \
        {(torch.float32, torch.bfloat16, torch.bfloat16)}


def test_adaptive_fp32_stream_bf16_state_kernel_route_matches_reference(monkeypatch):
    """An fp32 stream with bf16 state: each panel update takes a float32
    sketch and panel with bf16 C and M, which kernel 3 takes too (see
    :func:`_bf16_state_kernel_route`)."""
    calls = _bf16_state_kernel_route(monkeypatch, _data("spiked", 303))
    assert {(a[0].dtype, a[1].dtype, a[4].dtype) for a in calls} == \
        {(torch.float32, torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("kind,n,panel", [("countsketch", 240, 40), ("osnap", 250, 64),
                                           ("gaussian", 250, 64)])  # 250 = 3·64 + 58
def test_fixed_streaming_cur_matches_reference(kind, n, panel):
    m = 200
    rng = np.random.default_rng(n)
    A = (rng.standard_normal((m, 12)) @ rng.standard_normal((12, n))
         + 0.3 * rng.standard_normal((m, n))).astype(np.float32)
    ci = rng.choice(n, 10, replace=False)
    ri = rng.choice(m, 10, replace=False)
    jst = j_fixed_init(jax.random.key(9), m, n, jnp.asarray(ci), jnp.asarray(ri), sketch=kind,
                       s_c=80, s_r=80, panel=panel)
    sketches = (_to_port(kind, jst.ctx.S_C), _to_port(kind, jst.ctx.S_R.cols(0, n)))
    jst = j_stream(jst, jnp.asarray(A), panel)
    jres = j_fixed_fin(jst)
    states = {}
    for route in ("chunk", "per-panel"):
        pst = streaming_cur_init(None, m, n, ci, ri, panel=panel, sketches=sketches, device="cpu")
        states[route] = stream_panels(pst, torch.from_numpy(A), panel, route=route)
        _check_against_reference(jst, jres, states[route], streaming_cur_finalize(states[route]))
    _check_routes(states["chunk"], states["per-panel"], kind)
    got = float(cur_relative_error(torch.from_numpy(A), streaming_cur_finalize(states["chunk"])))
    assert abs(got - float(j_rel_err(jnp.asarray(A), jres))) < 1e-4


@pytest.mark.parametrize("kind", ["countsketch", "osnap"])
def test_fixed_streaming_resumed_off_the_panel_grid_matches_reference(kind):
    """A stream the engine takes in two calls of different panel widths:
    the first call's windows take their slices of S_R's indexed window
    orders, the second call's windows (off its 40-wide grid) sort their
    own. Indices equal, C and R bitwise and M within 1e-5 of the
    reference's single run; and C, R equal to the port's own run in one
    width (M folds its panels in other groups there: within 1e-6)."""
    m, n = 200, 230
    rng = np.random.default_rng(n)
    A = (rng.standard_normal((m, 12)) @ rng.standard_normal((12, n))
         + 0.3 * rng.standard_normal((m, n))).astype(np.float32)
    ci = rng.choice(n, 10, replace=False)
    ri = rng.choice(m, 10, replace=False)
    jst = j_fixed_init(jax.random.key(4), m, n, jnp.asarray(ci), jnp.asarray(ri), sketch=kind,
                       s_c=80, s_r=80, panel=10)
    sketches = (_to_port(kind, jst.ctx.S_C), _to_port(kind, jst.ctx.S_R.cols(0, n)))
    jst = j_stream(jst, jnp.asarray(A), 10)
    jres = j_fixed_fin(jst)
    At = torch.from_numpy(A)
    pst = streaming_cur_init(None, m, n, ci, ri, panel=10, sketches=sketches, device="cpu")
    pst = stream_panels(pst, At, 10, stop=30, route="per-panel")
    assert 10 in pst.ctx.S_R.parts()[0]._windows if kind == "osnap" else 10 in pst.ctx.S_R._windows
    pst = stream_panels(pst, At, 40, route="per-panel")  # offsets 30, 70, ...: off the grid
    assert pst.offset == n
    _check_against_reference(jst, jres, pst, streaming_cur_finalize(pst))
    one = streaming_cur_init(None, m, n, ci, ri, panel=10, sketches=sketches, device="cpu")
    one = stream_panels(one, At, 10, route="per-panel")
    assert torch.equal(pst.C, one.C) and torch.equal(pst.R, one.R)
    assert _rel(pst.M, one.M) < 1e-6


def test_port_generators_and_draws_run_end_to_end():
    """The port's own generators and sketch draws (no reference arrays):
    adaptive CUR on a drifting spectrum finishes finite with distinct,
    in-range indices."""
    A, bounds = tdata.drifting_spectrum_matrix(0, 128, 256, device="cpu")
    assert bounds.tolist() == [0, 64, 128, 192, 256]
    g = torch.Generator().manual_seed(1)
    st = adaptive_cur_init(g, 128, 256, 8, torch.arange(8), sketch="countsketch", panel=64,
                           device="cpu")
    res = adaptive_cur_finalize(stream_panels(st, A, 64))
    idx = res.col_idx[res.col_idx >= 0]
    assert len(set(idx.tolist())) == len(idx) and int(idx.max()) < 256
    assert torch.isfinite(res.U).all()
    for make in (tdata.spiked_decay_matrix, tdata.spiked_rows_matrix):
        assert make(2, 64, 48, device="cpu")[0].shape == (64, 48)
    assert tdata.late_spike_matrix(3, 64, 100, device="cpu")[0].shape == (64, 100)
    assert tdata.lowrank_plus_noise(4, 32, 40, device="cpu").shape == (32, 40)
    assert tdata.powerlaw_matrix(5, 32, 40, device="cpu").shape == (32, 40)


def test_quarantine_zero_scales_a_nonfinite_panel():
    """An armed guard makes a NaN panel contribute exactly what a zero panel
    would, and counts it; the chunk route steps aside for the guard."""
    from repro_torch.stream.engine import with_quarantine

    A = _data("spiked", 301)
    bad = A.copy()
    bad[5, 40:80] = np.nan  # panel 1 of width 40
    zeroed = A.copy()
    zeroed[:, 40:80] = 0.0
    rows = np.arange(12)

    def run(X, guard):
        st = adaptive_cur_init(torch.Generator().manual_seed(3), M_ROWS, N_COLS, 8, rows,
                               s_c=48, s_r=48, panel=40, device="cpu")
        if guard:
            st = with_quarantine(st)
        return stream_panels(st, torch.from_numpy(X), 40)

    got, want = run(bad, True), run(zeroed, False)
    assert int(got.quarantined) == 1
    for x, y in ((got.C, want.C), (got.R, want.R), (got.M, want.M), (got.ctx.col_idx, want.ctx.col_idx)):
        assert torch.equal(x, y)


def test_uniform_selection_and_exact_cur():
    from repro.cur.cur import exact_cur as j_exact_cur
    from repro_torch.cur import exact_cur, select_columns, select_rows

    A = torch.from_numpy(_data("spiked", 302))
    g = torch.Generator().manual_seed(4)
    ci, ri = select_columns(g, A, 10).idx, select_rows(g, A, 12).idx
    for idx, hi in ((ci, N_COLS), (ri, M_ROWS)):
        assert idx.dtype == torch.int32 and len(set(idx.tolist())) == len(idx) and int(idx.max()) < hi
    with pytest.raises(ValueError):
        select_columns(g, A, N_COLS + 1)
    got = exact_cur(A, ci, ri)
    want = j_exact_cur(jnp.asarray(A.numpy()), jnp.asarray(ci.numpy()), jnp.asarray(ri.numpy()))
    assert _rel(got.U, want.U) < 1e-4
    np.testing.assert_array_equal(got.C.numpy(), np.asarray(want.C))


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError):
        streaming_cur_init(None, 10, 10, [0], [0], sketches=())
    with pytest.raises(RuntimeError):
        adaptive_cur_init(None, 10, 10, 2, [0])
    for make in (tdata.drifting_spectrum_matrix, tdata.lowrank_plus_noise,
                 tdata.spiked_decay_matrix, tdata.spiked_rows_matrix, tdata.powerlaw_matrix):
        with pytest.raises(RuntimeError):
            make(0, 16, 16)
    with pytest.raises(RuntimeError):
        tdata.late_spike_matrix(0, 16, 100)
    with pytest.raises(RuntimeError):
        convert.indices([0, 1])
    st = adaptive_cur_init(torch.Generator(), 16, 16, 2, [0], s_c=8, s_r=8, device="cpu")
    with pytest.raises(ValueError):
        stream_panels(st, torch.zeros(16, 16, device="meta"), 8)
    with pytest.raises(ValueError, match="panel"):  # telemetry needs a panel width
        adaptive_cur_init(torch.Generator(), 16, 16, 2, [0], telemetry=True, device="cpu")


def _banned_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.name}:{node.lineno} imports {name}")
    return bad


def test_port_and_chip_smoke_import_nothing_of_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    covered = {f.relative_to(ROOT / "src" / "repro_torch").parts[0] for f in files}
    assert {"models", "configs", "serve", "launch"} <= covered  # the serving slice's packages
    assert ROOT / "src" / "repro_torch" / "launch" / "serve.py" in files
    files.append(ROOT / "chip_smoke.py")
    assert all(f.exists() for f in files)
    bad = [b for f in files for b in _banned_imports(f)]
    assert not bad, bad
