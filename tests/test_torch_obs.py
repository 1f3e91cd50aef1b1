"""Stream telemetry, the a-posteriori error estimator and the metrics
registry of the port (``repro_torch.obs``), against the JAX reference.

* Factors on and off: C, R, M, U (X for SPSD) and the index sets are the
  same bits with telemetry on or off, on the chunk route (Route A), the
  per-panel route and the forced kernel route (Route B).
* Telemetry off adds nothing: the same calls of every kernel wrapper and
  the same ``torch.profiler`` op names as a state built without the
  argument; on, the wrappers are called as often as off.
* The frame against the reference's, on the reference's sketches and
  Ω_test: per-panel counters and ``events`` equal; ``panel_scores``,
  ``panel_energy`` and ``energy_mass`` within 1e-5 of the reference's,
  relative to each array's largest entry (the same fp32 terms summed in
  another order), and Ψ within 1e-5 relative to its norm.
* The estimator within 1e-4 relative of the reference's on the same Ω_test,
  and within the reference's 2× band of the port's true error.
"""

import collections
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cur import streaming_cur_finalize as j_fixed_fin  # noqa: E402
from repro.cur import streaming_cur_init as j_fixed_init  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.obs import estimate_rel_error as j_estimate  # noqa: E402
from repro.spsd import adaptive_spsd_init as j_aspsd_init  # noqa: E402
from repro.spsd import streaming_spsd_init as j_spsd_init  # noqa: E402
from repro.stream import adaptive_cur_init as j_adaptive_init  # noqa: E402
from repro.stream import stream_panels as j_stream  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.cur import (adaptive_cur_finalize, adaptive_cur_init,  # noqa: E402
                             cur_relative_error, streaming_cur_finalize, streaming_cur_init)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.obs import (EVENT_BUDGET_FULL, EVENT_QUARANTINED, MetricsRegistry,  # noqa: E402
                             default_registry, estimate_rel_error, render_timeline,
                             set_registry, span, telemetry_summary)
from repro_torch.spsd import (adaptive_spsd_finalize, adaptive_spsd_init,  # noqa: E402
                              streaming_spsd_finalize, streaming_spsd_init)
from repro_torch.stream import stream_panels, with_quarantine  # noqa: E402

M, N, PANEL = 160, 128, 32
CI = np.array([3, 17, 40, 63, 77, 90, 101, 120])
RI = np.array([5, 12, 30, 44, 61, 80, 99, 140])
KI = np.array([3, 17, 40, 63, 77, 90, 101, 120])
COUNTERS = ("admitted", "evicted", "rows_admitted", "occupancy", "events", "panels_seen")
FLOATS = ("panel_scores", "panel_energy", "energy_mass")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


_CACHE = {}


def _A():
    if "A" not in _CACHE:
        _CACHE["A"] = np.asarray(jdata.spiked_decay_matrix(jax.random.key(0), M, N)[0])
    return _CACHE["A"]


def _K():
    if "K" not in _CACHE:
        G = np.asarray(jdata.powerlaw_matrix(jax.random.key(8), N, 32, 1.0))
        _CACHE["K"] = (G @ G.T + 0.01 * np.eye(N)).astype(np.float32)
    return _CACHE["K"]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# port configurations on the port's own draws: (init(telemetry), finalize, data)
CONFIGS = {
    "fixed_cur": (lambda tel: streaming_cur_init(
        _gen(2), M, N, CI, RI, sketch="countsketch", panel=PANEL, telemetry=tel, device="cpu"),
        streaming_cur_finalize, _A),
    "adaptive_cur_evict_rows": (lambda tel: adaptive_cur_init(
        _gen(3), M, N, 8, None, r=8, sketch="countsketch", panel=PANEL, panel_cap=1,
        panel_cap_rows=1, swap_gain=2.0, telemetry=tel, device="cpu"), adaptive_cur_finalize, _A),
    "adaptive_cur_countsketch": (lambda tel: adaptive_cur_init(
        _gen(4), M, N, 8, RI, sketch="countsketch", panel=PANEL, panel_cap=2, telemetry=tel,
        device="cpu"), adaptive_cur_finalize, _A),
    "adaptive_cur_gaussian": (lambda tel: adaptive_cur_init(
        _gen(5), M, N, 8, RI, sketch="gaussian", s_c=48, s_r=48, panel=PANEL, panel_cap=2,
        telemetry=tel, device="cpu"), adaptive_cur_finalize, _A),
    "fixed_spsd": (lambda tel: streaming_spsd_init(
        _gen(9), N, KI, s=48, panel=PANEL, telemetry=tel, device="cpu"),
        streaming_spsd_finalize, _K),
    "adaptive_spsd_evict": (lambda tel: adaptive_spsd_init(
        _gen(10), N, 8, s=48, panel=PANEL, panel_cap=2, swap_gain=2.0, telemetry=tel,
        device="cpu"), adaptive_spsd_finalize, _K),
    "adaptive_spsd_gaussian": (lambda tel: adaptive_spsd_init(
        _gen(11), N, 8, s=48, sketch="gaussian", panel=PANEL, panel_cap=2, min_gain=0.01,
        telemetry=tel, device="cpu"), adaptive_spsd_finalize, _K),
}
# Route B (kernel 3 every panel) is forced for the Gaussian admission-only configs
ROUTES = [(c, r) for c in CONFIGS for r in ("chunk", "per-panel")] + [
    ("adaptive_cur_gaussian", "kernel"), ("adaptive_spsd_gaussian", "kernel")]


def _run(make, data, route, tel):
    tops._FORCE_KERNEL_ROUTE = route == "kernel"
    try:
        return stream_panels(make(tel), torch.from_numpy(data()), PANEL,
                             route="per-panel" if route == "per-panel" else "chunk")
    finally:
        tops._FORCE_KERNEL_ROUTE = False


@pytest.mark.parametrize("config,route", ROUTES)
def test_factors_bitwise_identical_on_off(config, route):
    make, fin, data = CONFIGS[config]
    off, on = _run(make, data, route, False), _run(make, data, route, True)
    assert off.tel is None and on.tel is not None
    for x, y in ((off.C, on.C), (off.R, on.R), (off.M, on.M), (off.ctx.col_idx, on.ctx.col_idx)):
        assert torch.equal(x, y)
    r_off, r_on = fin(off), fin(on)
    for name in ("U", "X", "R", "row_idx"):
        if hasattr(r_off, name):
            assert torch.equal(getattr(r_off, name), getattr(r_on, name)), name
    assert int(on.tel.panels_seen) == N // PANEL


def _wrapper_calls(monkeypatch):
    """Count the calls of every kernel wrapper (on the card, each is a launch)."""
    calls = collections.Counter()
    for name in ("countsketch_apply", "countsketch_fold", "panel_score", "panel_update"):
        fn = getattr(tops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tops, name, counted)
    return calls


def _op_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter({e.key: e.count for e in prof.key_averages()})


@pytest.mark.parametrize("config,route", [("fixed_cur", "chunk"), ("adaptive_cur_evict_rows",
                                                                    "chunk"),
                                          ("adaptive_cur_gaussian", "kernel")])
def test_telemetry_off_adds_no_launches_or_ops(monkeypatch, config, route):
    """The port's counterpart of the reference's HLO identity: a state built
    with ``telemetry=False`` runs the same kernel-wrapper calls and the same
    profiler ops as one built without the argument; ``telemetry=True``
    calls every wrapper as often (the frame adds plain torch ops only)."""
    make, _, data = CONFIGS[config]
    calls = _wrapper_calls(monkeypatch)

    def counts(tel):
        calls.clear()
        _run(make, data, route, tel)
        return dict(calls)

    assert counts(False) == counts(True) and sum(counts(False).values()) > 0
    default = {"fixed_cur": lambda: streaming_cur_init(
        _gen(2), M, N, CI, RI, sketch="countsketch", panel=PANEL, device="cpu"),
        "adaptive_cur_evict_rows": lambda: adaptive_cur_init(
            _gen(3), M, N, 8, None, r=8, sketch="countsketch", panel=PANEL, panel_cap=1,
            panel_cap_rows=1, swap_gain=2.0, device="cpu"),
        "adaptive_cur_gaussian": lambda: adaptive_cur_init(
            _gen(5), M, N, 8, RI, sketch="gaussian", s_c=48, s_r=48, panel=PANEL, panel_cap=2,
            device="cpu")}[config]
    A = torch.from_numpy(data())
    tops._FORCE_KERNEL_ROUTE = route == "kernel"
    try:
        states = [default(), make(False), make(True)]
        ops = [_op_names(lambda st=st: stream_panels(st, A, PANEL)) for st in states]
    finally:
        tops._FORCE_KERNEL_ROUTE = False
    assert ops[0] == ops[1]
    assert ops[2] != ops[0] and sum(ops[2].values()) > sum(ops[0].values())


# reference configurations: (reference init, port init taking its sketches and Ω_test, data)
REF_CONFIGS = {
    "fixed_cur": (lambda: j_fixed_init(
        jax.random.key(2), M, N, jnp.asarray(CI), jnp.asarray(RI), sketch="countsketch",
        panel=PANEL, telemetry=True),
        lambda kw: streaming_cur_init(None, M, N, CI, RI, panel=PANEL, telemetry=True,
                                      device="cpu", **kw), _A),
    "adaptive_cur_evict_rows": (lambda: j_adaptive_init(
        jax.random.key(3), M, N, 8, None, r=8, sketch="countsketch", panel=PANEL, panel_cap=1,
        panel_cap_rows=1, swap_gain=2.0, telemetry=True),
        lambda kw: adaptive_cur_init(None, M, N, 8, None, r=8, panel=PANEL, panel_cap=1,
                                     panel_cap_rows=1, swap_gain=2.0, telemetry=True,
                                     device="cpu", **kw), _A),
    "adaptive_cur_countsketch": (lambda: j_adaptive_init(
        jax.random.key(4), M, N, 8, jnp.asarray(RI), sketch="countsketch", panel=PANEL,
        panel_cap=2, telemetry=True),
        lambda kw: adaptive_cur_init(None, M, N, 8, RI, panel=PANEL, panel_cap=2, telemetry=True,
                                     device="cpu", **kw), _A),
    "adaptive_cur_gaussian_route_b": (lambda: j_adaptive_init(
        jax.random.key(5), M, N, 8, jnp.asarray(RI), sketch="gaussian", s_c=48, s_r=48,
        panel=PANEL, panel_cap=2, telemetry=True),
        lambda kw: adaptive_cur_init(None, M, N, 8, RI, panel=PANEL, panel_cap=2, telemetry=True,
                                     device="cpu", **kw), _A),
    "fixed_spsd": (lambda: j_spsd_init(
        jax.random.key(9), N, jnp.asarray(KI), s=48, panel=PANEL, telemetry=True),
        lambda kw: streaming_spsd_init(None, N, KI, panel=PANEL, telemetry=True, device="cpu",
                                       **kw), _K),
    "adaptive_spsd_evict": (lambda: j_aspsd_init(
        jax.random.key(10), N, 8, s=48, panel=PANEL, panel_cap=2, swap_gain=2.0, telemetry=True),
        lambda kw: adaptive_spsd_init(None, N, 8, panel=PANEL, panel_cap=2, swap_gain=2.0,
                                      telemetry=True, device="cpu", **kw), _K),
}


def _check_frame(got, jtel):
    want = convert.telemetry_frame(jtel, "cpu")
    for name in COUNTERS:
        assert torch.equal(getattr(got, name), getattr(want, name)), \
            (name, getattr(got, name).tolist(), getattr(want, name).tolist())
    for name in FLOATS:
        g, w = getattr(got, name).numpy(), getattr(want, name).numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)
    assert _rel(got.psi, want.psi) < 1e-5
    assert torch.equal(got.omega, want.omega)


@pytest.mark.parametrize("config", list(REF_CONFIGS))
def test_frame_and_estimate_match_reference(config):
    j_make, p_make, data = REF_CONFIGS[config]
    jst = j_make()
    kw = convert.stream_init_inputs(jst, "cpu")
    force = config.endswith("route_b")
    jops._FORCE_KERNEL_ROUTE = force
    try:
        jst = j_stream(jst, jnp.asarray(data()), PANEL)
    finally:
        jops._FORCE_KERNEL_ROUTE = False
    routes = ("chunk", "per-panel") if not force else ("kernel",)
    for route in routes:
        tops._FORCE_KERNEL_ROUTE = force
        try:
            pst = stream_panels(p_make(kw), torch.from_numpy(data()), PANEL,
                                route="per-panel" if route == "per-panel" else "chunk")
        finally:
            tops._FORCE_KERNEL_ROUTE = False
        assert np.array_equal(pst.ctx.col_idx.numpy(), np.asarray(jst.ctx.col_idx)), route
        _check_frame(pst.tel, jst.tel)
        est, want = float(estimate_rel_error(pst)), float(j_estimate(jst))
        assert abs(est - want) <= 1e-4 * want, (route, est, want)


def _true_cur_error(A, res, stop=None):
    if stop is None:
        return float(cur_relative_error(torch.from_numpy(A), res))
    ahat = (res.C @ res.U @ res.R).numpy()
    return float(np.linalg.norm(A[:, :stop] - ahat[:, :stop]) / np.linalg.norm(A[:, :stop]))


@pytest.mark.parametrize("family", ["spiked", "late-spike", "drift"])
def test_estimator_within_2x_band(family):
    """The reference's band cases: adaptive CUR with eviction and adaptive
    rows; the port's estimate equals the reference's and lies within 2× of
    the port's true relative error."""
    m, n, panel = 200, 160, 32
    key = jax.random.key({"spiked": 21, "late-spike": 22, "drift": 23}[family])
    make = {"spiked": jdata.spiked_decay_matrix, "late-spike": jdata.late_spike_matrix,
            "drift": jdata.drifting_spectrum_matrix}[family]
    A = np.asarray(make(key, m, n)[0])
    kw = dict(r=12, sketch="countsketch", panel=panel, panel_cap=2, panel_cap_rows=2,
              swap_gain=2.0, telemetry=True)
    jst = j_adaptive_init(jax.random.key(24), m, n, 12, None, **kw)
    inputs = convert.stream_init_inputs(jst, "cpu")
    jst = j_stream(jst, jnp.asarray(A), panel)
    pst = stream_panels(adaptive_cur_init(None, m, n, 12, None, device="cpu", **inputs, **kw),
                        torch.from_numpy(A), panel)
    est, want = float(estimate_rel_error(pst)), float(j_estimate(jst))
    assert abs(est - want) <= 1e-4 * want, (family, est, want)
    true = _true_cur_error(A, adaptive_cur_finalize(pst))
    assert 0.5 * true <= est <= 2.0 * true, (family, est, true)


def test_estimator_spsd_band():
    n, panel = 192, 32
    G = np.asarray(jdata.powerlaw_matrix(jax.random.key(30), n, 24, 1.0))
    K = (G @ G.T + 0.01 * np.eye(n)).astype(np.float32)
    ki = np.arange(0, n, n // 12)[:12]
    jst = j_spsd_init(jax.random.key(31), n, jnp.asarray(ki), s=64, panel=panel, telemetry=True)
    inputs = convert.stream_init_inputs(jst, "cpu")
    jst = j_stream(jst, jnp.asarray(K), panel)
    pst = stream_panels(streaming_spsd_init(None, n, ki, panel=panel, telemetry=True,
                                            device="cpu", **inputs), torch.from_numpy(K), panel)
    res = streaming_spsd_finalize(pst)
    recon = (res.C @ res.X @ res.C.T).numpy()
    true = float(np.linalg.norm(K - recon) / np.linalg.norm(K))
    est, want = float(estimate_rel_error(pst)), float(j_estimate(jst))
    assert abs(est - want) <= 1e-4 * want, (est, want)
    assert 0.5 * true <= est <= 2.0 * true, (est, true)


def test_estimator_mid_stream_cur():
    """Mid-stream, the CUR estimate covers the columns seen so far."""
    A = _A()
    stop = (N // PANEL) // 2 * PANEL
    j_make, p_make, _ = REF_CONFIGS["fixed_cur"]
    jst = j_make()
    kw = convert.stream_init_inputs(jst, "cpu")
    jst = j_stream(jst, jnp.asarray(A), PANEL, stop=stop)
    pst = stream_panels(p_make(kw), torch.from_numpy(A), PANEL, stop=stop)
    est, want = float(estimate_rel_error(pst)), float(j_estimate(jst))
    assert abs(est - want) <= 1e-4 * want, (est, want)
    true = _true_cur_error(A, streaming_cur_finalize(pst), stop)
    assert 0.5 * true <= est <= 2.0 * true, (est, true)
    res_ref = j_fixed_fin(jst)
    assert _rel(streaming_cur_finalize(pst).U, res_ref.U) < 1e-4


def test_estimator_and_telemetry_require_what_they_need():
    st = stream_panels(CONFIGS["fixed_cur"][0](False), torch.from_numpy(_A()), PANEL)
    with pytest.raises(ValueError, match="telemetry"):
        estimate_rel_error(st)
    with pytest.raises(ValueError, match="telemetry"):
        telemetry_summary(st)
    with pytest.raises(ValueError, match="panel"):
        streaming_cur_init(_gen(0), M, N, CI, RI, telemetry=True, device="cpu")
    with pytest.raises(ValueError, match="panel"):
        adaptive_cur_init(_gen(0), M, N, 8, RI, telemetry=True, device="cpu")
    with pytest.raises(ValueError, match="panel"):
        streaming_spsd_init(_gen(0), N, KI, telemetry=True, device="cpu")
    with pytest.raises(ValueError, match="panel"):
        adaptive_spsd_init(_gen(0), N, 8, telemetry=True, device="cpu")
    with pytest.raises(ValueError, match="omega"):  # pre-drawn sketches and no Ω_test
        streaming_cur_init(None, M, N, CI, RI, panel=PANEL, telemetry=True, device="cpu",
                           sketches=(st.ctx.S_C, st.ctx.S_R))


def test_psi_and_fixed_counters():
    """Ψ equals A·Ω_test in one product, and the fixed frame's counters are
    the static selection's."""
    A = _A()
    st = stream_panels(CONFIGS["fixed_cur"][0](True), torch.from_numpy(A), PANEL)
    want = A.astype(np.float64) @ st.tel.omega[:N].numpy().astype(np.float64)
    assert _rel(st.tel.psi, want) < 1e-5
    s = telemetry_summary(st)
    assert s["total_admitted"] == len(CI) and s["occupancy"][-1] == len(CI)
    assert s["panels_seen"] == N // PANEL and s["energy_mass"] > 0
    assert int(st.tel.events[-1]) & EVENT_BUDGET_FULL


def test_quarantined_panel_flags_and_leaves_psi_finite():
    """A NaN panel under the armed guard sets ``EVENT_QUARANTINED`` in its
    slot, and Ψ is the Ψ of the stream with that panel zeroed, bit for bit."""
    A = _A()
    bad, zeroed = A.copy(), A.copy()
    bad[7, PANEL : 2 * PANEL] = np.nan
    zeroed[:, PANEL : 2 * PANEL] = 0.0
    make = CONFIGS["adaptive_cur_countsketch"][0]
    got = stream_panels(with_quarantine(make(True)), torch.from_numpy(bad), PANEL)
    want = stream_panels(with_quarantine(make(True)), torch.from_numpy(zeroed), PANEL)
    assert int(got.quarantined) == 1 and int(want.quarantined) == 0
    events = got.tel.events.tolist()
    assert events[1] & EVENT_QUARANTINED and not any(e & EVENT_QUARANTINED for i, e in
                                                     enumerate(events) if i != 1)
    assert bool(torch.isfinite(got.tel.psi).all())
    assert torch.equal(got.tel.psi, want.tel.psi)
    for x, y in ((got.C, want.C), (got.M, want.M), (got.ctx.col_idx, want.ctx.col_idx)):
        assert torch.equal(x, y)
    assert torch.equal(got.tel.admitted, want.tel.admitted)


def test_registry_instruments_and_jsonl(tmp_path):
    reg = MetricsRegistry()
    reg.inc("a/count")
    reg.inc("a/count", 4)
    reg.set_gauge("a/gauge", 2.5)
    for v in (1.0, 2.0, 3.0, 10.0):
        reg.observe("a/hist", v)
    summ = reg.histogram_summary("a/hist")
    assert summ["count"] == 4 and summ["min"] == 1.0 and summ["max"] == 10.0
    with span("outer", reg):
        with span("inner", reg):
            pass
    assert [s.name for s in reg.spans] == ["inner", "outer"]  # closing order
    assert reg.spans[0].depth == 1 and reg.spans[1].depth == 0
    reg.record_kv_compression(torch.tensor([0.1, 0.2]), ratio=3.0, ranks=[4, 8])
    assert reg.counters["serve/kv_heads_compressed"] == 2
    path = tmp_path / "metrics.jsonl"
    reg.dump_jsonl(path)
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert {"counter", "gauge", "histogram", "span"} <= {r["type"] for r in recs}
    assert next(r for r in recs if r["name"] == "a/count")["value"] == 5
    assert set(next(r for r in recs if r["type"] == "span")) == {
        "type", "name", "start_s", "duration_s", "depth"}
    tl = render_timeline(reg)
    assert "outer" in tl and "inner" in tl
    assert render_timeline(MetricsRegistry()) == "(no spans recorded)"


def test_disabled_registry_is_inert():
    reg = MetricsRegistry(enabled=False)
    reg.inc("x")
    reg.set_gauge("x", 1.0)
    reg.observe("x", 1.0)
    reg.record_kv_compression([0.5])
    with span("x", reg):
        pass
    assert not reg.counters and not reg.gauges and not reg.histograms and not reg.spans


def test_default_registry_swap_and_engine_spans():
    """Engine spans are inert by default; an enabled process registry
    captures the engine's spans under their names."""
    assert default_registry().enabled is False
    prev = set_registry(MetricsRegistry())
    try:
        stream_panels(CONFIGS["fixed_cur"][0](False), torch.from_numpy(_A()), PANEL)
        stream_panels(CONFIGS["fixed_cur"][0](False), torch.from_numpy(_A()), PANEL,
                      route="per-panel")
        names = [s.name for s in default_registry().spans]
        assert names == ["stream/streaming_cur/scan", "stream/streaming_cur/per-panel"]
    finally:
        set_registry(prev)
    assert default_registry() is prev


def test_record_stream_telemetry():
    reg = MetricsRegistry()
    st = stream_panels(CONFIGS["adaptive_cur_evict_rows"][0](True), torch.from_numpy(_A()), PANEL)
    reg.record_stream_telemetry(st)
    assert reg.counters["stream/admitted"] == int(st.ctx.n_filled)
    assert reg.counters["stream/evicted"] == int(st.ctx.n_evicted)
    assert reg.counters["stream/rows_admitted"] == int(st.ctx.rows.n_filled)
    assert reg.counters["stream/panels"] == N // PANEL
    assert len(reg.histograms["stream/panel_energy"]) == N // PANEL
    assert "stream/energy_mass" in reg.gauges
