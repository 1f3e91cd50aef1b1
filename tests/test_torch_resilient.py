"""Resilient streaming ingestion of the port (``repro_torch.stream.resilient``):
the cases of ``tests/test_resilient.py`` — kill-and-resume bitwise parity,
fault injection, quarantine, per-worker sharded resume — on port states
whose sketches and Ω_test the reference drew (``convert.stream_init_inputs``),
the resumed factors against the reference's own resilient runs, and the
chaos lane's seeded fault schedule (``tools/chaos_check.py``).

Bitwise: C, R, M, the integer telemetry counters and Ψ between port runs at
the same chunk cadence. Against the reference: indices, C and R equal, M
within 1e-5 of its largest entry (fp32 sums in another order).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.cur.streaming import streaming_cur_init as j_fixed_init  # noqa: E402
from repro.data.synthetic import powerlaw_matrix as j_powerlaw  # noqa: E402
from repro.spsd.streaming import streaming_spsd_init as j_spsd_init  # noqa: E402
from repro.stream import ArrayPanelSource as JArraySource  # noqa: E402
from repro.stream import adaptive_cur_init as j_adaptive_init  # noqa: E402
from repro.stream import run_resilient_stream as j_run  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.cur import streaming_cur_init  # noqa: E402
from repro_torch.obs import (EVENT_QUARANTINED, MetricsRegistry, set_registry,  # noqa: E402
                             telemetry_summary)
from repro_torch.spsd import streaming_spsd_init  # noqa: E402
from repro_torch.stream import (ArrayPanelSource, FaultInjector, FaultPlan,  # noqa: E402
                                InjectedCrash, QuarantineAbort, TransientReadError,
                                adaptive_cur_init, restore_stream_state,
                                run_resilient_sharded_stream, run_resilient_stream,
                                save_stream_state, simulate_sharded_stream, stream_panels,
                                with_quarantine, zero_nonfinite_panels)

ROOT = Path(__file__).resolve().parents[1]
M, N, PANEL = 96, 144, 16  # 9 whole panels
NUM_PANELS = N // PANEL
COL = np.array([3, 40, 99, 120, 7, 31], np.int32)
ROW = np.array([5, 17, 40, 77, 90, 60], np.int32)

_J_INITS = {
    "fixed_cur": lambda: j_fixed_init(jax.random.key(1), M, N, jnp.asarray(COL),
                                      jnp.asarray(ROW), panel=PANEL, telemetry=True),
    "adaptive_cur": lambda: j_adaptive_init(jax.random.key(5), M, N, 8, jnp.asarray(ROW[:4]),
                                            panel=PANEL, panel_cap=2, telemetry=True),
    "spsd": lambda: j_spsd_init(jax.random.key(9), N, jnp.asarray(COL[:4]), s=48, panel=PANEL,
                                telemetry=True),
}
_CACHE = {}


def _inputs(config):
    if config not in _CACHE:
        _CACHE[config] = convert.stream_init_inputs(_J_INITS[config](), "cpu")
    return _CACHE[config]


def _fixed_init():
    return streaming_cur_init(None, M, N, COL, ROW, panel=PANEL, telemetry=True, device="cpu",
                              **_inputs("fixed_cur"))


def _adaptive_init():
    return adaptive_cur_init(None, M, N, 8, ROW[:4], panel=PANEL, panel_cap=2, telemetry=True,
                             device="cpu", **_inputs("adaptive_cur"))


def _spsd_init():
    return streaming_spsd_init(None, N, COL[:4], s=48, panel=PANEL, telemetry=True, device="cpu",
                               **_inputs("spsd"))


CONFIGS = {
    "fixed_cur": (_fixed_init, "A"),
    "adaptive_cur": (_adaptive_init, "A"),
    "spsd": (_spsd_init, "K"),
}
FACTORS = ("C", "R", "M")
TEL_INT = ("admitted", "evicted", "rows_admitted", "occupancy", "events", "panels_seen")


def _jax_operands():
    if "ops" not in _CACHE:
        A = j_powerlaw(jax.random.key(0), M, N, 1.0)
        G = j_powerlaw(jax.random.key(8), N, 32, 1.0)
        _CACHE["ops"] = {"A": A, "K": G @ G.T + 0.01 * jnp.eye(N)}
    return _CACHE["ops"]


def _operand(name):
    return torch.from_numpy(np.array(_jax_operands()[name]))


@pytest.fixture(scope="module")
def A():
    return _operand("A")


def _assert_states_equal(a, b, *, psi=True):
    for f in FACTORS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for leaf in TEL_INT:
        assert torch.equal(getattr(a.tel, leaf), getattr(b.tel, leaf)), leaf
    if psi:
        assert torch.equal(a.tel.psi, b.tel.psi)


# ---------------------------------------------------------------------------
# kill-and-resume bitwise parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("crash_panel", [2, 5, NUM_PANELS - 1], ids=["first", "middle", "last"])
def test_kill_and_resume_bitwise_parity(config, crash_panel, tmp_path):
    """Killed by an injected crash and resumed from the newest checkpoint in
    a second invocation, the stream equals the uninterrupted run at the same
    chunk cadence bit for bit: C, R, M, the counters and Ψ."""
    init, operand = CONFIGS[config]
    src = ArrayPanelSource(_operand(operand), PANEL)
    ref, ref_rep = run_resilient_stream(init(), src, chunk_panels=2)
    assert ref_rep.panels_consumed == NUM_PANELS

    inj = FaultInjector(src, FaultPlan(crash_at_panel=crash_panel))
    d = str(tmp_path / config)
    with pytest.raises(InjectedCrash):
        run_resilient_stream(init(), inj, chunk_panels=2, ckpt_dir=d, ckpt_every=1)
    st, rep = run_resilient_stream(init(), inj, chunk_panels=2, ckpt_dir=d, ckpt_every=1)
    assert rep.resumed_from == (crash_panel // 2) * 2
    assert rep.panels_consumed == NUM_PANELS
    _assert_states_equal(ref, st)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_in_process_restart_parity(config, tmp_path):
    init, operand = CONFIGS[config]
    src = ArrayPanelSource(_operand(operand), PANEL)
    ref, _ = run_resilient_stream(init(), src, chunk_panels=3)
    inj = FaultInjector(src, FaultPlan(crash_at_panel=7))
    st, rep = run_resilient_stream(init(), inj, chunk_panels=3, ckpt_dir=str(tmp_path),
                                   ckpt_every=1, max_restarts=1)
    assert rep.restarts == 1
    _assert_states_equal(ref, st)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_resumed_factors_match_reference(config, tmp_path):
    """The port's killed-and-resumed stream against the reference's
    resilient run on the same sketches: indices, C and R equal, M within
    1e-5 of its largest entry, the counters equal."""
    init, operand = CONFIGS[config]
    jref, _ = j_run(_J_INITS[config](), JArraySource(_jax_operands()[operand], PANEL),
                    chunk_panels=2)
    inj = FaultInjector(ArrayPanelSource(_operand(operand), PANEL), FaultPlan(crash_at_panel=5))
    with pytest.raises(InjectedCrash):
        run_resilient_stream(init(), inj, chunk_panels=2, ckpt_dir=str(tmp_path), ckpt_every=1)
    st, _ = run_resilient_stream(init(), inj, chunk_panels=2, ckpt_dir=str(tmp_path),
                                 ckpt_every=1)
    for name in ("col_idx", "row_idx"):
        if hasattr(jref.ctx, name):
            want = np.asarray(getattr(jref.ctx, name))
            assert np.array_equal(getattr(st.ctx, name).numpy(), want)
    assert np.array_equal(st.C.numpy(), np.asarray(jref.C))
    assert np.array_equal(st.R.numpy(), np.asarray(jref.R))
    jm = np.asarray(jref.M)
    assert np.abs(st.M.numpy() - jm).max() <= 1e-5 * np.abs(jm).max()
    for leaf in TEL_INT:
        assert np.array_equal(getattr(st.tel, leaf).numpy(), np.asarray(getattr(jref.tel, leaf)))


def test_resume_false_ignores_stale_checkpoints(A, tmp_path):
    """resume=False: a second drive into a directory holding the first
    drive's final checkpoint replays the whole stream, and in-process
    restarts roll back only to this drive's saves."""
    src = ArrayPanelSource(A, PANEL)
    ref, _ = run_resilient_stream(_fixed_init(), src, chunk_panels=2)
    d = str(tmp_path)
    _, rep1 = run_resilient_stream(_fixed_init(), src, chunk_panels=2, ckpt_dir=d, ckpt_every=1)
    assert rep1.resumed_from is None and rep1.panels_consumed == NUM_PANELS
    st, rep2 = run_resilient_stream(_fixed_init(), src, chunk_panels=2, ckpt_dir=d, ckpt_every=1,
                                    resume=False)
    assert rep2.resumed_from is None and rep2.panels_consumed == NUM_PANELS
    _assert_states_equal(ref, st)
    inj = FaultInjector(src, FaultPlan(crash_at_panel=6))
    st2, rep3 = run_resilient_stream(_fixed_init(), inj, chunk_panels=2, ckpt_dir=d,
                                     ckpt_every=1, resume=False, max_restarts=1)
    assert rep3.restarts == 1
    _assert_states_equal(ref, st2)


def test_crash_without_checkpoint_restarts_from_scratch(A):
    """No ckpt_dir: the restart replays from the pristine copy taken before
    the first chunk, not from the state the engine updated in place."""
    src = ArrayPanelSource(A, PANEL)
    ref, _ = run_resilient_stream(_fixed_init(), src, chunk_panels=2)
    inj = FaultInjector(src, FaultPlan(crash_at_panel=6))
    st, rep = run_resilient_stream(_fixed_init(), inj, chunk_panels=2, max_restarts=1)
    assert rep.restarts == 1
    _assert_states_equal(ref, st)


def test_resumed_factors_match_per_panel_driver(A, tmp_path):
    """The resumed chunked factors equal the whole stream driven per panel
    (Ψ's association follows the chunk cadence, so it is left out)."""
    inj = FaultInjector(ArrayPanelSource(A, PANEL), FaultPlan(crash_at_panel=5))
    d = str(tmp_path)
    with pytest.raises(InjectedCrash):
        run_resilient_stream(_fixed_init(), inj, chunk_panels=2, ckpt_dir=d, ckpt_every=1)
    st, _ = run_resilient_stream(_fixed_init(), inj, chunk_panels=2, ckpt_dir=d, ckpt_every=1)
    whole = stream_panels(_fixed_init(), A, PANEL, route="per-panel")
    _assert_states_equal(whole, st, psi=False)


def test_restored_state_is_fresh_buffer(A, tmp_path):
    """A restored state shares no accumulator with its template or with
    another restore of the same checkpoint: restored and streamed twice, it
    gives the same bits twice."""
    src = ArrayPanelSource(A, PANEL)
    st, _ = run_resilient_stream(_fixed_init(), src, chunk_panels=2, stop_panel=4)
    save_stream_state(str(tmp_path), st, 4)
    template = _fixed_init()
    out = []
    for _ in range(2):
        restored, cursor, _ = restore_stream_state(str(tmp_path), template)
        assert cursor == 4 and restored.C.data_ptr() != template.C.data_ptr()
        done, _ = run_resilient_stream(restored, src, chunk_panels=2, start_panel=cursor)
        out.append(done)
    _assert_states_equal(out[0], out[1])
    assert not template.C.any() and not template.M.any()


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


def test_drop_duplicate_straggler_do_not_diverge(A):
    src = ArrayPanelSource(A, PANEL)
    ref, _ = run_resilient_stream(_fixed_init(), src, chunk_panels=3)
    inj = FaultInjector(src, FaultPlan(drop_panels=(2,), duplicate_panels=(5,),
                                       straggler_panels=(4,), straggler_delay_s=0.001))
    st, rep = run_resilient_stream(_fixed_init(), inj, chunk_panels=3)
    assert rep.retries >= 2  # one drop read again, one stale tag asked for again
    _assert_states_equal(ref, st)


def test_drop_exhausts_retries(A):
    class AlwaysDrop(ArrayPanelSource):
        def read_chunk(self, lo, num):
            raise TransientReadError("flaky source")

    with pytest.raises(TransientReadError, match="flaky"):
        run_resilient_stream(_fixed_init(), AlwaysDrop(A, PANEL), chunk_panels=2, max_retries=2)


# ---------------------------------------------------------------------------
# graceful degradation: quarantine and strict mode
# ---------------------------------------------------------------------------


def test_quarantine_equals_zeroed_panel(A):
    """A quarantined panel contributes what an all-zero panel would: C, R,
    M and Ψ equal the clean run on the zeroed operand bit for bit; only the
    corrupted panels carry EVENT_QUARANTINED; the source's data stays clean."""
    bad_panels = (3, 6)
    A_zero = A.clone()
    for t in bad_panels:
        A_zero[:, t * PANEL : (t + 1) * PANEL] = 0.0
    ref, _ = run_resilient_stream(_fixed_init(), ArrayPanelSource(A_zero, PANEL), chunk_panels=2)
    inj = FaultInjector(ArrayPanelSource(A, PANEL), FaultPlan(corrupt_panels=bad_panels))
    st, rep = run_resilient_stream(_fixed_init(), inj, chunk_panels=2, quarantine=True)
    assert rep.quarantined == len(bad_panels) and int(st.quarantined) == len(bad_panels)
    for f in FACTORS:
        assert torch.equal(getattr(ref, f), getattr(st, f)), f
    assert torch.equal(ref.tel.psi, st.tel.psi)
    flagged = set(torch.nonzero(st.tel.events & EVENT_QUARANTINED).flatten().tolist())
    assert flagged == set(bad_panels)
    summ = telemetry_summary(st)
    for t in bad_panels:
        assert "quarantined" in summ["events"][t]
    assert bool(torch.isfinite(A).all())


def test_quarantine_metrics_counters(A):
    reg = MetricsRegistry(enabled=True)
    set_registry(reg)
    try:
        inj = FaultInjector(ArrayPanelSource(A, PANEL), FaultPlan(corrupt_panels=(4,)))
        run_resilient_stream(_fixed_init(), inj, chunk_panels=2, quarantine=True)
        assert reg.counters.get("stream/resilient/quarantined") == 1
        inj2 = FaultInjector(ArrayPanelSource(A, PANEL), FaultPlan(crash_at_panel=5,
                                                                   drop_panels=(2,)))
        run_resilient_stream(_fixed_init(), inj2, chunk_panels=2, max_restarts=1)
        assert reg.counters.get("stream/resilient/restarts") == 1
        assert reg.counters.get("stream/resilient/retries") == 1
        assert any(s.name == "stream/streaming_cur/resilient" for s in reg.spans)
    finally:
        set_registry(MetricsRegistry(enabled=False))


def test_strict_mode_aborts_to_last_checkpoint(A, tmp_path):
    inj = FaultInjector(ArrayPanelSource(A, PANEL), FaultPlan(corrupt_panels=(5,)))
    with pytest.raises(QuarantineAbort) as exc:
        run_resilient_stream(_fixed_init(), inj, chunk_panels=1, ckpt_dir=str(tmp_path),
                             ckpt_every=1, strict=True)
    e = exc.value
    assert e.panels_consumed == 5  # the corrupt panel unconsumed
    assert e.state.offset == 5 * PANEL
    assert int(e.state.quarantined) == 0
    clean = ArrayPanelSource(A, PANEL)
    done, _ = run_resilient_stream(e.state, clean, chunk_panels=1, start_panel=e.panels_consumed)
    ref, _ = run_resilient_stream(_fixed_init(), clean, chunk_panels=1, quarantine=True)
    _assert_states_equal(ref, done)


def test_zero_nonfinite_panels_masks_only_bad_panels(A):
    blk = A[:, : 4 * PANEL]
    bad = blk.clone()
    bad[:, PANEL + 3] = float("inf")
    out = zero_nonfinite_panels(bad, PANEL)
    assert torch.equal(out[:, :PANEL], blk[:, :PANEL])
    assert not out[:, PANEL : 2 * PANEL].any()
    assert torch.equal(out[:, 2 * PANEL :], blk[:, 2 * PANEL :])


def test_quarantine_off_state_unarmed(A):
    st = stream_panels(_fixed_init(), A, PANEL)
    assert st.quarantined is None
    armed = with_quarantine(_fixed_init())
    assert int(armed.quarantined) == 0
    assert with_quarantine(armed) is armed
    # the drivers arm a copy: the caller's state stays unarmed
    mine = _fixed_init()
    run_resilient_stream(mine, ArrayPanelSource(A, PANEL), chunk_panels=3, quarantine=True)
    assert mine.quarantined is None


# ---------------------------------------------------------------------------
# distributed resume: per-worker checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_workers", [2, 4])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_sharded_worker_crash_resume_parity(config, num_workers, tmp_path):
    """One worker's crash, resumed from its own directory and merged again,
    equals the all-healthy sharded run bit for bit, which equals the
    in-process simulation's C, R and M; the template survives the crashed
    invocation and is passed again."""
    init, operand = CONFIGS[config]
    Aop = _operand(operand)
    src = ArrayPanelSource(Aop, PANEL)
    healthy, _ = run_resilient_sharded_stream(init(), src, num_workers, chunk_panels=2)
    oracle = simulate_sharded_stream(init(), Aop, PANEL, num_workers, route="per-panel")
    for f in FACTORS:
        assert torch.equal(getattr(healthy, f), getattr(oracle, f)), f
    d = str(tmp_path / f"{config}_{num_workers}")
    inj = FaultInjector(src, FaultPlan(crash_at_panel=NUM_PANELS // 2))
    state0 = init()
    with pytest.raises(InjectedCrash):
        run_resilient_sharded_stream(state0, inj, num_workers, ckpt_dir=d, chunk_panels=2,
                                     ckpt_every=1)
    assert not state0.C.any() and state0.offset == 0
    st, reps = run_resilient_sharded_stream(state0, inj, num_workers, ckpt_dir=d,
                                            chunk_panels=2, ckpt_every=1)
    assert any(r.resumed_from is not None for r in reps)
    _assert_states_equal(healthy, st)


def test_sharded_needs_fresh_state(A):
    st, _ = run_resilient_stream(_fixed_init(), ArrayPanelSource(A, PANEL), chunk_panels=2,
                                 stop_panel=2)
    with pytest.raises(ValueError, match="fresh state"):
        run_resilient_sharded_stream(st, ArrayPanelSource(A, PANEL), 2)


# ---------------------------------------------------------------------------
# the chaos lane's schedule
# ---------------------------------------------------------------------------


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault(name, mod)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fault_schedule_is_the_chaos_lanes():
    """``chip_smoke.py``'s copy of the schedule draws the chaos lane's
    faults from the same seed."""
    chaos = _load(ROOT / "tools" / "chaos_check.py", "chaos_check_for_test")
    smoke = _load(ROOT / "chip_smoke.py", "chip_smoke_for_test")
    for seed in range(4):
        for num_panels in (12, 128, 256):
            want = chaos._fault_schedule(np.random.RandomState(seed), num_panels)
            assert smoke.fault_schedule(np.random.RandomState(seed), num_panels) == want


@pytest.mark.parametrize("config", list(CONFIGS))
def test_chaos_schedule_equals_clean_zeroed_run(config, tmp_path):
    """The chaos lane's seed-0 schedule — a crash, two NaN panels, a drop, a
    duplicate, a straggler — handled by retry, dedup, checkpoint-resume and
    quarantine, equals a clean quarantined drive of the source with the
    corrupted panels zeroed (in a clone), and the registry counts the
    faults that fired."""
    chaos = _load(ROOT / "tools" / "chaos_check.py", "chaos_check_for_test")
    init, operand = CONFIGS[config]
    Aop = _operand(operand)
    sched = chaos._fault_schedule(np.random.RandomState(0), NUM_PANELS)
    plan = FaultPlan(straggler_delay_s=0.002, **sched)
    A_zero = Aop.clone()
    for t in plan.corrupt_panels:
        A_zero[:, t * PANEL : (t + 1) * PANEL] = 0.0
    ref, _ = run_resilient_stream(init(), ArrayPanelSource(A_zero, PANEL), chunk_panels=2,
                                  quarantine=True)
    reg = MetricsRegistry(enabled=True)
    set_registry(reg)
    try:
        inj = FaultInjector(ArrayPanelSource(Aop, PANEL), plan)
        d = str(tmp_path)
        with pytest.raises(InjectedCrash):
            run_resilient_stream(init(), inj, chunk_panels=2, ckpt_dir=d, ckpt_every=1,
                                 quarantine=True)
        st, rep = run_resilient_stream(init(), inj, chunk_panels=2, ckpt_dir=d, ckpt_every=1,
                                       quarantine=True)
    finally:
        set_registry(MetricsRegistry(enabled=False))
    for f in FACTORS:
        assert torch.equal(getattr(ref, f), getattr(st, f)), f
    for leaf in TEL_INT:  # events differ by EVENT_QUARANTINED on the corrupt panels
        assert torch.equal(getattr(ref.tel, leaf) & ~EVENT_QUARANTINED,
                           getattr(st.tel, leaf) & ~EVENT_QUARANTINED), leaf
    assert torch.equal(ref.tel.psi, st.tel.psi)
    assert rep.quarantined == 2 and rep.resumed_from is not None
    assert reg.counters.get("stream/resilient/quarantined") == 2
    assert reg.counters.get("stream/resilient/retries") == len(inj._dropped) + len(inj._duplicated)
    assert inj._dropped == set(plan.drop_panels)
    assert bool(torch.isfinite(Aop).all())
