"""Checkpoints and the resilient step loop of the port
(``repro_torch.checkpoint``): the cases of ``tests/test_checkpoint.py`` on
torch trees, and checkpoints crossing between the two packages in both
layouts (the reference's ``jax.tree_util.keystr`` leaf names, bfloat16 as a
``uint16`` view), for plain trees and for streaming states.
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore as j_restore  # noqa: E402
from repro.checkpoint import save as j_save  # noqa: E402
from repro.cur.streaming import streaming_cur_init as j_fixed_init  # noqa: E402
from repro.data.synthetic import powerlaw_matrix as j_powerlaw  # noqa: E402
from repro.spsd.streaming import streaming_spsd_init as j_spsd_init  # noqa: E402
from repro.stream import stream_panels as j_stream  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (latest_step, list_steps, restore,  # noqa: E402
                                    run_resilient_loop, save)
from repro_torch.checkpoint.checkpoint import _leaf_name, _leaves  # noqa: E402
from repro_torch.cur import streaming_cur_init  # noqa: E402
from repro_torch.spsd import streaming_spsd_init  # noqa: E402
from repro_torch.stream import adaptive_cur_init, stream_panels  # noqa: E402

M, N, PANEL = 96, 144, 16


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g),
                   "b": torch.zeros((16,), dtype=torch.bfloat16)},
        "opt": {"m": torch.ones((8, 16)), "step": torch.tensor(7, dtype=torch.int32)},
    }


def _flat(tree):
    return [leaf for _, leaf, _ in _leaves(tree)]


def _assert_trees_equal(a, b):
    for x, y in zip(_flat(a), _flat(b), strict=True):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 10, t, extra={"data_state": {"step": 10}})
    out, extra, step = restore(str(tmp_path), t)
    assert step == 10 and extra["data_state"]["step"] == 10
    _assert_trees_equal(t, out)
    for x, y in zip(_flat(t), _flat(out)):
        assert x.data_ptr() != y.data_ptr()  # fresh storage


def test_keep_last_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        save(str(tmp_path), s, t, keep_last=2)
    assert list_steps(str(tmp_path)) == [4, 5]


def test_latest_and_specific_step(tmp_path):
    t = _tree()
    save(str(tmp_path), 1, t, keep_last=10)
    t2 = _tree()
    t2["params"]["w"] = t2["params"]["w"] + 1
    save(str(tmp_path), 2, t2, keep_last=10)
    assert latest_step(str(tmp_path)) == 2
    out1, _, _ = restore(str(tmp_path), t, step=1)
    out2, _, _ = restore(str(tmp_path), t, step=2)
    assert not torch.allclose(out1["params"]["w"], out2["params"]["w"])


def test_atomicity_no_tmp_dirs_visible(tmp_path):
    save(str(tmp_path), 3, _tree())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_async_save(tmp_path):
    t = _tree()
    before = t["params"]["w"].clone()
    th = save(str(tmp_path), 4, t, async_=True)
    t["params"]["w"].add_(1.0)  # the snapshot was taken before save returned
    th.join(timeout=30)
    assert not th.is_alive()
    assert latest_step(str(tmp_path)) == 4
    out, _, _ = restore(str(tmp_path), t)
    assert torch.equal(out["params"]["w"], before)


def test_shape_mismatch_raises(tmp_path):
    t = _tree()
    save(str(tmp_path), 1, t)
    bad = {"params": {"w": torch.zeros((3, 3)), "b": torch.zeros((3, 3))},
           "opt": {"m": torch.zeros((3, 3)), "step": torch.zeros((3, 3))}}
    with pytest.raises(ValueError):
        restore(str(tmp_path), bad)


def _count_step(state, batch, step):
    state["x"].add_(1.0)
    return state, {"loss": state["x"] - 1.0}


def test_resilient_loop_restart(tmp_path):
    """Crash at step 12, restore the step-10 checkpoint, finish 20 steps."""
    state = {"x": torch.zeros(())}
    report = run_resilient_loop(state=state, step_fn=_count_step, batch_fn=lambda s: None,
                                n_steps=20, ckpt_dir=str(tmp_path), ckpt_every=5, fail_at_step=12)
    assert report.restarts == 1
    assert latest_step(str(tmp_path)) == 20
    final, _, _ = restore(str(tmp_path), {"x": torch.zeros(())})
    assert float(final["x"]) == 20.0  # replayed 10 -> 20


def test_resilient_loop_straggler_detection(tmp_path):
    def step_fn(state, batch, step):
        if step == 15:
            time.sleep(1.0)  # the injected straggler
        return state, {"loss": torch.zeros(())}

    report = run_resilient_loop(state={"x": torch.zeros(())}, step_fn=step_fn,
                                batch_fn=lambda s: None, n_steps=20, ckpt_dir=str(tmp_path),
                                ckpt_every=50, straggler_factor=3.0)
    assert report.stragglers >= 1


def test_torn_write_skipped(tmp_path):
    """A checkpoint directory damaged mid-save (a truncated or missing leaf,
    a garbage manifest) is skipped; the newest intact step wins."""
    t = _tree()
    save(str(tmp_path), 1, t, keep_last=10)
    save(str(tmp_path), 2, t, keep_last=10)
    step2 = tmp_path / "step_00000002"
    leaf = next(p for p in step2.iterdir() if p.suffix == ".npy")
    leaf.write_bytes(b"")
    assert list_steps(str(tmp_path)) == [1]
    assert latest_step(str(tmp_path)) == 1
    _, _, step = restore(str(tmp_path), t)
    assert step == 1
    leaf.unlink()
    assert latest_step(str(tmp_path)) == 1
    (step2 / "manifest.json").write_text("{not json")
    assert latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError, match="torn"):
        restore(str(tmp_path), t, step=2)


def test_no_part_files_after_save(tmp_path):
    save(str(tmp_path), 5, _tree())
    assert not any(p.name.endswith(".part") for p in (tmp_path / "step_00000005").iterdir())


def test_all_checkpoints_torn_raises(tmp_path):
    save(str(tmp_path), 1, _tree())
    for p in (tmp_path / "step_00000001").iterdir():
        if p.suffix == ".npy":
            p.write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="no intact"):
        restore(str(tmp_path), _tree())


def test_resilient_loop_preserves_restored_extra(tmp_path):
    """The metadata restored after a failure is kept on the report and
    written again by later saves."""
    report = run_resilient_loop(state={"x": torch.zeros(())}, step_fn=_count_step,
                                batch_fn=lambda s: None, n_steps=20, ckpt_dir=str(tmp_path),
                                ckpt_every=5, fail_at_step=12, extra_meta={"run_name": "hygiene"})
    assert report.restarts == 1
    assert report.restored_extra is not None
    assert report.restored_extra["run_name"] == "hygiene"
    _, extra, step = restore(str(tmp_path), {"x": torch.zeros(())})
    assert step == 20 and extra["run_name"] == "hygiene"


def test_resilient_loop_restart_not_flagged_straggler(tmp_path):
    """Step times reset after a restore, so the slow first step after it is
    not flagged against the median from before the crash.

    Margin: steps take 20 ms and the factor is 10, so a healthy step is
    flagged only if load stretches it past 200 ms; the replayed step takes
    320 ms, which the watchdog would flag without the reset."""
    calls = {10: 0}

    def step_fn(state, batch, step):
        time.sleep(0.02)
        if step == 10:
            calls[10] += 1
            if calls[10] == 2:  # only the replayed execution is slow
                time.sleep(0.3)
        state["x"].add_(1.0)
        return state, {"loss": state["x"]}

    report = run_resilient_loop(state={"x": torch.zeros(())}, step_fn=step_fn,
                                batch_fn=lambda s: None, n_steps=20, ckpt_dir=str(tmp_path),
                                ckpt_every=5, fail_at_step=12, straggler_factor=10.0)
    assert report.restarts == 1 and calls[10] == 2
    assert report.stragglers == 0


def test_packed_roundtrip(tmp_path):
    """pack=True writes one step_<N>.ckpt whose restore gives the same bits
    and dtypes, bfloat16 (stored as a uint16 view) included."""
    t = _tree()
    path = save(str(tmp_path), 10, t, extra={"panels_consumed": 12}, pack=True)
    assert path.endswith("step_00000010.ckpt") and os.path.isfile(path)
    assert not os.path.isdir(tmp_path / "step_00000010")
    out, extra, step = restore(str(tmp_path), t)
    assert step == 10 and extra["panels_consumed"] == 12
    _assert_trees_equal(t, out)


def test_packed_torn_file_skipped(tmp_path):
    t = _tree()
    save(str(tmp_path), 1, t, keep_last=10, pack=True)
    save(str(tmp_path), 2, t, keep_last=10, pack=True)
    f2 = tmp_path / "step_00000002.ckpt"
    f2.write_bytes(f2.read_bytes()[:-5])  # a torn tail: size != header's claim
    assert list_steps(str(tmp_path)) == [1]
    _, _, step = restore(str(tmp_path), t)
    assert step == 1
    f2.write_bytes(b"NOTMAGIC" + b"\x00" * 64)
    assert latest_step(str(tmp_path)) == 1


def test_packed_and_dir_layouts_interoperate(tmp_path):
    t = _tree()
    save(str(tmp_path), 1, t, keep_last=10)
    save(str(tmp_path), 2, t, keep_last=10, pack=True)
    assert list_steps(str(tmp_path)) == [1, 2]
    _, _, step = restore(str(tmp_path), t)
    assert step == 2
    for s in (3, 4):
        save(str(tmp_path), s, t, keep_last=2, pack=True)
    assert list_steps(str(tmp_path)) == [3, 4]  # GC evicted both layouts


def test_durable_false_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 6, t, durable=False, pack=True)
    out, _, step = restore(str(tmp_path), t)
    assert step == 6
    assert torch.equal(out["params"]["w"], t["params"]["w"])
    assert not any(p.name.endswith(".part") for p in tmp_path.iterdir())


def test_leaf_name_sanitization():
    (key, _, _), = _leaves({"a b": {"c/d": torch.zeros(1)}})
    assert key == "['a b']['c/d']"
    name = _leaf_name(key)
    assert "/" not in name and " " not in name


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _jtree():
    k = jax.random.key(0)
    return {"params": {"w": jax.random.normal(k, (8, 16)),
                       "b": jnp.arange(16).astype(jnp.bfloat16)},
            "opt": {"m": jnp.ones((8, 16)), "step": jnp.asarray(7, jnp.int32)}}


def _as_torch(jt):
    return {"params": {"w": convert.to_tensor(np.asarray(jt["params"]["w"]), "cpu"),
                       "b": convert.to_tensor(np.asarray(jt["params"]["b"]), "cpu")},
            "opt": {"m": convert.to_tensor(np.asarray(jt["opt"]["m"]), "cpu"),
                    "step": convert.to_tensor(np.asarray(jt["opt"]["step"]), "cpu")}}


@pytest.mark.parametrize("pack", [False, True], ids=["dir", "packed"])
def test_tree_crosses_packages_both_ways(tmp_path, pack):
    """Reference-written trees (bfloat16 leaf included) restore in the port
    with the same bits, and port-written ones in the reference."""
    jt = _jtree()
    pt = _as_torch(jt)
    assert pt["params"]["b"].dtype == torch.bfloat16
    j_save(str(tmp_path / "j"), 3, jt, extra={"who": "jax"}, pack=pack)
    out, extra, step = restore(str(tmp_path / "j"), _tree())
    assert step == 3 and extra == {"who": "jax"}
    _assert_trees_equal(pt, out)

    save(str(tmp_path / "p"), 4, pt, extra={"who": "torch"}, pack=pack)
    jout, extra, step = j_restore(str(tmp_path / "p"), jt)
    assert step == 4 and extra == {"who": "torch"}
    for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(jout)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _operands():
    A = j_powerlaw(jax.random.key(0), M, N, 1.0)
    G = j_powerlaw(jax.random.key(8), N, 32, 1.0)
    return A, G @ G.T + 0.01 * jnp.eye(N)


COL = np.array([3, 40, 99, 120, 7, 31], np.int32)
ROW = np.array([5, 17, 40, 77, 90, 60], np.int32)


def _fixed_pair():
    def jst():
        return j_fixed_init(jax.random.key(1), M, N, jnp.asarray(COL), jnp.asarray(ROW),
                            panel=PANEL, telemetry=True)

    kw = convert.stream_init_inputs(jst(), "cpu")
    return jst, lambda: streaming_cur_init(None, M, N, COL, ROW, panel=PANEL, telemetry=True,
                                           device="cpu", **kw)


def _spsd_pair():
    def jst():
        return j_spsd_init(jax.random.key(9), N, jnp.asarray(COL[:4]), s=48, panel=PANEL,
                           telemetry=True)

    kw = convert.stream_init_inputs(jst(), "cpu")
    return jst, lambda: streaming_spsd_init(None, N, COL[:4], s=48, panel=PANEL, telemetry=True,
                                            device="cpu", **kw)


PAIRS = {"fixed_cur": (_fixed_pair, 0), "spsd": (_spsd_pair, 1)}


def _same_keys(pst, jst):
    jkeys = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jst)[0]]
    assert [k for k, _, _ in _leaves(pst)] == jkeys


@pytest.mark.parametrize("pack", [False, True], ids=["dir", "packed"])
@pytest.mark.parametrize("config", list(PAIRS))
def test_reference_stream_checkpoint_resumes_in_port(config, pack, tmp_path):
    """A reference stream checkpointed after 4 panels restores into the
    port; the port's resumed stream equals the reference's resumed stream:
    indices, C and R equal, M within 1e-5 of its largest entry, the
    telemetry counters equal."""
    make, op = PAIRS[config]
    j_init, p_init = make()
    data = _operands()[op]
    _same_keys(p_init(), j_init())
    jst = j_stream(j_init(), data, PANEL, stop=4 * PANEL)
    j_save(str(tmp_path), 4, jst, extra={"panels_consumed": 4}, pack=pack)
    j_done = j_stream(jst, data, PANEL)

    st, extra, step = restore(str(tmp_path), p_init())
    assert step == 4 and st.offset == 4 * PANEL and extra["panels_consumed"] == 4
    done = stream_panels(st, torch.from_numpy(np.array(data)), PANEL)
    assert np.array_equal(done.ctx.col_idx.numpy(), np.asarray(j_done.ctx.col_idx))
    assert torch.equal(done.C, torch.from_numpy(np.asarray(j_done.C)))
    assert torch.equal(done.R, torch.from_numpy(np.asarray(j_done.R)))
    jm = np.asarray(j_done.M)
    assert np.abs(done.M.numpy() - jm).max() <= 1e-5 * np.abs(jm).max()
    for f in ("admitted", "occupancy", "events", "panels_seen"):
        assert np.array_equal(getattr(done.tel, f).numpy(), np.asarray(getattr(j_done.tel, f))), f


@pytest.mark.parametrize("pack", [False, True], ids=["dir", "packed"])
@pytest.mark.parametrize("config", list(PAIRS))
def test_port_stream_checkpoint_restores_in_reference(config, pack, tmp_path):
    """A port stream checkpointed after 4 panels restores in the reference
    with the port's bits (the offset a 0-dim int32), and the reference's
    stream goes on from there."""
    make, op = PAIRS[config]
    j_init, p_init = make()
    data = _operands()[op]
    st = stream_panels(p_init(), torch.from_numpy(np.array(data)), PANEL, stop=4 * PANEL)
    save(str(tmp_path), 4, st, pack=pack)
    jst, _, step = j_restore(str(tmp_path), j_init())
    assert step == 4 and int(jst.offset) == 4 * PANEL
    for name in ("C", "R", "M"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, name)), getattr(st, name).numpy())
    np.testing.assert_array_equal(np.asarray(jst.tel.psi), st.tel.psi.numpy())
    done = j_stream(jst, data, PANEL)
    assert int(done.offset) == N


def test_adaptive_state_roundtrip_keeps_sketches_and_scalars(tmp_path):
    """An adaptive state with rows (the reference's scalar leaves slot_lo,
    min_gain, swap_gain, seen_lo; a bfloat16 accumulator) restores to the
    same bits, the template's sketch objects (with their cached window
    orders) and its host scalars; a changed sketch comes back rebuilt."""
    A = torch.from_numpy(np.array(_operands()[0]))
    init = lambda seed=3: adaptive_cur_init(  # noqa: E731
        torch.Generator().manual_seed(seed), M, N, 8, None, r=4, panel=PANEL, panel_cap=2,
        swap_gain=2.0, min_gain=0.01, dtype=torch.bfloat16, device="cpu")
    st = stream_panels(init(), A.to(torch.bfloat16), PANEL, stop=3 * PANEL)
    keys = [k for k, _, _ in _leaves(st)]
    for k in (".offset", ".ctx.slot_lo", ".ctx.min_gain", ".ctx.swap_gain",
              ".ctx.rows.seen_lo", ".ctx.rows.min_gain", ".ctx.rows.sr_dense"):
        assert k in keys
    save(str(tmp_path), 3, st, pack=True)
    template = init()
    out, _, _ = restore(str(tmp_path), template)
    assert out.C.dtype == torch.bfloat16 and torch.equal(out.C, st.C)
    assert torch.equal(out.M, st.M) and torch.equal(out.ctx.rows.row_sketch, st.ctx.rows.row_sketch)
    assert out.offset == st.offset and out.ctx.rows.seen_lo == st.ctx.rows.seen_lo
    assert out.ctx.min_gain == 0.01 and out.ctx.swap_gain == 2.0  # the template's floats
    assert out.ctx.S_C is template.ctx.S_C and out.ctx.S_R is template.ctx.S_R
    assert out.ctx.rows.sr_dense is template.ctx.rows.sr_dense
    assert out.C.data_ptr() != template.C.data_ptr()

    other = init(seed=4)
    out2, _, _ = restore(str(tmp_path), other)
    assert out2.ctx.S_C is not other.ctx.S_C
    assert torch.equal(out2.ctx.S_C.hashes, st.ctx.S_C.hashes) and not out2.ctx.S_C._windows
