"""``mesh_sharded_stream`` of the port (``repro_torch.stream.distributed``)
across the ranks of a ``torch.distributed`` gloo group on the CPU, against
the in-process ``simulate_sharded_stream`` at the same W, against the
resilient sharded driver, and at W = 1 against the single-host stream.

The ranks are spawned processes running :func:`_rank` (an importable
entry point of this module, which imports no JAX at the top so that the
ranks stay light); the stream's operand reaches them through shared memory
and each takes a view of its own column block, as on the card. Sketches
and Ω_test are the reference's draws (``convert.stream_init_inputs``).

Tolerances: C, R, the index tables, slot state and integer counters
bitwise at every W (disjoint writes into zeros); M, Ψ and the running
float sums bitwise at W = 2 (a + b = b + a) and within 1e-6 of their
largest entry at W = 4 (gloo sums four terms in another order). W = 4 is
``slow``, as the reference's own multi-device tests are; the default lane
spawns the two W = 2 ranks once (about 10 s).
"""

import datetime
import queue
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.checkpoint import _leaves  # noqa: E402
from repro_torch.cur import streaming_cur_init  # noqa: E402
from repro_torch.spsd import adaptive_spsd_init, streaming_spsd_init  # noqa: E402
from repro_torch.stream import (ArrayPanelSource, adaptive_cur_init,  # noqa: E402
                                mesh_sharded_stream, padded_n, run_resilient_sharded_stream,
                                simulate_sharded_stream, stream_panels)

M, N, PANEL = 96, 144, 12  # 12 panels: whole panels per rank at W = 2 and 4
COL = np.array([3, 40, 99, 120, 7, 31], np.int32)
ROW = np.array([5, 17, 40, 77, 90, 60], np.int32)
# float running sums: bitwise at W = 2, to summation order at W = 4
SUMS = {".M", ".tel.psi", ".tel.energy_mass", ".ctx.energy", ".ctx.rows.row_sketch"}

BUILDERS = {
    "fixed_cur": lambda **kw: streaming_cur_init(None, M, N, COL, ROW, panel=PANEL,
                                                 telemetry=True, device="cpu", **kw),
    "adaptive_cur": lambda **kw: adaptive_cur_init(None, M, N, 8, ROW[:4], panel=PANEL,
                                                   panel_cap=2, telemetry=True, device="cpu", **kw),
    "adaptive_rows": lambda **kw: adaptive_cur_init(None, M, N, 8, None, r=4, panel=PANEL,
                                                    panel_cap=2, panel_cap_rows=1, swap_gain=2.0,
                                                    device="cpu", **kw),
    "spsd": lambda **kw: streaming_spsd_init(None, N, COL[:4], s=48, panel=PANEL, telemetry=True,
                                             device="cpu", **kw),
    "adaptive_spsd": lambda **kw: adaptive_spsd_init(None, N, 4, s=48, panel=PANEL,
                                                     min_gain=0.5, device="cpu", **kw),
    # a shorter stream of the same kind: the collectives do not grow with panels
    "fixed_cur_short": lambda **kw: streaming_cur_init(torch.Generator().manual_seed(0), M, 96,
                                                       COL[COL < 96], ROW, panel=PANEL,
                                                       telemetry=True, device="cpu"),
}


def _digest(state) -> dict:
    """Every checkpoint leaf of a state, as numpy arrays, by its key."""
    return {k: np.array(v.cpu() if torch.is_tensor(v) else v) for k, v, _ in _leaves(state)}


def _rank(rank, world, port, jobs, out_q):
    """One rank: stream each job's column block through
    ``mesh_sharded_stream`` and report the merged state's leaves and the
    number of ``all_reduce`` calls it made."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    real = dist.all_reduce
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    dist.all_reduce = counted
    try:
        out = {}
        for name, (builder, kw, data) in jobs.items():
            n_pad = padded_n(data.shape[1], PANEL)
            block = data[:, rank * n_pad // world : (rank + 1) * n_pad // world]
            state0 = BUILDERS[builder](**kw)
            calls[0] = 0
            merged = mesh_sharded_stream(state0, block, PANEL)
            out[name] = (_digest(merged), calls[0], bool(state0.C.any()))
        out_q.put((rank, out))
    finally:
        dist.all_reduce = real
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, jobs: dict, timeout: float = 300.0) -> dict:
    """Run :func:`_rank` in ``world`` spawned processes; ``{rank: results}``."""
    import time

    mp = torch.multiprocessing
    out_q = mp.get_context("spawn").Queue()
    procs = mp.start_processes(_rank, args=(world, _free_port(), jobs, out_q), nprocs=world,
                               join=False, start_method="spawn")
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, out = out_q.get(timeout=1.0)
                results[rank] = out
            except queue.Empty:
                procs.join(timeout=0)  # raises if a rank failed
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks did not report within {timeout} s")
        while not procs.join(timeout=1.0):  # True once every rank has exited
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks did not exit within {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
    return results


_CACHE = {}


def _jobs() -> dict:
    """Each job's builder, its reference-drawn inputs and its operand."""
    if "jobs" not in _CACHE:
        import jax
        import jax.numpy as jnp

        from repro.cur.streaming import streaming_cur_init as j_fixed
        from repro.data.synthetic import powerlaw_matrix
        from repro.spsd.streaming import adaptive_spsd_init as j_aspsd
        from repro.spsd.streaming import streaming_spsd_init as j_spsd
        from repro.stream import adaptive_cur_init as j_adaptive
        from repro_torch import convert

        A = powerlaw_matrix(jax.random.key(0), M, N, 1.0)
        G = powerlaw_matrix(jax.random.key(8), N, 32, 1.0)
        K = G @ G.T + 0.01 * jnp.eye(N)
        ops = {"A": torch.from_numpy(np.array(A)), "K": torch.from_numpy(np.array(K))}
        col, row = jnp.asarray(COL), jnp.asarray(ROW)
        ref = {
            "fixed_cur": (j_fixed(jax.random.key(1), M, N, col, row, panel=PANEL,
                                  telemetry=True), "A"),
            "adaptive_cur": (j_adaptive(jax.random.key(5), M, N, 8, row[:4], panel=PANEL,
                                        panel_cap=2, telemetry=True), "A"),
            "adaptive_rows": (j_adaptive(jax.random.key(6), M, N, 8, None, r=4, panel=PANEL,
                                         sketch="gaussian"), "A"),
            "spsd": (j_spsd(jax.random.key(9), N, col[:4], s=48, panel=PANEL, telemetry=True),
                     "K"),
            "adaptive_spsd": (j_aspsd(jax.random.key(10), N, 4, s=48, panel=PANEL), "K"),
        }
        jobs = {name: (name, convert.stream_init_inputs(st, "cpu"), ops[op])
                for name, (st, op) in ref.items()}
        jobs["fixed_cur_short"] = ("fixed_cur_short", {}, ops["A"][:, :96])
        _CACHE["jobs"] = jobs
    return _CACHE["jobs"]


def _mesh(world: int) -> dict:
    if world not in _CACHE:
        _CACHE[world] = _spawn(world, _jobs())
    return _CACHE[world]


def _simulated(name: str, world: int) -> dict:
    builder, kw, data = _jobs()[name]
    return _digest(simulate_sharded_stream(BUILDERS[builder](**kw), data, PANEL, world))


def _assert_digests(got: dict, want: dict, world: int):
    assert got.keys() == want.keys()
    for k in want:
        if k in SUMS and world > 2:
            scale = np.abs(want[k]).max() + 1e-30
            assert np.abs(got[k] - want[k]).max() <= 1e-6 * scale, k
        else:
            assert np.array_equal(got[k], want[k]), k


def _check_mesh(name: str, world: int):
    results = _mesh(world)
    digest, calls, touched = results[0][name]
    assert not touched  # state0 is left as it was
    for rank in range(1, world):  # every rank holds the same merged state
        other = results[rank][name][0]
        assert all(np.array_equal(digest[k], other[k]) for k in digest)
    _assert_digests(digest, _simulated(name, world), world)
    assert int(digest[".offset"]) == _jobs()[name][2].shape[1]


@pytest.mark.parametrize("name", ["fixed_cur", "adaptive_cur", "adaptive_rows", "spsd",
                                  "adaptive_spsd"])
def test_mesh_matches_simulate_w2(name):
    """Two gloo ranks against the in-process simulation: every leaf
    bitwise — C, R, M, the index tables and slot state, the telemetry frame
    (merged through ``TelemetryFrame.collective``), Ψ."""
    _check_mesh(name, 2)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["fixed_cur", "adaptive_cur", "adaptive_rows", "spsd",
                                  "adaptive_spsd"])
def test_mesh_matches_simulate_w4(name):
    _check_mesh(name, 4)


def test_mesh_collectives_per_call_not_per_panel():
    """A fixed number of all_reduce calls per call: C, R, M and the ten
    summed frame fields (twelve for a tied-operand stream, no R), plus
    eight ctx leaves for adaptive columns, whatever the stream's length."""
    results = _mesh(2)
    calls = {name: results[0][name][1] for name in results[0]}
    assert calls["fixed_cur"] == calls["fixed_cur_short"] == 13
    assert calls["spsd"] == 12
    assert calls["adaptive_cur"] == 13 + 8
    assert calls["adaptive_rows"] == 3 + 8 + 3
    assert all(results[1][name][1] == calls[name] for name in calls)


def test_resilient_sharded_matches_mesh():
    """The resilient sharded driver at W = 2 (chunks of two panels, one
    worker per range) equals the mesh's merged state: C, R, M, the indices
    and the integer counters bitwise; the frame's float fields (Ψ, scores,
    energies), reduced per chunk there and per range here, within 1e-6."""
    builder, kw, data = _jobs()["fixed_cur"]
    st, _ = run_resilient_sharded_stream(BUILDERS[builder](**kw), ArrayPanelSource(data, PANEL), 2,
                                         chunk_panels=2)
    got, mesh = _digest(st), _mesh(2)[0]["fixed_cur"][0]
    for k in mesh:
        if k.startswith(".tel.") and mesh[k].dtype == np.float32:
            assert np.abs(got[k] - mesh[k]).max() <= 1e-6 * np.abs(mesh[k]).max()
        else:
            assert np.array_equal(got[k], mesh[k]), k


def test_mesh_world_of_one_equals_single_host():
    """A group of one rank (in this process) streams the whole operand:
    the single-host stream's bits; a streamed state or an unpadded R is
    refused."""
    import torch.distributed as dist

    builder, kw, data = _jobs()["fixed_cur"]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        merged = mesh_sharded_stream(BUILDERS[builder](**kw), data, PANEL)
        single = stream_panels(BUILDERS[builder](**kw), data, PANEL)
        single.offset = N
        _assert_digests(_digest(merged), _digest(single), 1)
        with pytest.raises(ValueError, match="fresh state"):
            mesh_sharded_stream(single, data, PANEL)
        unpadded = streaming_cur_init(None, M, N, COL, ROW, device="cpu", **{
            k: v for k, v in kw.items() if k != "tel_omega"})
        with pytest.raises(ValueError, match="unpadded"):
            mesh_sharded_stream(unpadded, data, 64)
    finally:
        dist.destroy_process_group()
