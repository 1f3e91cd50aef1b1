"""Tensor parallelism and data parallelism of the port's train steps
(``repro_torch.distributed``, ``repro_torch.launch.mesh``, the ``mesh=`` of
``repro_torch.train``, ``--mesh d x m`` of ``repro_torch.launch.train``)
against the JAX reference, in gloo ranks on the CPU.

The model is the reference's ``tiny_cfg`` (``tests/multidev_scenario.py``:
llama3.2-1b's smoke config at d_model 128, d_ff 512, 8 query and 4 KV heads
of 16, vocab 512), fp32, from the reference's ``init_params`` through
``convert`` (each rank cut to its block by ``shard_params``); a batch of
8 × 64 numpy tokens; the reference scenario's AdamW (lr 1e-2, no clip) and
compression (rank 16, factor 4, min_dim 128), the reference's sketches
handed in through ``sketches=``.

* 1×2 (two ranks): the plain step's loss, every gradient block and every
  updated block against the reference's single-device ``make_train_step``;
  the compressed step's loss, ``comp/*`` and updated blocks against the
  reference's ``make_compressed_train_step`` on a 1×1 mesh. 2×1 (the same
  two ranks): both steps against the same references. gemma3-12b's and
  musicgen-large's smoke configs at the same widths, cut to their last two
  layers and one (an ``ATTN_LOCAL`` layer, an untied ``lm_head`` cut over
  its vocab columns, soft-capped logits; a GELU FFN): both steps at 1×2
  against their references, in one spawn.
* 2×2 (four ranks): both steps against the port's 2×1; the CLI at
  ``--mesh 2x2 --grad-compress`` through a crash; the compressed step's
  data-parallel all-reduce bytes below the plain step's.

Tolerances, none looser than the reference's own sharded-equals-single
bounds (``multidev_scenario.py``: loss 1e-4, parameters 3e-3 absolute):
the loss 1e-5 relative and each gradient block 1e-4 relative (Frobenius:
the same fp32 products summed over the model axis in another order, ten
times the 1e-5 the fp32 logits are held to in
``tests/test_torch_models.py``; a few entries of a leaf are sums that
cancel far below its largest entry, and a run that sums them in another
order moves them by up to 1e-4 of it, so no single entry is held to the
leaf's scale); updated parameters 3e-3
absolute, the reference's (one AdamW step moves an entry by about lr, in
the direction of its gradient's sign); ``comp/ratio`` and
``comp/wire_floats`` equal (they read the logical shapes), ``comp/rel_err``
1e-3 relative, ``comp/ef_norm`` 1e-4 relative (the reconstruction solves
small least-squares problems from sums in another order). 2×2 against 2×1:
the same bounds. The largest errors are printed (``-s``).

The ranks are spawned processes running :func:`_rank` (this module imports
JAX only inside its fixtures, so that the ranks stay light), one spawn per
world: two ranks for 1×2 and 2×1, four for 2×2. The reference's default
mesh 4×2 (eight ranks) and its 25-step convergence run are ``slow``.
"""

import dataclasses
import datetime
import queue
import shutil
import tempfile
import time
import warnings

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.distributed import Mesh, ParallelismRules, shard_params

TINY = dict(d_model=128, d_ff=512, n_heads=8, n_kv_heads=4, head_dim=16, vocab_size=512)
# each arch's smoke config at tiny_cfg's widths: llama is tiny_cfg; gemma3
# adds an ATTN_LOCAL layer (window 32 of the 64 positions) and an untied
# lm_head, with soft-capped logits (no config of the repo caps them; the
# case holds the path); musicgen a GELU FFN, an untied lm_head and as many
# KV heads as query heads. The last LAYERS of their patterns are kept (the
# reference compiles each layer kind of a stack apart)
ARCHS = {"llama3.2-1b": TINY, "gemma3-12b": dict(TINY, logit_softcap=30.0),
         "musicgen-large": dict(TINY, n_kv_heads=8)}
LAYERS = {"gemma3-12b": 2, "musicgen-large": 1}
LLAMA = "llama3.2-1b"
OC = dict(lr=1e-2, clip_norm=None)
CCFG = dict(rank=16, sketch_factor=4, min_dim=128)
B, S = 8, 64
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 3e-3
REL_ERR_TOL, EF_TOL = 1e-3, 1e-4
ERRORS = {}  # the largest error of each kind, printed at the end


def _sized(cfg, arch: str):
    """``cfg`` (either package's smoke config of ``arch``) at this file's size."""
    cfg = dataclasses.replace(cfg, **ARCHS[arch])
    n = LAYERS.get(arch, cfg.n_layers)
    return dataclasses.replace(cfg, n_layers=n, pattern=cfg.pattern[len(cfg.pattern) - n:])


def _cfg(arch: str = LLAMA):
    return _sized(get_arch(arch).smoke_config(), arch)


def _note(kind: str, err: float) -> float:
    ERRORS[kind] = max(ERRORS.get(kind, 0.0), err)
    return err


def _rel(got, want) -> float:
    """``got``'s relative Frobenius error against ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.linalg.norm(want))
    err = float(np.linalg.norm(got - want))
    return err / scale if scale > 0 else err


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _run_steps(shape, case, cfg, oc, ccfg, counts):
    """One mesh's plain and compressed steps on this rank: the loss, the
    gradient blocks, the updated blocks and the metrics of each, and the
    all-reduce bytes of each step on the data axes' group."""
    import torch.distributed as dist

    from repro_torch.distributed import activation_sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import make_compressed_train_step, make_loss_fn, make_train_step
    from repro_torch.train import train_step as pts

    mesh = make_host_mesh(*shape)
    d, at = mesh.shape["data"], mesh.index("data")
    batch = {"tokens": torch.from_numpy(case["tokens"][at * B // d:(at + 1) * B // d])}
    out = {}
    state = convert.train_state(case["state"], cfg, "cpu", mesh=mesh)
    with activation_sharding(mesh):
        _, _, grads = pts._value_and_grad(make_loss_fn(cfg), state["params"], batch)
    for g in grads.values():
        if d > 1:
            dist.all_reduce(g, group=mesh.group("data"))
            g.div_(d)
    out["grads"] = {k: v.numpy() for k, v in grads.items()}
    counts.clear()
    state, m = make_train_step(cfg, oc, remat=None, mesh=mesh)(state, batch)
    out["plain"] = dict(metrics={k: float(v) for k, v in m.items()},
                        params={k: v.detach().numpy().copy()
                                for k, v in state["params"].state_dict().items()},
                        dp_bytes=counts.get(mesh.group("data"), 0))

    state = convert.train_state(case["state"], cfg, "cpu", mesh=mesh)
    cstep, init_err = make_compressed_train_step(cfg, oc, ccfg, mesh=mesh, remat=None)
    state["err"] = init_err(state["params"])
    sketches = {i: tuple(convert.sketch_from_arrays(k, a, device="cpu") for k, a in sk)
                for i, sk in case["sketches"].items()}
    counts.clear()
    state, m = cstep(state, batch, 0, sketches=sketches)
    out["compressed"] = dict(metrics={k: float(v) for k, v in m.items()},
                             params={k: v.detach().numpy().copy()
                                     for k, v in state["params"].state_dict().items()},
                             err_shapes={k: tuple(v.shape) for k, v in state["err"].items()},
                             dp_bytes=counts.get(mesh.group("data"), 0))
    return out


def _control(case, cfg):
    """1×2 gradients with ``reduce_from_tp``'s backward all-reducing again
    (the doubled gradient the gate must catch)."""
    import torch.distributed as dist

    from repro_torch.distributed import activation_sharding
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import make_loss_fn
    from repro_torch.train import train_step as pts

    mesh = make_host_mesh(1, 2)
    state = convert.train_state(case["state"], cfg, "cpu", mesh=mesh)
    real = sharding._ReduceFromTP.backward

    def again(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=mesh.group("model"))
        return g, None

    sharding._ReduceFromTP.backward = staticmethod(again)
    try:
        with activation_sharding(mesh):
            _, _, grads = pts._value_and_grad(make_loss_fn(cfg), state["params"],
                                              {"tokens": torch.from_numpy(case["tokens"])})
    finally:
        sharding._ReduceFromTP.backward = real
    return {k: v.numpy() for k, v in grads.items()}


def _converge(case, cfg, ccfg):
    """``scenario_compressed_step_converges`` at 4×2: 25 compressed steps on
    ``SyntheticLM`` batches of 16 × 64 (each rank its share), the
    scenario's schedule; the losses."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.device import fold_in
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import OptimizerConfig, make_compressed_train_step

    mesh = make_host_mesh(4, 2)
    oc = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=30)
    state = convert.train_state(case["state"], cfg, "cpu", mesh=mesh)
    cstep, init_err = make_compressed_train_step(cfg, oc, ccfg, mesh=mesh, remat=None)
    state["err"] = init_err(state["params"])
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=16, seq_len=64), device="cpu")
    at, losses = mesh.index("data"), []
    for i in range(25):
        batch = {k: v[at * 4:(at + 1) * 4] for k, v in data.batch_at(i).items()}
        state, m = cstep(state, batch, fold_in(9, i))
        losses.append(float(m["loss"]))
    return losses


def _rank(rank, world, store, jobs, out_q):
    """One gloo rank: each job in turn (``("steps", (d, m))`` of llama,
    ``("steps", (d, m), arch)``, ``"control"`` or ``("cli", argv)``), with
    the all-reduce bytes counted by group; ``jobs["cases"]`` holds each
    arch's reference case."""
    import torch.distributed as dist

    from repro_torch.train import CompressionConfig, OptimizerConfig

    torch.set_num_threads(2)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    real, counts = dist.all_reduce, {}

    def counted(t, *args, group=None, **kwargs):
        counts[group] = counts.get(group, 0) + t.numel() * t.element_size()
        return real(t, *args, group=group, **kwargs)

    dist.all_reduce = counted
    try:
        results = {}
        oc, ccfg = OptimizerConfig(**OC), CompressionConfig(**CCFG)
        for job in jobs["run"]:
            arch = job[2] if isinstance(job, tuple) and len(job) > 2 else LLAMA
            case, cfg = jobs["cases"][arch], _cfg(arch)
            if job == "control":
                results[job] = _control(case, cfg)
            elif job == "converge":
                results[job] = _converge(case, cfg, ccfg)
            elif job[0] == "steps":
                results[job] = _run_steps(job[1], case, cfg, oc, ccfg, counts)
            else:
                from repro_torch.launch.train import main

                rep = main(list(job[1]) + ["--ckpt-dir", f"{jobs['ckpt']}/run"])
                results["cli"] = dict(steps_run=rep.steps_run, restarts=rep.restarts,
                                      losses=list(map(float, rep.losses)))
        out_q.put((rank, results))
    finally:
        dist.all_reduce = real
        dist.destroy_process_group()


def _spawn(world: int, jobs: dict, timeout: float = 240.0) -> dict:
    """Run :func:`_rank` in ``world`` spawned processes. They meet at a file
    of their own, not a TCP port: another test's ranks, spawned at the same
    time by another worker, can never join them."""
    mp = torch.multiprocessing
    out_q = mp.get_context("spawn").Queue()
    store = tempfile.mkdtemp()
    procs = mp.start_processes(_rank, args=(world, f"{store}/store", jobs, out_q), nprocs=world,
                               join=False, start_method="spawn")
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, out = out_q.get(timeout=1.0)
                results[rank] = out
            except queue.Empty:
                procs.join(timeout=0)  # raises if a rank failed
                assert time.monotonic() < deadline, "ranks did not report"
        while not procs.join(timeout=1.0):
            assert time.monotonic() < deadline, "ranks did not exit"
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        shutil.rmtree(store, ignore_errors=True)
    return results


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------


def _reference(arch: str = LLAMA, batch: int = B):
    """The reference's tiny model of ``arch`` and its single-device results: the
    initial state (numpy), the tokens, the gradients, the plain step's and
    the compressed step's (on a 1×1 mesh) loss, metrics and parameters,
    and the compressed step's sketches by leaf index (arrays)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as rget
    from repro.distributed.sharding import ParallelismRules as RRules
    from repro.models import init_params
    from repro.train import (CompressionConfig, OptimizerConfig, init_opt_state, make_loss_fn,
                             make_compressed_train_step, make_train_step)
    from repro.train.grad_compress import _sketches_for, is_compressible

    cfg_r = _sized(rget(arch).smoke_config(), arch)
    oc, ccfg = OptimizerConfig(**OC), CompressionConfig(**CCFG)
    params = init_params(jax.random.key(0), cfg_r)
    tokens = np.random.default_rng(1).integers(0, TINY["vocab_size"], (batch, S)).astype(np.int32)
    b = {"tokens": jnp.asarray(tokens)}
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    state = {"params": params, "opt": init_opt_state(params, oc)}
    (loss, _), grads = jax.jit(jax.value_and_grad(make_loss_fn(cfg_r), has_aux=True))(params, b)
    st1, m1 = jax.jit(make_train_step(cfg_r, oc, remat=None))(state, b)

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    cstep, init_err = make_compressed_train_step(cfg_r, oc, ccfg, mesh, RRules(dp_axes=("data",)),
                                                 remat=None)
    key = jax.random.key(9)
    with warnings.catch_warnings():  # the frozen reference calls jax.lax.pvary, deprecated
        warnings.filterwarnings("ignore", "jax.lax.pvary", DeprecationWarning)
        stc, mc = cstep({**state, "err": init_err(params)}, b, key)
    sketches = {}
    for i, g in enumerate(jax.tree.leaves(grads)):
        if is_compressible(g, ccfg):
            sketches[i] = tuple(convert.sketch_arrays(S_)
                                for S_ in _sketches_for(jax.random.fold_in(key, i),
                                                        g.shape[-2:], ccfg))
    cfg = _cfg(arch)
    return dict(
        case=dict(state=np_tree(state), tokens=tokens, sketches=sketches),
        loss=float(loss), grads=convert.model_state(np_tree(grads), cfg),
        plain=dict(metrics={k: float(v) for k, v in m1.items()},
                   params=convert.model_state(np_tree(st1["params"]), cfg)),
        compressed=dict(metrics={k: float(v) for k, v in mc.items()},
                        params=convert.model_state(np_tree(stc["params"]), cfg)))


def _blocks(tree: dict, shape: tuple, rank: int) -> dict:
    """Rank ``rank``'s blocks of a whole tree by port names."""
    mesh = Mesh(dict(zip(("data", "model"), shape)), rank)
    return shard_params(tree, ParallelismRules(), mesh)


@pytest.fixture(scope="module", autouse=True)
def _report_errors():
    yield
    print("largest errors:", {k: f"{v:.3g}" for k, v in sorted(ERRORS.items())})


@pytest.fixture(scope="module")
def ref():
    return _reference()


@pytest.fixture(scope="module")
def two_ranks(ref):
    return _spawn(2, dict(cases={LLAMA: ref["case"]}, run=[("steps", (1, 2)), ("steps", (2, 1)),
                                                 "control"]))


@pytest.fixture(scope="module")
def runs(ref, two_ranks):
    """``runs(arch) → (reference, the two ranks' results)``: llama's are
    the module's; the other archs' references and their one 1×2 spawn are
    made on first use."""
    out = {LLAMA: (ref, two_ranks)}

    def get(arch):
        if arch not in out:
            refs = {a: _reference(a) for a in ARCHS if a != LLAMA}
            res = _spawn(2, dict(cases={a: r["case"] for a, r in refs.items()},
                                 run=[("steps", (1, 2), a) for a in refs]))
            for a, r in refs.items():
                out[a] = (r, {rank: {("steps", (1, 2)): x[("steps", (1, 2), a)]}
                              for rank, x in res.items()})
        return out[arch]

    return get


# llama's 1×2 and 2×1 keep their ids; the other dense layouts run at 1×2
CASES = pytest.mark.parametrize(
    "arch, shape", [(LLAMA, (1, 2)), (LLAMA, (2, 1)), ("gemma3-12b", (1, 2)),
                    ("musicgen-large", (1, 2))],
    ids=["shape0", "shape1", "gemma3-12b-1x2", "musicgen-large-1x2"])


@pytest.fixture(scope="module")
def four_ranks(ref):
    with tempfile.TemporaryDirectory() as d:
        cli = ("--smoke", "--device", "cpu", "--mesh", "2x2", "--grad-compress", "--steps", "3",
               "--batch", "4", "--seq", "16", "--ckpt-every", "1", "--fail-at-step", "1")
        return _spawn(4, dict(cases={LLAMA: ref["case"]}, ckpt=d,
                              run=[("steps", (2, 2)), ("cli", cli)]))


def _check_against(got: dict, want: dict, shape: tuple, rank: int, kind: str, *, tol=PARAM_TOL):
    want = _blocks(want, shape, rank)
    assert set(got) == set(want)
    for k, w in want.items():
        err = float(np.abs(got[k].astype(np.float64) - w).max())
        assert _note(kind, err) <= tol, (k, err)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@CASES
def test_plain_step_matches_single_device_reference(runs, arch, shape):
    ref, ranks = runs(arch)
    for rank, res in ranks.items():
        r = res[("steps", shape)]
        assert _note("loss", abs(r["plain"]["metrics"]["loss"] / ref["loss"] - 1)) <= LOSS_TOL
        for k, g in _blocks(ref["grads"], shape, rank).items():
            assert _note("grad", _rel(r["grads"][k], g)) <= GRAD_TOL, k
        _check_against(r["plain"]["params"], ref["plain"]["params"], shape, rank, "param")
        m, want = r["plain"]["metrics"], ref["plain"]["metrics"]
        assert _note("grad_norm", abs(m["grad_norm"] / want["grad_norm"] - 1)) <= LOSS_TOL


@CASES
def test_compressed_step_matches_reference(runs, arch, shape):
    ref, ranks = runs(arch)
    want = ref["compressed"]["metrics"]
    for rank, res in ranks.items():
        r = res[("steps", shape)]["compressed"]
        m = r["metrics"]
        assert _note("loss", abs(m["loss"] / want["loss"] - 1)) <= LOSS_TOL
        assert m["comp/ratio"] == pytest.approx(want["comp/ratio"], rel=1e-6)
        assert m["comp/wire_floats"] == want["comp/wire_floats"]
        assert m["comp/dense_floats"] == want["comp/dense_floats"]
        if shape[0] == 1:  # one data-parallel worker: its residual is the reference's
            rel = abs(m["comp/rel_err"] / want["comp/rel_err"] - 1)
            assert _note("rel_err", rel) <= REL_ERR_TOL
            assert _note("ef_norm", abs(m["comp/ef_norm"] / want["comp/ef_norm"] - 1)) <= EF_TOL
        _check_against(r["params"], ref["compressed"]["params"], shape, rank, "param")


def test_blocks_are_halves_and_the_control_fails(ref, two_ranks):
    """1×2 holds half of every sharded leaf (the EF residuals too); the
    doubled backward of ``reduce_from_tp`` breaks the gradient bound."""
    cfg = _cfg()
    res = two_ranks[0][("steps", (1, 2))]
    assert res["plain"]["params"]["embed.tok"].shape == (TINY["vocab_size"] // 2, TINY["d_model"])
    assert res["plain"]["params"]["blocks.0.mixer.w_o"].shape == (
        TINY["n_heads"] * TINY["head_dim"] // 2, TINY["d_model"])
    assert res["compressed"]["err_shapes"]["segments.0.0.ffn.w_down"] == (
        cfg.n_layers, TINY["d_ff"] // 2, TINY["d_model"])
    want = _blocks(ref["grads"], (1, 2), 0)
    worst = max(_rel(two_ranks[0]["control"][k], g) for k, g in want.items())
    assert worst > GRAD_TOL * 100, worst


def test_two_by_two_matches_two_by_one(two_ranks, four_ranks):
    """2×2 against the port's 2×1: each rank's blocks against the same
    blocks of the 2×1 rank with its data coordinate."""
    for rank, res in four_ranks.items():
        r = res[("steps", (2, 2))]
        other = two_ranks[rank // 2][("steps", (2, 1))]
        for step in ("plain", "compressed"):
            m, want = r[step]["metrics"], other[step]["metrics"]
            assert _note("loss", abs(m["loss"] / want["loss"] - 1)) <= LOSS_TOL
            _check_against(r[step]["params"], other[step]["params"], (2, 2), rank, "param 2x2")
        for k, g in _blocks(other["grads"], (2, 2), rank).items():
            assert _note("grad", _rel(r["grads"][k], g)) <= GRAD_TOL, k


def test_compressed_step_reduces_data_parallel_bytes(four_ranks):
    """The port's form of ``scenario_compressed_reduces_wire_bytes``: the
    compressed step all-reduces fewer bytes over the data axes than the
    plain step."""
    for res in four_ranks.values():
        r = res[("steps", (2, 2))]
        assert 0 < r["compressed"]["dp_bytes"] < r["plain"]["dp_bytes"], (
            r["compressed"]["dp_bytes"], r["plain"]["dp_bytes"])


def test_launch_train_cli_at_mesh_2x2(four_ranks):
    for res in four_ranks.values():
        cli = res["cli"]
        assert cli["steps_run"] == 3 and cli["restarts"] == 1
        assert all(np.isfinite(cli["losses"]))
    losses = {tuple(res["cli"]["losses"]) for res in four_ranks.values()}
    assert len(losses) == 1, losses


def test_error_state_needs_a_rank_or_a_mesh():
    with pytest.raises(ValueError, match="rank or a mesh"):
        convert.error_state({}, _cfg(), device="cpu")


@pytest.mark.slow
def test_default_mesh_4x2_matches_single_device_reference(ref):
    """The reference CLI's default mesh, 4×2 in eight ranks
    (``scenario_sharded_equals_single``), plain and compressed; and the
    compressed step's 25-step convergence there
    (``scenario_compressed_step_converges``)."""
    res = _spawn(8, dict(cases={LLAMA: ref["case"]}, run=[("steps", (4, 2)), "converge"]),
                 timeout=600.0)
    for rank, out in res.items():
        r = out[("steps", (4, 2))]
        assert _note("loss", abs(r["plain"]["metrics"]["loss"] / ref["loss"] - 1)) <= LOSS_TOL
        for k, g in _blocks(ref["grads"], (4, 2), rank).items():
            assert _note("grad", _rel(r["grads"][k], g)) <= GRAD_TOL, k
        for step in ("plain", "compressed"):
            _check_against(r[step]["params"], ref[step]["params"], (4, 2), rank, "param")
        losses = out["converge"]
        assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
