"""FSDP at run time (``ParallelismRules(fsdp=True)``: each leaf's ``fsdp``
dim cut over the data axis, gathered where a block runs, its gradient
reduce-scattered) against the JAX reference, in gloo ranks on the CPU.

Three smoke configs, fp32: llama3.2-1b (the dense stack), deepseek-v2-lite
(MLA; MoE experts laid out ``("ep", "fsdp", "-")``, the router
``("fsdp", "-")``) and the vision model (``vision_proj`` ``("-", "fsdp")``,
a cross layer), from the reference's ``init_params`` through ``convert``,
each rank cut to its blocks by ``shard_params``; a batch of 4 × 16 numpy
tokens (and vision embeddings); the reference's AdamW (lr 1e-2, no clip).

* 2×1 (two ranks) and 2×2 (four ranks, one spawn): the plain step's loss,
  every gradient block and every updated block against the reference's
  single-device ``make_train_step`` on the global batch, within
  ``tests/test_torch_tp.py``'s bounds (loss 1e-5 relative, gradients 1e-4
  relative Frobenius, updated parameters 3e-3 absolute). One block is
  exempt by name (``TP_ONLY_AT_2X2``): at 2×2 the vision model's first
  self-attention ``w_k`` reads up to 1.11e-4 of the reference's with FSDP
  and without, so there it is held equal to the same rank's gradient
  without FSDP, and that one to its recorded reading.
* 1×4, the same four ranks (``WHOLE``): the layouts the run time keeps
  whole (``sharding.whole_leaves``) on llama3.2-1b's smoke config — its 2
  KV heads (query heads split), 6 query heads (every rank runs them all)
  and a vocab of 255 with an untied head — the plain step, prefill and
  decode against the reference, within the same bounds.
* 2×1: prefill's logits and 4 decode steps' (fed the prompt's next
  tokens) of each rank's rows against the reference's, within
  ``tests/test_torch_tp_serve.py``'s 1e-5 of ``max(1, max |logit|)``.
* In this process: ``init_params(mesh=, rules=)`` draws each rank's
  blocks bit for bit as ``shard_params`` cuts them, and they are the
  blocks of the reference's ``leaf_pspec`` under ``fsdp=True``; the
  compressed step raises under FSDP, as the reference's does; a census of
  one FSDP step on ``meta`` (a ``fake`` group of the same world) counts the
  all-gathers and reduce-scatters, calls and bytes, that the gloo ranks'
  census of their step counted.
"""

import datetime
import queue
import shutil
import tempfile
import time

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.distributed import Mesh, ParallelismRules
from repro_torch.distributed import sharding as ps

ARCHS = ["llama3.2-1b", "deepseek-v2-lite-16b", "llama-3.2-vision-90b"]
SHAPES = {"2x1": (2, 1), "2x2": (2, 2)}
B, S, NDEC = 4, 16, 4
OC = dict(lr=1e-2, clip_norm=None)
LOSS_TOL, GRAD_TOL, PARAM_TOL, LOGIT_TOL = 1e-5, 1e-4, 3e-3, 1e-5
FSDP, TP = ParallelismRules(fsdp=True), ParallelismRules()
COLLECTIVES = ("all-gather", "reduce-scatter")
# the layouts the run time keeps whole (``sharding.whole_leaves``), at model
# axis 4 on llama3.2-1b's smoke config (4 query, 2 KV heads): its overrides
# and the leaves kept whole
WHOLE_SHAPE = (1, 4)
WHOLE = {
    "kv-heads": ({}, {"w_k", "w_v"}),  # the query heads split, each rank reads one KV head
    "query-heads": ({"n_heads": 6}, {"w_q", "w_k", "w_v"}),  # every rank runs all 6 heads
    "vocab": ({"vocab_size": 255, "n_kv_heads": 4, "tie_embeddings": False},
              {"tok", "lm_head"}),
}
# the one gradient block held to the model axis's run without FSDP at 2x2
# rather than to the reference: the vision model's first self-attention
# layer's ``w_k``, whose entries cancel. Its blocks read 5.4e-5, 1.11e-4,
# 6.0e-5 and 1.06e-4 (ranks 0-3) of the reference's, relative Frobenius,
# with FSDP and without alike (the two blocks are equal bit for bit): fp32
# sums over the model axis in another order. The worst reading, recorded:
TP_ONLY_AT_2X2 = {("llama-3.2-vision-90b", "blocks.1.mixer.w_k"): 1.11e-4}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.linalg.norm(want))
    err = float(np.linalg.norm(got - want))
    return err / scale if scale > 0 else err


def _blocks(tree: dict, shape: tuple, rank: int, cfg) -> dict:
    return ps.shard_params(tree, FSDP, Mesh(dict(zip(("data", "model"), shape)), rank), cfg=cfg)


def _whole_cfgs(get) -> dict:
    """The :data:`WHOLE` cases' configs through ``get`` (the port's or the
    reference's ``get_arch``)."""
    import dataclasses

    base = get("llama3.2-1b").smoke_config()
    return {k: dataclasses.replace(base, **over) for k, (over, _) in WHOLE.items()}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _rows(x, mesh):
    d, at = mesh.shape["data"], mesh.index("data")
    return None if x is None else torch.from_numpy(x[at * len(x) // d:(at + 1) * len(x) // d])


def _grads(case, cfg, mesh, batch, rules):
    """The rank's gradient blocks under ``rules``, the data axes' mean."""
    import torch.distributed as dist

    from repro_torch.distributed import activation_sharding
    from repro_torch.train import make_loss_fn
    from repro_torch.train import train_step as pts

    params = convert.model_params(case["state"]["params"], cfg, "cpu", mesh=mesh, rules=rules)
    fsdp = ps.fsdp_names(params)
    with activation_sharding(mesh, rules):
        _, _, grads = pts._value_and_grad(make_loss_fn(cfg), params, batch)
    for name, g in grads.items():
        if name not in fsdp and mesh.shape["data"] > 1:  # an FSDP block's arrives summed
            dist.all_reduce(g, group=mesh.group("data"))
        g.div_(mesh.shape["data"])
    return {k: v.numpy() for k, v in grads.items()}


def _train(case, cfg, mesh, rules=FSDP):
    """The rank's gradient blocks under ``rules`` (and, under FSDP, without
    it), the plain step's loss, updated blocks and its census's
    collectives."""
    from repro_torch.launch.hlo_census import Census
    from repro_torch.train import OptimizerConfig, make_train_step

    batch = {"tokens": _rows(case["tokens"], mesh)}
    if case["vision"] is not None:
        batch["vision"] = _rows(case["vision"], mesh)
    state = convert.train_state(case["state"], cfg, "cpu", mesh=mesh, rules=rules)
    dims = {n: p.fsdp_dim for n, p in state["params"].named_parameters()
            if hasattr(p, "fsdp_dim")}
    step = make_train_step(cfg, OptimizerConfig(**OC), remat=None, mesh=mesh, rules=rules)
    with Census() as census:
        state, m = step(state, batch)
    return dict(loss=float(m["loss"]), grads=_grads(case, cfg, mesh, batch, rules),
                tp_grads=_grads(case, cfg, mesh, batch, TP) if rules.fsdp else None, fsdp=dims,
                params={k: v.detach().numpy().copy()
                        for k, v in state["params"].state_dict().items()},
                collectives=census.result()["collectives"])


def _serve(case, cfg, mesh, rules=FSDP):
    """The rank's prefill logits and its decode steps' logits."""
    from repro_torch.distributed import activation_sharding
    from repro_torch.models import decode_step, prefill

    model = convert.model_params(case["state"]["params"], cfg, "cpu", mesh=mesh, rules=rules)
    toks = _rows(case["tokens"], mesh)
    with activation_sharding(mesh, rules):
        lg, cache = prefill(model, cfg, toks[:, :S - NDEC], S, _rows(case["vision"], mesh))
        steps = [decode_step(model, cfg, cache, toks[:, S - NDEC + i:S - NDEC + i + 1])[0]
                 for i in range(NDEC)]
    return dict(prefill=lg.numpy(), steps=[x.numpy() for x in steps])


def _rank(rank, world, store, jobs, out_q):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(2)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_host_mesh(*jobs["shape"])
        results = {}
        for arch in ARCHS:
            case, cfg = jobs["cases"][arch], get_arch(arch).smoke_config()
            results[("train", arch)] = _train(case, cfg, mesh)
            if jobs["serve"]:
                results[("serve", arch)] = _serve(case, cfg, mesh)
        if jobs.get("whole"):  # the whole-leaf layouts on a model axis of the same ranks
            mesh = make_host_mesh(*WHOLE_SHAPE)
            for name, cfg in _whole_cfgs(get_arch).items():
                case = jobs["cases"][name]
                results[("train", name)] = _train(case, cfg, mesh, TP)
                results[("serve", name)] = _serve(case, cfg, mesh, TP)
        out_q.put((rank, results))
    finally:
        dist.destroy_process_group()


class _Ranks:
    """:func:`_rank` in ``world`` spawned processes meeting at a file of
    their own, started at once and collected by :meth:`results`; a rank
    that fails terminates the others."""

    def __init__(self, world: int, jobs: dict):
        mp = torch.multiprocessing
        self.world, self.out_q = world, mp.get_context("spawn").Queue()
        self.store = tempfile.mkdtemp()
        self.procs = mp.start_processes(_rank, args=(world, f"{self.store}/store", jobs,
                                                     self.out_q),
                                        nprocs=world, join=False, start_method="spawn")

    def results(self, timeout: float = 300.0) -> dict:
        results, deadline = {}, time.monotonic() + timeout
        try:
            while len(results) < self.world:
                try:
                    rank, out = self.out_q.get(timeout=1.0)
                    results[rank] = out
                except queue.Empty:
                    self.procs.join(timeout=0)  # raises if a rank failed
                    assert time.monotonic() < deadline, "ranks did not report"
            while not self.procs.join(timeout=1.0):
                assert time.monotonic() < deadline, "ranks did not exit"
        finally:
            self.close()
        return results

    def close(self):
        for p in self.procs.processes:
            if p.is_alive():
                p.terminate()
        shutil.rmtree(self.store, ignore_errors=True)


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------


def _case(cfg_r, cfg) -> dict:
    """The reference's smoke model ``cfg_r`` (the port's ``cfg``; every cross
    gate 0.5) and its AdamW state, and the global batch, as numpy."""
    import jax
    import jax.numpy as jnp

    from repro.models import init_params
    from repro.train import OptimizerConfig, init_opt_state

    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vision = (rng.standard_normal((B, cfg.n_patches, cfg.d_vision)).astype(np.float32)
              if cfg.d_vision else None)
    params = init_params(jax.random.key(0), cfg_r)
    if cfg.d_vision:  # the gates start at 0, where a cross layer adds nothing
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.full_like(x, 0.5) if "gate" in jax.tree_util.keystr(p) else x,
            params)
    state = {"params": params, "opt": init_opt_state(params, OptimizerConfig(**OC))}
    return dict(state=jax.tree.map(np.asarray, state), tokens=tokens, vision=vision)


def _reference(case, cfg_r, cfg) -> dict:
    """The reference's single-device runs of ``case`` on the global batch:
    the loss, gradients and the plain step's parameters; prefill's logits
    and each decode step's."""
    import jax
    import jax.numpy as jnp

    from repro.models import decode_step, prefill
    from repro.train import OptimizerConfig, make_loss_fn, make_train_step

    tokens, vision = case["tokens"], case["vision"]
    state = jax.tree.map(jnp.asarray, case["state"])
    params = state["params"]
    b = {"tokens": jnp.asarray(tokens)}
    if vision is not None:
        b["vision"] = jnp.asarray(vision)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    (loss, _), grads = jax.jit(jax.value_and_grad(make_loss_fn(cfg_r), has_aux=True))(params, b)
    st1, _ = jax.jit(make_train_step(cfg_r, OptimizerConfig(**OC), remat=None))(state, b)
    lg, cache = jax.jit(lambda p, t, v: prefill(p, cfg_r, t, S, v))(
        params, jnp.asarray(tokens[:, :S - NDEC]), b.get("vision"))
    step = jax.jit(lambda p, c, t: decode_step(p, cfg_r, c, t))
    steps = []
    for i in range(NDEC):
        out, cache = step(params, cache, jnp.asarray(tokens[:, S - NDEC + i:S - NDEC + i + 1]))
        steps.append(np.asarray(out))
    return dict(loss=float(loss), grads=convert.model_state(np_tree(grads), cfg),
                params=convert.model_state(np_tree(st1["params"]), cfg),
                prefill=np.asarray(lg), steps=steps)


@pytest.fixture(scope="module")
def runs():
    """``(references by arch or WHOLE case, results by mesh name and
    rank)``: the 2×1 spawn (training and serving) and the 2×2 one
    (training; then the WHOLE cases' training and serving at 1×4) start
    once the models are drawn; the reference's runs go on here meanwhile."""
    from repro.configs import get_arch as rget

    cfgs = {a: (rget(a).smoke_config(), get_arch(a).smoke_config()) for a in ARCHS}
    ours = _whole_cfgs(get_arch)
    cfgs.update({k: (c, ours[k]) for k, c in _whole_cfgs(rget).items()})
    cases = {k: _case(*c) for k, c in cfgs.items()}
    two = _Ranks(2, dict(cases=cases, shape=(2, 1), serve=True))
    four = _Ranks(4, dict(cases=cases, shape=(2, 2), serve=False, whole=True))
    try:
        refs = {k: _reference(cases[k], *c) for k, c in cfgs.items()}
    except BaseException:
        two.close()
        four.close()
        raise
    return refs, {"2x1": two.results(), "2x2": four.results()}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(SHAPES))
def test_fsdp_plain_step_matches_single_device_reference(runs, arch, mesh):
    refs, res = runs
    ref, shape, cfg = refs[arch], SHAPES[mesh], get_arch(arch).smoke_config()
    seen_fsdp = False
    for rank, out in res[mesh].items():
        r = out[("train", arch)]
        assert abs(r["loss"] / ref["loss"] - 1) <= LOSS_TOL
        want = _blocks(ref["grads"], shape, rank, cfg)
        assert set(want) == set(r["grads"])
        for k, g in want.items():
            reading = TP_ONLY_AT_2X2.get((arch, k)) if mesh == "2x2" else None
            if reading is None:
                assert _rel(r["grads"][k], g) <= GRAD_TOL, (k, _rel(r["grads"][k], g))
                continue
            # FSDP leaves the block as the model axis computes it: equal to
            # the rank's run without FSDP, cut to its FSDP block, which reads
            # the recorded reading against the reference
            at = rank // shape[1]
            tp = r["tp_grads"][k]
            tp = ps.block(tp, (r["fsdp"][k], shape[0], at)) if k in r["fsdp"] else tp
            assert np.array_equal(r["grads"][k], tp), k
            assert _rel(tp, g) <= 1.25 * reading, (k, _rel(tp, g))
        want = _blocks(ref["params"], shape, rank, cfg)
        assert set(r["params"]) == set(want)
        for k, w in want.items():
            assert float(np.abs(r["params"][k].astype(np.float64) - w).max()) <= PARAM_TOL, k
        seen_fsdp |= r["collectives"]["reduce-scatter"]["count"] > 0
    assert seen_fsdp


@pytest.mark.parametrize("case", list(WHOLE))
def test_whole_leaves_match_single_device_reference(runs, case):
    """At model axis 4 (1×4, the 2×2 spawn's four ranks) the layouts the run
    time keeps whole against the reference's single-device runs: the plain
    step's loss, every gradient block and updated block, prefill's logits
    and the decode steps', within the bounds above. Each kept leaf is whole
    on every rank."""
    refs, res = runs
    ref, cfg = refs[case], _whole_cfgs(get_arch)[case]
    assert ps.whole_leaves(cfg, WHOLE_SHAPE[1]) == WHOLE[case][1]
    for rank, out in res["2x2"].items():
        r = out[("train", case)]
        assert abs(r["loss"] / ref["loss"] - 1) <= LOSS_TOL
        grads, params = (_blocks(ref[k], WHOLE_SHAPE, rank, cfg) for k in ("grads", "params"))
        assert set(grads) == set(r["grads"]) and set(params) == set(r["params"])
        kept = [k for k in params if k.split(".")[-1] in WHOLE[case][1]]
        assert kept and all(r["params"][k].shape == ref["params"][k].shape for k in kept)
        for k, g in grads.items():
            assert _rel(r["grads"][k], g) <= GRAD_TOL, (k, _rel(r["grads"][k], g))
        for k, w in params.items():
            assert float(np.abs(r["params"][k].astype(np.float64) - w).max()) <= PARAM_TOL, k
        r = out[("serve", case)]
        for got, want in zip([r["prefill"], *r["steps"]], [ref["prefill"], *ref["steps"]]):
            want = np.asarray(want, np.float64)
            scale = max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got - want).max()) <= LOGIT_TOL * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_prefill_and_decode_match_reference(runs, arch):
    refs, res = runs
    ref = refs[arch]
    for rank, out in res["2x1"].items():
        r = out[("serve", arch)]
        rows = slice(rank * B // 2, (rank + 1) * B // 2)
        for got, want in zip([r["prefill"], *r["steps"]], [ref["prefill"], *ref["steps"]]):
            want = np.asarray(want, np.float64)[rows]
            scale = max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got - want).max()) <= LOGIT_TOL * scale


def _rule_block(t, spec, shape: dict, rank: int):
    """Rank ``rank``'s block of ``t`` by a reference spec."""
    coords, r = {}, rank
    for name in reversed(list(shape)):
        coords[name] = r % shape[name]
        r //= shape[name]
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        parts, idx = 1, 0
        for a in axes:
            parts, idx = parts * shape[a], idx * shape[a] + coords[a]
        n = t.shape[dim] // parts
        t = t.narrow(dim, idx * n, n)
    return t


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_cut_at_init_equals_shard_params_and_the_rules(arch):
    import jax
    import jax.numpy as jnp

    from repro.distributed import sharding as rs
    from repro_torch import models as pmodels

    cfg = get_arch(arch).smoke_config()
    g = torch.Generator().manual_seed(0)
    named = {k: v.detach() for k, v in pmodels.init_params(g, cfg, device="cpu")
             .named_parameters()}
    seen = set()
    for shape in SHAPES.values():
        fake = dict(zip(("data", "model"), shape))
        rrules = rs.ParallelismRules(fsdp=True).with_mesh(_FakeMesh(fake))
        for rank in range(shape[0] * shape[1]):
            mesh = Mesh(fake, rank)
            cut = ps.shard_params(named, FSDP, mesh, cfg=cfg)
            drawn = pmodels.init_params(torch.Generator().manual_seed(0), cfg, device="cpu",
                                        mesh=mesh, rules=FSDP)
            fsdp = ps.fsdp_names(drawn)
            for name, p in drawn.named_parameters():
                key = tuple(jax.tree_util.SequenceKey(int(k)) if k.isdigit()
                            else jax.tree_util.DictKey(k) for k in ps.ref_path(name))
                spec = tuple(rs.leaf_pspec(key, jax.ShapeDtypeStruct(named[name].shape,
                                                                     jnp.float32),
                                           rrules, _FakeMesh(fake)))
                want = _rule_block(named[name], spec, fake, rank)
                assert torch.equal(cut[name], want) and torch.equal(p.detach(), want), name
                assert (name in fsdp) == any(a == "data" or a == ("data",) for a in spec), name
                leaf = name.split(".")[-1]
                if p.dim() == 3:  # w_gate, w_up ("ep", "fsdp", "-"); w_down ("ep", "-", "fsdp")
                    assert spec[1:] == ((None, "data") if leaf == "w_down" else ("data", None)), \
                        (name, spec)
                    seen.add("experts")
                elif leaf in ("vision_proj", "router"):
                    assert spec == ((None, "data") if leaf == "vision_proj"
                                    else ("data", None)), (name, spec)
                    seen.add(leaf)
    assert seen == {"deepseek-v2-lite-16b": {"experts", "router"},
                    "llama-3.2-vision-90b": {"vision_proj"}}.get(arch, set())


class _FakeMesh:
    """A stand-in for the reference's mesh: its shape and axis names."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def test_compressed_step_raises_under_fsdp_as_the_reference():
    import jax

    from repro.configs import get_arch as rget
    from repro.distributed.sharding import ParallelismRules as RRules
    from repro.train import CompressionConfig as RC
    from repro.train import OptimizerConfig as RO
    from repro.train import make_compressed_train_step as rstep
    from repro_torch.train import CompressionConfig, OptimizerConfig, make_compressed_train_step

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="FSDP") as want:
        rstep(rget("llama3.2-1b").smoke_config(), RO(), RC(), mesh, RRules(fsdp=True))
    with pytest.raises(ValueError, match="FSDP") as got:
        make_compressed_train_step(get_arch("llama3.2-1b").smoke_config(), OptimizerConfig(),
                                   CompressionConfig(), rules=FSDP)
    assert str(got.value) == str(want.value)


@pytest.fixture
def fake_world():
    """``fake_world(n)`` makes this process rank 0 of a ``fake`` process
    group of ``n`` ranks; destroyed after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(n):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh", list(SHAPES))
def test_meta_census_counts_the_ranks_fsdp_collectives(runs, fake_world, mesh):
    from repro_torch import models as pmodels
    from repro_torch.launch.hlo_census import Census
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step

    _, res = runs
    shape = SHAPES[mesh]
    fake_world(shape[0] * shape[1])
    dmesh = make_host_mesh(*shape)
    meta = torch.device("meta")
    for arch in ARCHS:
        cfg = get_arch(arch).smoke_config()
        params = pmodels.init_params(torch.Generator(), cfg, device=meta, mesh=dmesh, rules=FSDP)
        oc = OptimizerConfig(**OC)
        b = B // shape[0]
        batch = {"tokens": torch.zeros((b, S), dtype=torch.int32, device=meta)}
        if cfg.d_vision:
            batch["vision"] = torch.zeros((b, cfg.n_patches, cfg.d_vision), device=meta)
        step = make_train_step(cfg, oc, remat=None, mesh=dmesh, rules=FSDP)
        with Census() as census:
            step({"params": params, "opt": init_opt_state(params, oc)}, batch)
        got = census.result()["collectives"]
        want = res[mesh][0][("train", arch)]["collectives"]
        for kind in COLLECTIVES:
            assert got[kind]["count"] == want[kind]["count"] > 0, (arch, kind)
            assert got[kind]["result_bytes"] == want[kind]["result_bytes"], (arch, kind)
            assert got[kind]["group_size"] == want[kind]["group_size"] == shape[0], (arch, kind)
