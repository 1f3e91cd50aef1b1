"""Expert parallelism and MLA heads on the model axis, and the MoE dispatch
and aux loss on a data axis (``repro_torch.models.moe``,
``repro_torch.models.mla`` and the steps under ``activation_sharding``),
against the JAX reference's one-device runs on the global batch, in gloo
ranks on the CPU.

The models are deepseek-v2-lite's and kimi-k2's smoke configs (d_model 64,
8 experts top-2, deepseek's 2 shared experts and MLA heads, kimi's GQA
with 2 KV heads and 1 shared expert; fp32), from the reference's
``init_params`` through ``convert`` (each rank cut to its block by
``shard_params``). The dispatch runs at ``capacity_factor`` 0.5, so some
assignments drop, with ``moe_dispatch_shards`` 4 (``cap4``: at 2×1 the two
data ranks hold two groups each, no collective) or 1 (``cap1``: the
expert ids gathered over the data axis), or dropless (``dense``,
``dense_moe=True``). A batch of 4 × 32 numpy tokens, 10 new tokens; each
data rank serves its rows. Meshes 1×2, 2×1 (two ranks) and 2×2 (four).

* Serving: greedy tokens equal to the reference's; prefill's last logits
  and each decode step's (fed the reference's tokens) within 1e-5 of the
  largest logit (``tests/test_torch_tp_serve.py``'s bound); every MoE
  call's keep mask equal to the rows of the port's one-process run's
  (``tests/test_torch_moe.py`` holds that run's drops to the
  reference's), and some assignments dropped. kimi's compressed cache at
  the reference's sketches, handed in whole: tokens equal, each head's
  factors within 1e-4 (``tests/test_torch_tp_serve.py``'s bounds).
* The plain step (the global batch's dispatch and aux loss, as the
  reference's ``jit``): loss and ``aux`` within 1e-5 relative, every
  gradient leaf (``router`` and ``w_dkv`` included) within 1e-4 relative
  Frobenius of ``jax.value_and_grad`` of the reference's ``make_loss_fn``
  on the global batch, the gradient norm within 1e-5 relative
  (``tests/test_torch_tp.py``'s bounds). A control: the gates without
  ``copy_to_tp`` break the router's gradient.
* The compressed step (each data rank's loss, dispatch and aux on its own
  rows, as the reference's ``shard_map``): at 1×2 against the reference's
  step on a 1×1 mesh, as ``tests/test_torch_tp.py``; at 2×1 its loss and
  aux the mean of the reference's loss on each shard; ``slow``: 2×1 and
  2×2 against the reference's step body vmapped over the two shards.
* F9 and F10, regressions: 2×1 prefill on the capacity path at
  ``moe_dispatch_shards`` 4 and 1, and the 2×1 plain step's ``aux`` and
  router gradient, against the reference.
* F11, a regression: the plain step at ``microbatch=2`` on 2×1 and 2×2,
  on the capacity path and the dropless one: each data rank takes its
  share of each global microbatch, so loss, ``aux``, the metrics and every
  gradient leaf are those of the reference's ``_grads_microbatched`` on the
  global batch.
* The MoE layer alone at 1×2: routed and shared experts summed once.
* The serve and train CLIs at ``--mesh 1x2`` against ``1x1``.

The ranks are spawned processes running :func:`_rank`, meeting at a file of
their own, one spawn per world; the JAX reference runs in this process
meanwhile.
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

from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch import models as pmodels
from repro_torch import serve as pserve
from repro_torch.distributed import Mesh, ParallelismRules, activation_sharding, shard_params
from repro_torch.distributed import sharding as ps
from repro_torch.models import moe as pmoe

DS, KIMI = "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"
B, S, N = 4, 32, 10
CF = 0.5
PATHS = {"cap4": (dict(capacity_factor=CF, moe_dispatch_shards=4), False),
         "cap1": (dict(capacity_factor=CF, moe_dispatch_shards=1), False),
         "dense": (dict(capacity_factor=CF), True)}
SERVE = [(DS, "cap4"), (DS, "cap1"), (DS, "dense"), (KIMI, "cap4"), (KIMI, "dense")]
TRAIN = [(DS, "cap4"), (KIMI, "cap4")]
MICRO = ["cap4", "dense"]  # F11: the plain step at microbatch 2 on a data axis
TWO, FOUR = [(1, 2), (2, 1)], [(2, 2)]
KC = dict(rank=4, oversample=2, panel=8, decode_panel=4, refresh_every=8)
OC = dict(lr=1e-2, clip_norm=None)
CCFG = dict(rank=8, sketch_factor=2, min_dim=16)
TOL, FAC_TOL = 1e-5, 1e-4
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 3e-3
CLI_SERVE = ["--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "6"]
CLI_TRAIN = ["--smoke", "--device", "cpu", "--arch", DS, "--steps", "2", "--batch", "2", "--seq",
             "16"]


def _cfg(arch: str, path: str = "cap4", mod=pconfigs):
    cfg = mod.get_arch(arch).smoke_config()
    return dataclasses.replace(cfg, **PATHS[path][0])


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"
    return err / scale


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.linalg.norm(want))
    err = float(np.linalg.norm(got - want))
    return err / scale if scale > 0 else err


def _rows(x, shape, rank):
    d = shape[0]
    at = rank // shape[1]
    return x[at * len(x) // d:(at + 1) * len(x) // d]


def _blocks(tree: dict, shape: tuple, rank: int) -> dict:
    return shard_params(tree, ParallelismRules(), Mesh(dict(zip(("data", "model"), shape)), rank))


class _Keeps:
    """Records the keep mask of every :func:`~repro_torch.models.moe.dispatch_plan` call."""

    def __init__(self):
        self.real, self.keeps = pmoe.dispatch_plan, []

    def __enter__(self):
        def recorded(experts, cfg):
            out = self.real(experts, cfg)
            self.keeps.append(out[2].reshape(experts.shape).numpy().copy())
            return out

        pmoe.dispatch_plan = recorded
        return self.keeps

    def __exit__(self, *exc):
        pmoe.dispatch_plan = self.real


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _serve(case, arch, path, mesh):
    """Greedy ``generate`` with each decode step's logits, and a separate
    prefill's logits and keep masks."""
    cfg, dense_moe = _cfg(arch, path), PATHS[path][1]
    model = convert.model_params(case["params"], cfg, "cpu", mesh=mesh)
    prompt = ps.shard_batch(torch.from_numpy(case["prompt"]), mesh)
    stats, steps = {}, []
    with activation_sharding(mesh):
        toks = pserve.generate(model, cfg, prompt, N, dense_moe=dense_moe, stats=stats,
                               on_step=lambda i, lg: steps.append(lg.numpy().copy()))
        with _Keeps() as keeps:
            lg, _ = pmodels.prefill(model, cfg, prompt, S + N, dense_moe=dense_moe)
    return dict(tokens=toks.numpy(), route=stats["route"], prefill_logits=lg.numpy(),
                keeps=keeps, logits=steps)


def _compressed(case, mesh):
    """kimi's greedy ``generate`` with the compressed cache on the
    reference's sketches, and the factors of a separate conversion."""
    cfg = _cfg(KIMI)
    kc = pserve.KVCompressionConfig(**KC)
    model = convert.model_params(case["params"], cfg, "cpu", mesh=mesh)
    prompt = ps.shard_batch(torch.from_numpy(case["prompt"]), mesh)
    with activation_sharding(mesh):
        toks = pserve.generate(model, cfg, prompt, N, kv_compress=kc,
                               kv_sketches=case["sketches"])
        _, cache = pmodels.prefill(model, cfg, prompt, S + N)
        cache = pserve.compress_prefill_cache(None, cfg, cache, kc, sketches=case["sketches"])
    factors = [{name: tuple(getattr(getattr(c, name), f).numpy() for f in ("v_s", "sigma", "u"))
                for name in ("k_fac", "v_fac")} for c in cache["layers"]]
    return dict(tokens=toks.numpy(), factors=factors)


def _train(case, arch, mesh, compressed: bool):
    """The plain step's data-mean gradients, metrics and updated blocks; with
    ``compressed`` the compressed step's metrics and updated blocks on the
    reference's sketches."""
    import torch.distributed as dist

    from repro_torch.train import (CompressionConfig, OptimizerConfig, make_compressed_train_step,
                                   make_loss_fn, make_train_step)
    from repro_torch.train import train_step as pts

    cfg = _cfg(arch)
    oc = OptimizerConfig(**OC)
    d, at = mesh.shape["data"], mesh.index("data")
    batch = {"tokens": torch.from_numpy(case["tokens"][at * B // d:(at + 1) * B // d])}
    state = convert.train_state(case["state"], cfg, "cpu", mesh=mesh)
    with activation_sharding(mesh):
        _, metrics, grads = pts._value_and_grad(make_loss_fn(cfg), state["params"], batch)
    for g in grads.values():
        if d > 1:
            dist.all_reduce(g, group=mesh.group("data"))
            g.div_(d)
    out = dict(grads={k: v.numpy() for k, v in grads.items()})
    state, m = make_train_step(cfg, oc, remat=None, mesh=mesh)(state, batch)
    out["plain"] = dict(metrics={k: float(v) for k, v in m.items()})
    if compressed:
        state = convert.train_state(case["state"], cfg, "cpu", mesh=mesh)
        cstep, init_err = make_compressed_train_step(cfg, oc, CompressionConfig(**CCFG),
                                                     mesh=mesh, remat=None)
        state["err"] = init_err(state["params"])
        sketches = {i: tuple(convert.sketch_from_arrays(k, a, device="cpu") for k, a in sk)
                    for i, sk in case["sketches"].items()}
        state, m = cstep(state, batch, 0, sketches=sketches)
        out["compressed"] = dict(metrics={k: float(v) for k, v in m.items()},
                                 params={k: v.detach().numpy().copy()
                                         for k, v in state["params"].state_dict().items()})
    return out


def _micro(case, path, mesh):
    """The plain step at ``microbatch=2`` on this rank's rows: the gradients
    it hands AdamW (the data axis's mean) and its metrics."""
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train import train_step as pts

    cfg, dense_moe = _cfg(DS, path), PATHS[path][1]
    d, at = mesh.shape["data"], mesh.index("data")
    batch = {"tokens": torch.from_numpy(case["tokens"][at * B // d:(at + 1) * B // d])}
    state = convert.train_state(case["state"], cfg, "cpu", mesh=mesh)
    real, seen = pts.adamw_update, {}

    def recorded(grads, *args, **kwargs):
        seen.update({k: g.detach().numpy().copy() for k, g in grads.items()})
        return real(grads, *args, **kwargs)

    pts.adamw_update = recorded
    try:
        step = make_train_step(cfg, OptimizerConfig(**OC), remat=None, microbatch=2,
                               dense_moe=dense_moe, mesh=mesh)
        _, m = step(state, batch)
    finally:
        pts.adamw_update = real
    return dict(grads=seen, metrics={k: float(v) for k, v in m.items()})


def _control_gates(case, mesh):
    """1×2 gradients with the MoE gates not passed through ``copy_to_tp``
    (each rank's router gradient then sees only its experts' gates)."""
    from repro_torch.train import make_loss_fn
    from repro_torch.train import train_step as pts

    cfg = _cfg(DS)
    state = convert.train_state(case["state"], cfg, "cpu", mesh=mesh)
    real, calls = pmoe.copy_to_tp, [0]

    def skip_gates(x):  # moe_ffn calls it for the experts' input, then for the gates
        calls[0] += 1
        return x if calls[0] % 2 == 0 else real(x)

    pmoe.copy_to_tp = skip_gates
    try:
        with activation_sharding(mesh):
            _, _, grads = pts._value_and_grad(make_loss_fn(cfg), state["params"],
                                              {"tokens": torch.from_numpy(case["tokens"])})
    finally:
        pmoe.copy_to_tp = real
    return {k: v.numpy() for k, v in grads.items()}


def _layer(case, mesh):
    """deepseek's first MoE layer alone on a seeded input (the capacity path
    at full capacity, and the dropless one): this rank's output."""
    cfg = dataclasses.replace(_cfg(DS), capacity_factor=8.0)
    model = convert.model_params(case["params"], cfg, "cpu", mesh=mesh)
    x = torch.from_numpy(case["layer_x"])
    with activation_sharding(mesh):
        return {dense: pmoe.moe_ffn_dense(model.blocks[1].ffn, x, cfg)[0].detach().numpy()
                if dense else pmoe.moe_ffn(model.blocks[1].ffn, x, cfg)[0].detach().numpy()
                for dense in (False, True)}


def _rank(rank, world, store, jobs, out_q):
    """One gloo rank: each job of ``jobs["run"]`` in turn."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(2)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        results = {}
        for job in jobs["run"]:
            kind, shape = job[0], job[-1]
            if kind == "cli_serve":
                from repro_torch.launch.serve import main

                results[job] = main(list(job[1]) + ["--mesh", "1x2"]).numpy()
                continue
            if kind == "cli_train":
                from repro_torch.launch.train import main

                rep = main(list(job[1]) + ["--mesh", "1x2", "--ckpt-dir", f"{store}.ckpt"])
                results[job] = list(map(float, rep.losses))
                # the rank's checkpoints go now, while the parent runs the
                # reference: unlinking freshly synced files can take tens of
                # seconds on a disk that discards, which the fixture waited for
                shutil.rmtree(f"{store}.ckpt/rank{rank}", ignore_errors=True)
                continue
            mesh = make_host_mesh(*shape)
            if kind == "serve":
                results[job] = _serve(jobs["cases"][job[1]], job[1], job[2], mesh)
            elif kind == "compressed":
                results[job] = _compressed(jobs["kimi_compressed"], mesh)
            elif kind == "train":
                results[job] = _train(jobs["cases"][job[1]], job[1], mesh, job[1] == DS)
            elif kind == "micro":
                results[job] = _micro(jobs["cases"][DS], job[1], mesh)
            elif kind == "control_gates":
                results[job] = _control_gates(jobs["cases"][DS], mesh)
            elif kind == "layer":
                results[job] = _layer(jobs["cases"][DS], mesh)
        out_q.put((rank, results))
    finally:
        dist.destroy_process_group()


class _Ranks:
    """:func:`_rank` in ``world`` spawned processes, collected by
    :meth:`results` (``tests/test_torch_tp_serve.py``'s way)."""

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
            for p in self.procs.processes:
                if p.is_alive():
                    p.terminate()
            shutil.rmtree(self.store, ignore_errors=True)
        return results


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------


def _jax():
    import jax
    import jax.numpy as jnp

    from repro import configs as rconfigs
    from repro import models as rmodels
    from repro import serve as rserve

    return jax, jnp, rconfigs, rmodels, rserve


def _ref_greedy(arch: str, path: str, params, prompt):
    """The reference's greedy run on the global batch: tokens (``sample_token``
    at temperature 0 after its jitted ``prefill`` and ``decode_step``),
    prefill's last logits and each decode step's."""
    jax, jnp, rconfigs, rmodels, rserve = _jax()
    cfg, dense_moe = _cfg(arch, path, rconfigs), PATHS[path][1]
    pre = jax.jit(lambda p, t: rmodels.prefill(p, cfg, t, S + N, dense_moe=dense_moe))
    step = jax.jit(lambda p, c, t: rmodels.decode_step(p, cfg, c, t, dense_moe=dense_moe))
    key = jax.random.key(0)
    lg, cache = pre(params, prompt)
    toks, logits = [rserve.sample_token(key, lg, 0.0)], []
    for _ in range(N - 1):
        lg_i, cache = step(params, cache, toks[-1])
        logits.append(np.asarray(lg_i))
        toks.append(rserve.sample_token(key, lg_i, 0.0))
    return dict(tokens=np.asarray(jnp.concatenate(toks, axis=1)), prefill_logits=np.asarray(lg),
                logits=logits)


def _ref_kimi_compressed(params, prompt) -> tuple:
    """The reference's compressed run of kimi (``tests/test_torch_tp_serve.py``'s
    way: its prefill, the conversion with ``fold_in(key, n_tokens)``,
    ``sample_token``, ``_fused_decode_step`` per token): the whole
    sketches by segment position, the tokens, each layer's factors."""
    from repro.serve import decode as rdecode
    from repro.serve import kv_cache as rkv
    from repro.serve import kv_compress as rkc

    jax, jnp, rconfigs, rmodels, rserve = _jax()
    cfg, key = _cfg(KIMI, "cap4", rconfigs), jax.random.key(1)
    kc = rkc.KVCompressionConfig(**KC)
    lg, cache = jax.jit(lambda p, t: rmodels.prefill(p, cfg, t, S + N))(params, prompt)
    cache = rkv.compress_prefill_cache(jax.random.fold_in(key, N), cfg, cache, kc)
    ckvs = [seg[0] for seg in cache["segments"]]  # kimi: one ATTN position a segment
    sketches = {i: convert.compressed_kv_sketches(c, "cpu") for i, c in enumerate(ckvs)}
    tail = {"v_s": 4, "sigma": 3, "u": 4}  # (B, KV, ...) behind a segment's repeats

    def layers(x, f):
        x = np.asarray(x)
        return x.reshape(-1, *x.shape[x.ndim - tail[f]:])

    factors = {name: tuple(np.concatenate([layers(getattr(getattr(c, name), f), f) for c in ckvs])
                           for f in ("v_s", "sigma", "u")) for name in ("k_fac", "v_fac")}
    toks, k = [rserve.sample_token(key, lg, 0.0)], key
    for i in range(N - 1):
        tok, cache, k = rdecode._fused_decode_step(params, cfg, cache, toks[-1], k,
                                                   jnp.asarray(i, jnp.int32), 0.0, False)
        toks.append(tok)
    return sketches, dict(tokens=np.asarray(jnp.concatenate(toks, axis=1)), factors=factors)


def _ref_state(arch: str, params) -> tuple:
    """The reference's initial train state (numpy) and, for deepseek, its
    compressed step's sketches by leaf index (arrays), drawn as its step
    draws them from the key 9."""
    jax, jnp, rconfigs, rmodels, rserve = _jax()
    from repro.train import CompressionConfig, OptimizerConfig, init_opt_state
    from repro.train.grad_compress import _sketches_for, is_compressible

    ccfg = CompressionConfig(**CCFG)
    state = {"params": params, "opt": init_opt_state(params, OptimizerConfig(**OC))}
    key, sketches = jax.random.key(9), {}
    if arch == DS:
        sketches = {i: tuple(convert.sketch_arrays(S_) for S_ in _sketches_for(
            jax.random.fold_in(key, i), g.shape[-2:], ccfg))
            for i, g in enumerate(jax.tree.leaves(params)) if is_compressible(g, ccfg)}
    return jax.tree.map(np.asarray, state), sketches


def _ref_train(arch: str, params, tokens, compressed: bool) -> dict:
    """The reference's loss, aux and gradients on the global batch (and
    their global norm); with ``compressed`` each shard's loss and aux and
    its compressed step on a 1×1 mesh."""
    jax, jnp, rconfigs, rmodels, rserve = _jax()
    from repro.distributed.sharding import ParallelismRules as RRules
    from repro.train import (CompressionConfig, OptimizerConfig, init_opt_state,
                             make_compressed_train_step, make_loss_fn)

    cfg_r, cfg = _cfg(arch, "cap4", rconfigs), _cfg(arch)
    oc, ccfg = OptimizerConfig(**OC), CompressionConfig(**CCFG)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    loss_fn = make_loss_fn(cfg_r)
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, metrics), grads = vg(params, {"tokens": jnp.asarray(tokens)})
    grads = convert.model_state(np_tree(grads), cfg)
    out = dict(tokens=tokens, loss=float(loss), aux=float(metrics["aux"]), grads=grads,
               grad_norm=float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                           for g in grads.values()))))
    if not compressed:
        return out
    value = jax.jit(loss_fn)
    shards = [value(params, {"tokens": jnp.asarray(tokens[i * B // 2:(i + 1) * B // 2])})
              for i in range(2)]
    out.update(shard_loss=[float(x[0]) for x in shards],
               shard_aux=[float(x[1]["aux"]) for x in shards])
    state = {"params": params, "opt": init_opt_state(params, oc)}
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    cstep, init_err = make_compressed_train_step(cfg_r, oc, ccfg, mesh, RRules(dp_axes=("data",)),
                                                 remat=None)
    with warnings.catch_warnings():  # the frozen reference calls jax.lax.pvary, deprecated
        warnings.filterwarnings("ignore", "jax.lax.pvary", DeprecationWarning)
        stc, mc = cstep({**state, "err": init_err(params)}, {"tokens": jnp.asarray(tokens)},
                        jax.random.key(9))
    out["compressed"] = dict(metrics={k: float(v) for k, v in mc.items()},
                             params=convert.model_state(np_tree(stc["params"]), cfg))
    return out


def _ref_micro(params, tokens, path: str) -> dict:
    """The reference's ``_grads_microbatched`` at 2 microbatches on the global
    batch (microbatch i its rows [i·B/2, (i+1)·B/2)): the mean loss, the
    last microbatch's metrics, the mean gradients and their global norm."""
    jax, jnp, rconfigs, rmodels, rserve = _jax()
    from repro.train import make_loss_fn
    from repro.train.train_step import _grads_microbatched

    loss_fn = make_loss_fn(_cfg(DS, path, rconfigs), dense_moe=PATHS[path][1])
    loss, metrics, grads = jax.jit(lambda p, t: _grads_microbatched(loss_fn, p, {"tokens": t}, 2))(
        params, jnp.asarray(tokens))
    grads = convert.model_state(jax.tree.map(np.asarray, grads), _cfg(DS, path))
    return dict(loss=float(loss), metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
                grad_norm=float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                            for g in grads.values()))))


_SHARDS = {}  # the vmapped reference's result, made once


def _ref_compressed_shards(ref: dict, tokens) -> dict:
    """The reference's compressed step over two data shards: its step body
    (each shard's ``value_and_grad``, ``compressed_mean_grads`` over the
    axis ``data``, ``adamw_update``) vmapped over the shards with that axis
    name, as its ``shard_map`` maps it; metrics and parameters."""
    jax, jnp, rconfigs, rmodels, rserve = _jax()
    from repro.train import CompressionConfig, OptimizerConfig, make_loss_fn
    from repro.train.grad_compress import compressed_mean_grads
    from repro.train.optimizer import adamw_update

    cfg_r, cfg = _cfg(DS, "cap4", rconfigs), _cfg(DS)
    oc, ccfg = OptimizerConfig(**OC), CompressionConfig(**CCFG)
    params, opt = jax.tree.map(jnp.asarray, ref["state"]["params"]), jax.tree.map(
        jnp.asarray, ref["state"]["opt"])
    loss_fn, key = make_loss_fn(cfg_r), jax.random.key(9)

    def inner(batch):
        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params,
                                                                           {"tokens": batch})
        err = jax.tree.map(lambda g: jnp.zeros(g.shape, jnp.float32), grads)
        gbar, _, cstats = compressed_mean_grads(grads, err, key, ccfg, ("data",), with_stats=True)
        p1, _, om = adamw_update(gbar, opt, params, oc)
        mean = lambda v: jax.lax.psum(v, "data") / 2  # noqa: E731
        return p1, {"loss": mean(loss), **{k: mean(v) for k, v in {**metrics, **cstats}.items()},
                    **om}

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "jax.lax.pvary", DeprecationWarning)
        p1, m = jax.jit(jax.vmap(inner, axis_name="data"))(jnp.asarray(tokens).reshape(2, B // 2,
                                                                                      S))
    p1 = jax.tree.map(lambda x: np.asarray(x[0]), p1)
    return dict(metrics={k: float(v[0]) for k, v in m.items()},
                params=convert.model_state(p1, cfg))


def _case(arch: str) -> dict:
    jax, jnp, rconfigs, rmodels, rserve = _jax()
    params = jax.jit(lambda k: rmodels.init_params(k, _cfg(arch, "cap4", rconfigs)))(
        jax.random.key(0))
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 256, (B, S)).astype(np.int32)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    return dict(params=jax.tree.map(np.asarray, params), prompt=prompt, tokens=tokens,
                jax_params=params)


def _shipped(case: dict) -> dict:
    return {k: v for k, v in case.items() if k != "jax_params"}


@pytest.fixture(scope="module")
def runs():
    """``(references, the two ranks' results, the four ranks' results, the
    one-process port runs)``. The ranks start once the weights, the train
    state, the sketches and the reference's kimi conversion are ready; the
    reference's greedy runs and steps, and the one-process port runs, go on
    here meanwhile."""
    jax, jnp, rconfigs, rmodels, rserve = _jax()
    cases = {arch: _case(arch) for arch in (DS, KIMI)}
    for arch in (DS, KIMI):
        cases[arch]["state"], cases[arch]["sketches"] = _ref_state(arch, cases[arch]["jax_params"])
    x = np.random.default_rng(2).standard_normal((2, 8, 64)).astype(np.float32)
    cases[DS]["layer_x"] = x
    refs = {}
    sketches, refs["kimi_compressed"] = _ref_kimi_compressed(cases[KIMI]["jax_params"],
                                                             jnp.asarray(cases[KIMI]["prompt"]))
    jobs = dict(cases={a: _shipped(c) for a, c in cases.items()},
                kimi_compressed=dict(params=cases[KIMI]["params"], prompt=cases[KIMI]["prompt"],
                                     sketches=sketches))
    run2 = [("serve", arch, path, shape) for arch, path in SERVE for shape in TWO]
    run2 += [("train", arch, shape) for arch, _ in TRAIN for shape in TWO]
    run2 += [("compressed", shape) for shape in TWO]
    run2 += [("micro", path, (2, 1)) for path in MICRO]
    run2 += [("control_gates", (1, 2)), ("layer", (1, 2)),
             ("cli_serve", tuple(CLI_SERVE + ["--arch", DS])),
             ("cli_serve", tuple(CLI_SERVE + ["--arch", KIMI])), ("cli_train", tuple(CLI_TRAIN))]
    run4 = [("serve", arch, path, (2, 2)) for arch, path in SERVE]
    run4 += [("train", DS, (2, 2)), ("compressed", (2, 2))]
    run4 += [("micro", path, (2, 2)) for path in MICRO]
    two = _Ranks(2, dict(jobs, run=run2))
    four = _Ranks(4, dict(jobs, run=run4))

    refs["greedy"] = {(arch, path): _ref_greedy(arch, path, cases[arch]["jax_params"],
                                                jnp.asarray(cases[arch]["prompt"]))
                      for arch, path in SERVE}
    for arch, _ in TRAIN:
        refs[arch] = dict(_ref_train(arch, cases[arch]["jax_params"], cases[arch]["tokens"],
                                     arch == DS), state=cases[arch]["state"])
    refs["micro"] = {path: _ref_micro(cases[DS]["jax_params"], cases[DS]["tokens"], path)
                     for path in MICRO}
    # the port in this process: keep masks of each serve case's prefill, the
    # layer, the CLIs at 1x1
    one = {}
    for arch, path in SERVE:
        cfg, dense_moe = _cfg(arch, path), PATHS[path][1]
        model = convert.model_params(cases[arch]["params"], cfg, "cpu")
        with _Keeps() as keeps:
            pmodels.prefill(model, cfg, torch.from_numpy(cases[arch]["prompt"]), S + N,
                            dense_moe=dense_moe)
        one[("keeps", arch, path)] = keeps
    cfg = dataclasses.replace(_cfg(DS), capacity_factor=8.0)
    model = convert.model_params(cases[DS]["params"], cfg, "cpu")
    blk = model.blocks[1].ffn
    xt = torch.from_numpy(x)
    one["layer"] = {False: pmoe.moe_ffn(blk, xt, cfg)[0].detach().numpy(),
                    True: pmoe.moe_ffn_dense(blk, xt, cfg)[0].detach().numpy()}
    one["shared"] = pmodels.layers.ffn(blk.shared, xt, cfg.activation).detach().numpy()
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain

    for arch in (DS, KIMI):
        one[("cli_serve", arch)] = lserve.main(CLI_SERVE + ["--arch", arch]).numpy()
    with tempfile.TemporaryDirectory() as d:
        one["cli_train"] = list(map(float, ltrain.main(CLI_TRAIN + ["--ckpt-dir", d]).losses))
    return refs, two.results(), four.results(), one


@pytest.fixture(scope="module")
def refs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ranks(runs):
    """Every rank's results by mesh: ``{shape: {rank: results}}``."""
    _, two, four, _ = runs
    return {(1, 2): two, (2, 1): two, (2, 2): four}


@pytest.fixture(scope="module")
def one(runs):
    return runs[3]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

SHAPES = pytest.mark.parametrize("shape", TWO + FOUR, ids=["1x2", "2x1", "2x2"])


def _check_serve(res, ref, shape, rank, what):
    assert np.array_equal(res["tokens"], _rows(ref["tokens"], shape, rank)), what
    _close(res["prefill_logits"], _rows(ref["prefill_logits"], shape, rank),
           what=f"{what} prefill logits")
    assert len(res["logits"]) == N - 1
    for i, (g, w) in enumerate(zip(res["logits"], ref["logits"])):
        _close(g, _rows(w, shape, rank), what=f"{what} decode step {i}")


@SHAPES
@pytest.mark.parametrize("arch, path", SERVE, ids=[f"{a.split('-')[0]}-{p}" for a, p in SERVE])
def test_generate_matches_reference(refs, ranks, one, arch, path, shape):
    """Tokens and logits against the reference on the global batch; every
    MoE call's keep mask the rows of the one-process run's, some dropped on
    the capacity path; the decode loop eager at model axis 2 or where the
    decode step gathers expert ids (``cap1`` on a data axis)."""
    ref = refs["greedy"][(arch, path)]
    want_keeps = one[("keeps", arch, path)]
    if path != "dense":
        assert any(not k.all() for k in want_keeps), "no assignment dropped"
    for rank, res in ranks[shape].items():
        r = res[("serve", arch, path, shape)]
        what = f"{arch} {path} {shape} rank {rank}"
        _check_serve(r, ref, shape, rank, what)
        assert r["route"] == "eager", what  # a CPU prompt's
        assert len(r["keeps"]) == len(want_keeps)
        for got, want in zip(r["keeps"], want_keeps):
            assert np.array_equal(got, _rows(want, shape, rank)), what


@SHAPES
def test_kimi_compressed_cache_on_a_ranks_heads(refs, ranks, shape):
    """The reference's sketches handed in whole: each rank keeps its rows'
    and KV heads' and gets the reference's tokens and factors for them."""
    ref = refs["kimi_compressed"]
    d, m = shape
    for rank, res in ranks[shape].items():
        r = res[("compressed", shape)]
        assert np.array_equal(r["tokens"], _rows(ref["tokens"], shape, rank)), (shape, rank)
        di, mi = rank // m, rank % m
        for layer, got in enumerate(r["factors"]):
            for name, (v_s, sigma, u) in got.items():
                Bl, KVl = sigma.shape[:2]
                want = [x[layer, di * Bl:(di + 1) * Bl, mi * KVl:(mi + 1) * KVl]
                        for x in ref["factors"][name]]
                _close(sigma, want[1], FAC_TOL, f"{shape} rank {rank} layer {layer} {name}")
                recon = lambda a, s, b: np.einsum("...sr,...r,...dr->...sd", a, s, b)  # noqa
                _close(recon(v_s, sigma, u), recon(*want), FAC_TOL,
                       f"{shape} rank {rank} layer {layer} {name} reconstruction")


PLAIN = [(DS, (1, 2)), (DS, (2, 1)), (DS, (2, 2)), (KIMI, (1, 2)), (KIMI, (2, 1))]


@pytest.mark.parametrize("arch, shape", PLAIN,
                         ids=[f"{a.split('-')[0]}-{d}x{m}" for a, (d, m) in PLAIN])
def test_plain_step_matches_reference(refs, ranks, arch, shape):
    """Over the global batch, as the reference's ``jit``: loss, aux, every
    gradient leaf (``router``, ``w_dkv`` and the expert stacks included) and
    the step's gradient norm (the blocks' squares summed over the model
    axis)."""
    ref = refs[arch]
    for rank, res in ranks[shape].items():
        r = res[("train", arch, shape)]
        m = r["plain"]["metrics"]
        assert abs(m["loss"] / ref["loss"] - 1) <= LOSS_TOL, (m["loss"], ref["loss"])
        assert abs(m["aux"] / ref["aux"] - 1) <= LOSS_TOL, (m["aux"], ref["aux"])
        assert abs(m["grad_norm"] / ref["grad_norm"] - 1) <= LOSS_TOL
        for k, g in _blocks(ref["grads"], shape, rank).items():
            assert _rel(r["grads"][k], g) <= GRAD_TOL, (k, _rel(r["grads"][k], g))


@SHAPES
def test_compressed_step_is_per_shard(refs, ranks, shape):
    """Each data rank's loss, dispatch and aux on its own rows: at 1×2 the
    reference's compressed step on a 1×1 mesh (metrics, parameters); on a
    data axis the loss and aux the mean of the reference's on each shard,
    and ``comp/ratio`` the reference's."""
    ref = refs[DS]
    want = ref["compressed"]["metrics"]
    for rank, res in ranks[shape].items():
        r = res[("train", DS, shape)]["compressed"]
        m = r["metrics"]
        assert m["comp/ratio"] == pytest.approx(want["comp/ratio"], rel=1e-6)
        assert m["comp/wire_floats"] == want["comp/wire_floats"]
        if shape[0] == 1:
            assert abs(m["loss"] / want["loss"] - 1) <= LOSS_TOL
            assert abs(m["comp/rel_err"] / want["comp/rel_err"] - 1) <= 1e-3
            for k, w in _blocks(ref["compressed"]["params"], shape, rank).items():
                assert float(np.abs(r["params"][k] - w).max()) <= PARAM_TOL, k
        else:
            assert abs(m["loss"] / np.mean(ref["shard_loss"]) - 1) <= LOSS_TOL
            assert abs(m["aux"] / np.mean(ref["shard_aux"]) - 1) <= LOSS_TOL
            assert abs(m["aux"] / ref["aux"] - 1) > LOSS_TOL  # per shard is not the global one


@pytest.mark.slow
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_compressed_step_matches_reference_per_shard(refs, ranks, shape):
    """The compressed step on a data axis against the reference's step body
    vmapped over the two shards: metrics and updated parameters."""
    ref = refs[DS]
    if not _SHARDS:
        _SHARDS.update(_ref_compressed_shards(ref, ref["tokens"]))
    want = _SHARDS
    for rank, res in ranks[shape].items():
        r = res[("train", DS, shape)]["compressed"]
        for k in ("loss", "aux", "comp/ratio"):
            assert abs(r["metrics"][k] / want["metrics"][k] - 1) <= LOSS_TOL, k
        for k, w in _blocks(want["params"], shape, rank).items():
            assert float(np.abs(r["params"][k] - w).max()) <= PARAM_TOL, k


@pytest.mark.parametrize("path", ["cap4", "cap1"])
def test_f9_data_axis_prefill_groups_by_the_global_batch(refs, ranks, path):
    """F9: at 2×1 the capacity dispatch groups, sizes and ranks the global
    batch's assignments (``moe_dispatch_shards`` 4: each rank its two
    groups of the global 32 tokens, capacity from 32; 1: the expert ids
    gathered, one global group), so prefill's logits are the reference's."""
    ref = refs["greedy"][(DS, path)]
    for rank, res in ranks[(2, 1)].items():
        r = res[("serve", DS, path, (2, 1))]
        _close(r["prefill_logits"], _rows(ref["prefill_logits"], (2, 1), rank),
               what=f"F9 {path} rank {rank}")


def test_f10_data_axis_aux_and_router_gradient(refs, ranks):
    """F10: the 2×1 plain step's aux (the data-axis mean of E·Σ f_e·p̄_e with
    the global top-1 shares) and its router gradients are the reference's."""
    ref = refs[DS]
    for rank, res in ranks[(2, 1)].items():
        r = res[("train", DS, (2, 1))]
        assert abs(r["plain"]["metrics"]["aux"] / ref["aux"] - 1) <= LOSS_TOL
        routers = [k for k in ref["grads"] if k.endswith("ffn.router")]
        assert routers
        for k in routers:
            assert _rel(r["grads"][k], ref["grads"][k]) <= GRAD_TOL, k


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
@pytest.mark.parametrize("path", MICRO)
def test_f11_microbatches_split_the_global_batch(refs, ranks, path, shape):
    """F11: the plain step at ``microbatch=2`` on a data axis takes, on each
    data rank, its share of each global microbatch (the reference's
    ``_grads_microbatched`` splits the global batch), so the capacity
    dispatch and the aux loss see the global microbatch: loss and ``aux``
    (the last microbatch's) within 1e-5 relative, every gradient leaf
    (``router`` included) within 1e-4 relative Frobenius, the gradient
    norm within 1e-5 (the F9/F10 bounds)."""
    ref = refs["micro"][path]
    for rank, res in ranks[shape].items():
        r = res[("micro", path, shape)]
        m, what = r["metrics"], f"F11 {path} {shape} rank {rank}"
        assert abs(m["loss"] / ref["loss"] - 1) <= LOSS_TOL, (what, m["loss"], ref["loss"])
        for k in ("aux", "ce"):
            assert abs(m[k] / ref["metrics"][k] - 1) <= LOSS_TOL, (what, k, m[k],
                                                                   ref["metrics"][k])
        assert abs(m["grad_norm"] / ref["grad_norm"] - 1) <= LOSS_TOL, what
        assert any(k.endswith("ffn.router") for k in r["grads"])
        for k, g in _blocks(ref["grads"], shape, rank).items():
            assert _rel(r["grads"][k], g) <= GRAD_TOL, (what, k, _rel(r["grads"][k], g))


def test_gates_without_copy_to_tp_break_the_router_gradient(refs, ranks):
    """The control: each model rank's combine sees only its experts' gates,
    so without ``copy_to_tp`` on the gates the router's gradient is
    partial, while the forward is unchanged."""
    ref = refs[DS]
    got = ranks[(1, 2)][0][("control_gates", (1, 2))]
    worst = max(_rel(got[k], ref["grads"][k]) for k in ref["grads"] if k.endswith("router"))
    assert worst > 100 * GRAD_TOL, worst


def test_moe_layer_sums_routed_and_shared_experts_once(ranks, one):
    """deepseek's MoE layer alone at 1×2, the capacity and dropless paths:
    the output is the one-process layer's, whose shared experts' part is
    far above the bound (summed twice, or not at all, it would fail)."""
    shared = np.abs(one["shared"]).max()
    for res in ranks[(1, 2)].values():
        got = res[("layer", (1, 2))]
        for dense in (False, True):
            want = one["layer"][dense]
            _close(got[dense], want, what=f"dense={dense}")
            assert shared > 100 * TOL * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("arch", [DS, KIMI])
def test_launch_serve_cli_at_mesh_1x2_matches_1x1(ranks, one, arch):
    for res in ranks[(1, 2)].values():
        got = res[("cli_serve", tuple(CLI_SERVE + ["--arch", arch]))]
        assert np.array_equal(got, one[("cli_serve", arch)]), arch


def test_launch_train_cli_at_mesh_1x2_matches_1x1(ranks, one):
    for res in ranks[(1, 2)].values():
        got = res[("cli_train", tuple(CLI_TRAIN))]
        np.testing.assert_allclose(got, one["cli_train"], rtol=LOSS_TOL)


def test_compressed_grads_of_a_ranks_expert_slices():
    """A MoE layer's (E, D, Fe) expert stack, compressible as a stack of E
    slices where it is a leaf of its own (a segment of one MoE layer), cut
    over the model axis on its expert dim: each rank compresses its whole
    slices with the logical leaf's sketches and no model-axis sum, so its
    result is its slices of the one-rank result."""
    from repro_torch.train import CompressionConfig, compressed_mean_grads, is_compressible

    ccfg = CompressionConfig(**CCFG)
    g = torch.Generator().manual_seed(0)
    G = torch.randn((8, 64, 32), generator=g)
    assert is_compressible(G.shape, ccfg)
    whole, _, whole_stats = compressed_mean_grads({"ffn.w_up": G}, {}, 5, ccfg, with_stats=True)
    for i in range(2):
        block, err, stats = compressed_mean_grads({"ffn.w_up": G[4 * i:4 * (i + 1)]}, {}, 5, ccfg,
                                                  with_stats=True,
                                                  cuts={"ffn.w_up": (-3, 2, i)})
        torch.testing.assert_close(block["ffn.w_up"], whole["ffn.w_up"][4 * i:4 * (i + 1)],
                                   rtol=1e-5, atol=1e-6)
        assert err["ffn.w_up"].shape == (4, 64, 32)
        for k in ("comp/wire_floats", "comp/dense_floats", "comp/ratio"):
            assert float(stats[k]) == float(whole_stats[k]), k
