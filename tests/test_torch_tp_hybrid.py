"""Mamba-2, shared attention and cross attention on the model axis
(``repro_torch.models.ssm``, ``repro_torch.models.blocks`` and the steps
under ``activation_sharding``) against the JAX reference's one-device runs
on the global batch, in gloo ranks on the CPU.

The models are the smoke configs of mamba2-1.3b (4 Mamba-2 layers of 4 SSM
heads, one B/C group), zamba2-1.2b (6 Mamba-2 layers and the shared GQA of
4/4 heads at two positions, its dense FFN) and llama-3.2-vision-90b (4
self-attention layers and a cross layer, 4/2 heads, 16 patches of 32);
d_model 64, fp32, from the reference's ``init_params`` through
``convert`` (each rank cut to its block by ``shard_params``). Every cross
``gate`` is 0.5 in the numpy weights both packages read: at init it is 0
and a cross layer adds nothing. A batch of 4 × 24 numpy tokens (and, for
the vision model, numpy patch embeddings), 8 new tokens; each data rank
serves and trains on its rows. Meshes 1×2 (two ranks) and 2×2 (four).

* Serving: greedy tokens equal to the reference's; prefill's last logits
  and each decode step's within 1e-5 of the largest logit
  (``tests/test_torch_tp_serve.py``'s bound); the prefill cache (Mamba-2's
  conv windows and SSM states, the shared and cross K/V) within 1e-5 of
  the rank's block of the reference's (``convert.dense_cache(..., mesh=)``).
  The vision model's compressed cache at the reference's sketches, handed
  in whole: tokens equal, each head's factors within 1e-4.
* The plain step: loss and ``aux`` within 1e-5 relative, every gradient
  leaf within 1e-4 relative Frobenius of ``jax.value_and_grad`` of the
  reference's ``make_loss_fn`` on the global batch, the gradient norm
  within 1e-5 (``tests/test_torch_tp.py``'s bounds), the whole leaves
  (``w_out``, ``w_bc``, ``w_dt``, ``conv_bc_*``, ``dt_bias``, ``a_log``,
  ``d_skip``, ``vision_proj``, ``gate``) included, and equal bit for bit on
  the model ranks after the step.
* The compressed step at 1×2 against the reference's step on a 1×1 mesh,
  on the reference's sketches (``tests/test_torch_tp.py``'s way), for
  zamba2 (whose Mamba-2 layers are mamba2's) and the vision model.
* Three controls, each failing: the whole leaves read without their
  ``copy_to_tp`` (their gradients partial); the gated norm on the rank's
  own mean (the forward changes); ``reduce_from_tp`` after the cross gate
  instead of before (the gate's gradient partial).
* The serve and train CLIs at ``--mesh 1x2`` against ``1x1``, for zamba2
  and the vision model.

The ranks are spawned processes running :func:`_rank`, meeting at a file of
their own, one spawn per world; the JAX reference runs in this process
meanwhile.
"""

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

MAMBA, ZAMBA, VISION = "mamba2-1.3b", "zamba2-1.2b", "llama-3.2-vision-90b"
ARCHS = [MAMBA, ZAMBA, VISION]
B, S, N = 4, 24, 8
KC = dict(rank=4, oversample=2, panel=8, decode_panel=4, refresh_every=8)
OC = dict(lr=1e-2, clip_norm=None)
CCFG = dict(rank=8, sketch_factor=2, min_dim=16)
TOL, FAC_TOL = 1e-5, 1e-4
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 3e-3
MAMBA_WHOLE = {"w_out", "w_bc", "w_dt", "conv_bc_w", "conv_bc_b", "dt_bias", "a_log", "d_skip"}
WHOLE = MAMBA_WHOLE | {"vision_proj", "gate"}
CLI_SERVE = ["--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "6"]
CLI_TRAIN = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16"]
CLI_ARCHS = [ZAMBA, VISION]
COMPRESSED = [ZAMBA, VISION]  # zamba2's Mamba-2 layers are mamba2's


def _cfg(arch: str, mod=pconfigs):
    return mod.get_arch(arch).smoke_config()


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


def _leaf(name: str) -> str:
    return name.split(".")[-1]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _inputs(case, mesh, key="prompt"):
    """This data rank's rows of the prompt (or train tokens) and of the patch
    embeddings (``None`` without them)."""
    vision = case.get("vision")
    return (ps.shard_batch(torch.from_numpy(case[key]), mesh),
            None if vision is None else ps.shard_batch(torch.from_numpy(vision), mesh))


def _serve(case, arch, mesh):
    """Greedy ``generate`` with each decode step's logits, and a separate
    prefill's logits and cache."""
    cfg = _cfg(arch)
    model = convert.model_params(case["params"], cfg, "cpu", mesh=mesh)
    prompt, vision = _inputs(case, mesh)
    stats, steps = {}, []
    with activation_sharding(mesh):
        toks = pserve.generate(model, cfg, prompt, N, vision=vision, stats=stats,
                               on_step=lambda i, lg: steps.append(lg.numpy().copy()))
        lg, cache = pmodels.prefill(model, cfg, prompt, S + N, vision)
    return dict(tokens=toks.numpy(), route=stats["route"], prefill_logits=lg.numpy(),
                logits=steps,
                cache=[{k: v.numpy() for k, v in layer.items()} for layer in cache["layers"]])


def _compressed(case, mesh):
    """The vision model's greedy ``generate`` with the compressed cache on
    the reference's sketches, and the factors of a separate conversion."""
    cfg = _cfg(VISION)
    kc = pserve.KVCompressionConfig(**KC)
    model = convert.model_params(case["params"], cfg, "cpu", mesh=mesh)
    prompt, vision = _inputs(case, mesh)
    with activation_sharding(mesh):
        toks = pserve.generate(model, cfg, prompt, N, vision=vision, kv_compress=kc,
                               kv_sketches=case["kv_sketches"])
        _, cache = pmodels.prefill(model, cfg, prompt, S + N, vision)
        cache = pserve.compress_prefill_cache(None, cfg, cache, kc, sketches=case["kv_sketches"])
    factors = [{name: tuple(getattr(getattr(c, name), f).numpy() for f in ("v_s", "sigma", "u"))
                for name in ("k_fac", "v_fac")}
               for spec, c in zip(pmodels.layer_specs(cfg), cache["layers"])
               if spec.mixer == pmodels.ATTN]
    return dict(tokens=toks.numpy(), factors=factors)


def _grads(cfg, model, batch, mesh):
    """The loss gradients under the mesh, as the data axis's mean."""
    import torch.distributed as dist

    from repro_torch.train import make_loss_fn
    from repro_torch.train import train_step as pts

    with activation_sharding(mesh):
        _, _, grads = pts._value_and_grad(make_loss_fn(cfg), model, batch)
    d = mesh.shape["data"]
    for g in grads.values():
        if d > 1:
            dist.all_reduce(g, group=mesh.group("data"))
            g.div_(d)
    return {k: v.numpy() for k, v in grads.items()}


def _params(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _train(case, arch, mesh, compressed: bool):
    """The plain step's data-mean gradients, metrics and updated blocks; with
    ``compressed`` the compressed step's metrics and updated blocks on the
    reference's sketches."""
    from repro_torch.train import (CompressionConfig, OptimizerConfig, make_compressed_train_step,
                                   make_train_step)

    cfg = _cfg(arch)
    oc = OptimizerConfig(**OC)
    tokens, vision = _inputs(case, mesh, "tokens")
    batch = {"tokens": tokens} if vision is None else {"tokens": tokens, "vision": vision}
    state = convert.train_state(case["state"], cfg, "cpu", mesh=mesh)
    out = dict(grads=_grads(cfg, state["params"], batch, mesh))
    state, m = make_train_step(cfg, oc, remat=None, mesh=mesh)(state, batch)
    out["plain"] = dict(metrics={k: float(v) for k, v in m.items()},
                        params=_params(state["params"]))
    if compressed:
        state = convert.train_state(case["state"], cfg, "cpu", mesh=mesh)
        cstep, init_err = make_compressed_train_step(cfg, oc, CompressionConfig(**CCFG),
                                                     mesh=mesh, remat=None)
        state["err"] = init_err(state["params"])
        sketches = {i: tuple(convert.sketch_from_arrays(k, a, device="cpu") for k, a in sk)
                    for i, sk in case["sketches"].items()}
        state, m = cstep(state, batch, 0, sketches=sketches)
        out["compressed"] = dict(metrics={k: float(v) for k, v in m.items()},
                                 params=_params(state["params"]))
    return out


def _control(case, kind, mesh):
    """1×2 with one piece of the model axis's bookkeeping undone:

    * ``whole`` (zamba2) — Mamba-2 reads ``bc``, ``dt``, ``A``, ``D`` and
      ``w_out`` without ``copy_to_tp`` (only its input to ``w_z``/``w_x``
      keeps it): the gradients;
    * ``own_mean`` (mamba2) — the gated norm over the rank's own channels:
      prefill's logits;
    * ``gate_after`` (the vision model) — ``reduce_from_tp`` after the cross
      gate's product instead of before: the gradients."""
    from repro_torch.models import blocks as pblocks
    from repro_torch.models import ssm as pssm
    from repro_torch.models.layers import rmsnorm

    arch = {"whole": ZAMBA, "own_mean": MAMBA, "gate_after": VISION}[kind]
    cfg = _cfg(arch)
    model = convert.model_params(case["params"], cfg, "cpu", mesh=mesh)
    real_copy, real_norm, real_cross = pssm.copy_to_tp, pssm._gated_norm, pblocks._cross_attend

    def input_only(t):
        return real_copy(t) if t.dim() == 3 and t.shape[-1] == cfg.d_model else t

    def gate_after(p, cfg, x, k, v, core=pblocks.cross_attention):
        B_, S_, _ = x.shape
        q = (ps.copy_to_tp(x) @ p.w_q).reshape(B_, S_, -1, cfg.head_dim)
        o = core(q, k, v).reshape(B_, S_, -1)
        return ps.reduce_from_tp((torch.tanh(p.gate) * (o @ p.w_o).float()).to(x.dtype))

    try:
        if kind == "whole":
            pssm.copy_to_tp = input_only
        elif kind == "own_mean":
            pssm._gated_norm = lambda scale, y, eps: rmsnorm(scale, y, eps)
        else:
            pblocks._cross_attend = gate_after
        if kind == "own_mean":
            prompt, vision = _inputs(case, mesh)
            with activation_sharding(mesh):
                return pmodels.prefill(model, cfg, prompt, S + N, vision)[0].numpy()
        tokens, vision = _inputs(case, mesh, "tokens")
        batch = {"tokens": tokens} if vision is None else {"tokens": tokens, "vision": vision}
        return _grads(cfg, model, batch, mesh)
    finally:
        pssm.copy_to_tp, pssm._gated_norm, pblocks._cross_attend = real_copy, real_norm, real_cross


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

                rep = main(list(job[1]) + ["--mesh", "1x2", "--ckpt-dir",
                                           f"{store}.{job[1][-1]}.ckpt"])
                results[job] = list(map(float, rep.losses))
                continue
            mesh = make_host_mesh(*shape)
            cases = jobs["cases"]
            if kind == "serve":
                results[job] = _serve(cases[job[1]], job[1], mesh)
            elif kind == "compressed":
                results[job] = _compressed(cases[VISION], mesh)
            elif kind == "train":
                results[job] = _train(cases[job[1]], job[1], mesh,
                                      shape == (1, 2) and job[1] in COMPRESSED)
            elif kind == "control":
                arch = {"whole": ZAMBA, "own_mean": MAMBA, "gate_after": VISION}[job[1]]
                results[job] = _control(cases[arch], job[1], mesh)
        out_q.put((rank, results))
    finally:
        dist.destroy_process_group()


class _Ranks:
    """:func:`_rank` in ``world`` spawned processes, collected by
    :meth:`results` (``tests/test_torch_ep.py``'s way)."""

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


def _jax():
    import jax
    import jax.numpy as jnp

    from repro import configs as rconfigs
    from repro import models as rmodels
    from repro import serve as rserve

    return jax, jnp, rconfigs, rmodels, rserve


def _case(arch: str) -> dict:
    """The reference's weights (every cross gate 0.5), the prompt, the train
    tokens and, for the vision model, the patch embeddings, as numpy."""
    jax, jnp, rconfigs, rmodels, rserve = _jax()
    params = jax.jit(lambda k: rmodels.init_params(k, _cfg(arch, rconfigs)))(jax.random.key(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, 0.5, np.float32)
        if getattr(path[-1], "key", None) == "gate" else np.asarray(leaf), params)
    rng = np.random.default_rng(1)
    case = dict(params=params, prompt=rng.integers(0, 256, (B, S)).astype(np.int32),
                tokens=rng.integers(0, 256, (B, S)).astype(np.int32))
    cfg = _cfg(arch)
    if cfg.d_vision:
        case["vision"] = rng.standard_normal((B, cfg.n_patches, cfg.d_vision)).astype(np.float32)
    return case


def _ref_batch(case, key="tokens") -> dict:
    _, jnp, _, _, _ = _jax()
    batch = {"tokens": jnp.asarray(case[key])}
    if "vision" in case:
        batch["vision"] = jnp.asarray(case["vision"])
    return batch


def _ref_greedy(arch: str, case: dict) -> dict:
    """The reference's greedy run on the global batch: tokens (``sample_token``
    at temperature 0 after its jitted ``prefill`` and ``decode_step``),
    prefill's last logits and cache (numpy), each decode step's logits."""
    jax, jnp, rconfigs, rmodels, rserve = _jax()
    cfg = _cfg(arch, rconfigs)
    batch = _ref_batch(case, "prompt")
    pre = jax.jit(lambda p, t, v: rmodels.prefill(p, cfg, t, S + N, vision=v))
    step = jax.jit(lambda p, c, t: rmodels.decode_step(p, cfg, c, t))
    key = jax.random.key(0)
    lg, cache = pre(case["params"], batch["tokens"], batch.get("vision"))
    out = dict(prefill_logits=np.asarray(lg), cache=jax.tree.map(np.asarray, cache))
    toks, logits = [rserve.sample_token(key, lg, 0.0)], []
    for _ in range(N - 1):
        lg_i, cache = step(case["params"], cache, toks[-1])
        logits.append(np.asarray(lg_i))
        toks.append(rserve.sample_token(key, lg_i, 0.0))
    return dict(out, tokens=np.asarray(jnp.concatenate(toks, axis=1)), logits=logits)


def _ref_compressed(case: dict) -> tuple:
    """The reference's compressed run of the vision model
    (``tests/test_torch_tp_serve.py``'s way: its prefill, the conversion
    with ``fold_in(key, n_tokens)``, ``sample_token``,
    ``_fused_decode_step`` per token): the whole sketches by segment
    position, the tokens, each ``ATTN`` layer's factors."""
    from repro.serve import decode as rdecode
    from repro.serve import kv_cache as rkv
    from repro.serve import kv_compress as rkc

    jax, jnp, rconfigs, rmodels, rserve = _jax()
    cfg, key = _cfg(VISION, rconfigs), jax.random.key(1)
    kc = rkc.KVCompressionConfig(**KC)
    batch = _ref_batch(case, "prompt")
    lg, cache = jax.jit(lambda p, t, v: rmodels.prefill(p, cfg, t, S + N, vision=v))(
        case["params"], batch["tokens"], batch["vision"])
    cache = rkv.compress_prefill_cache(jax.random.fold_in(key, N), cfg, cache, kc)
    sketches, ckvs, li = {}, [], 0
    for seg, seg_cache in zip(pmodels.segments(_cfg(VISION)), cache["segments"]):
        for spec, c in zip(seg.unit, seg_cache):
            if spec.mixer == pmodels.ATTN:
                sketches[li] = convert.compressed_kv_sketches(c, "cpu")
                ckvs.append(c)
            li += 1
    factors = [{name: tuple(np.asarray(getattr(getattr(c, name), f))
                            for f in ("v_s", "sigma", "u")) for name in ("k_fac", "v_fac")}
               for c in ckvs]
    toks, k = [rserve.sample_token(key, lg, 0.0)], key
    for i in range(N - 1):
        tok, cache, k = rdecode._fused_decode_step(case["params"], cfg, cache, toks[-1], k,
                                                   jnp.asarray(i, jnp.int32), 0.0, False)
        toks.append(tok)
    return sketches, dict(tokens=np.asarray(jnp.concatenate(toks, axis=1)), factors=factors)


def _ref_state(case: dict) -> tuple:
    """The reference's initial train state (numpy) and its compressed step's
    sketches by leaf index (arrays), drawn as its step draws them from the
    key 9."""
    jax, jnp, rconfigs, rmodels, rserve = _jax()
    from repro.train import CompressionConfig, OptimizerConfig, init_opt_state
    from repro.train.grad_compress import _sketches_for, is_compressible

    ccfg = CompressionConfig(**CCFG)
    params = case["params"]
    state = {"params": params, "opt": init_opt_state(params, OptimizerConfig(**OC))}
    key = jax.random.key(9)
    sketches = {i: tuple(convert.sketch_arrays(S_) for S_ in _sketches_for(
        jax.random.fold_in(key, i), g.shape[-2:], ccfg))
        for i, g in enumerate(jax.tree.leaves(params)) if is_compressible(g, ccfg)}
    return jax.tree.map(np.asarray, state), sketches


def _ref_train(arch: str, case: dict) -> dict:
    """The reference's loss, aux and gradients on the global batch (and
    their global norm), and for :data:`COMPRESSED` its compressed step on a
    1×1 mesh."""
    jax, jnp, rconfigs, rmodels, rserve = _jax()
    from repro.distributed.sharding import ParallelismRules as RRules
    from repro.train import (CompressionConfig, OptimizerConfig, init_opt_state,
                             make_compressed_train_step, make_loss_fn)

    cfg_r, cfg = _cfg(arch, rconfigs), _cfg(arch)
    oc, ccfg = OptimizerConfig(**OC), CompressionConfig(**CCFG)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    loss_fn = make_loss_fn(cfg_r)
    batch, params = _ref_batch(case), case["params"]
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    grads = convert.model_state(np_tree(grads), cfg)
    out = dict(loss=float(loss), aux=float(metrics["aux"]), grads=grads,
               grad_norm=float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                           for g in grads.values()))))
    if arch not in COMPRESSED:
        return out
    state = {"params": params, "opt": init_opt_state(params, oc)}
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    cstep, init_err = make_compressed_train_step(cfg_r, oc, ccfg, mesh, RRules(dp_axes=("data",)),
                                                 remat=None)
    with warnings.catch_warnings():  # the frozen reference calls jax.lax.pvary, deprecated
        warnings.filterwarnings("ignore", "jax.lax.pvary", DeprecationWarning)
        stc, mc = cstep({**state, "err": init_err(params)}, batch, jax.random.key(9))
    out["compressed"] = dict(metrics={k: float(v) for k, v in mc.items()},
                             params=convert.model_state(np_tree(stc["params"]), cfg))
    return out


@pytest.fixture(scope="module")
def runs():
    """``(references, the two ranks' results, the four ranks' results, the
    one-process CLI runs)``. The ranks start once the weights, the train
    states, the sketches and the reference's compressed conversion are
    ready; the reference's greedy runs and steps, and the one-process CLIs,
    go on here meanwhile."""
    cases = {arch: _case(arch) for arch in ARCHS}
    for arch in ARCHS:
        cases[arch]["state"], cases[arch]["sketches"] = _ref_state(cases[arch])
    refs = {}
    sketches, refs["compressed"] = _ref_compressed(cases[VISION])
    cases[VISION]["kv_sketches"] = sketches
    jobs = dict(cases=cases)
    run2 = [("serve", arch, (1, 2)) for arch in ARCHS]
    run2 += [("train", arch, (1, 2)) for arch in ARCHS]
    run2 += [("compressed", (1, 2))]
    run2 += [("control", kind, (1, 2)) for kind in ("whole", "own_mean", "gate_after")]
    run2 += [("cli_serve", tuple(CLI_SERVE + ["--arch", arch])) for arch in CLI_ARCHS]
    run2 += [("cli_train", tuple(CLI_TRAIN + ["--arch", arch])) for arch in CLI_ARCHS]
    run4 = [("serve", arch, (2, 2)) for arch in ARCHS]
    run4 += [("train", arch, (2, 2)) for arch in ARCHS]
    run4 += [("compressed", (2, 2))]
    two = _Ranks(2, dict(jobs, run=run2))
    four = _Ranks(4, dict(jobs, run=run4))

    try:
        refs["greedy"] = {arch: _ref_greedy(arch, cases[arch]) for arch in ARCHS}
        refs["train"] = {arch: _ref_train(arch, cases[arch]) for arch in ARCHS}
        from repro_torch.launch import serve as lserve
        from repro_torch.launch import train as ltrain

        one = {}
        for arch in CLI_ARCHS:
            one[("cli_serve", arch)] = lserve.main(CLI_SERVE + ["--arch", arch]).numpy()
            with tempfile.TemporaryDirectory() as d:
                one[("cli_train", arch)] = list(map(float, ltrain.main(
                    CLI_TRAIN + ["--arch", arch, "--ckpt-dir", d]).losses))
    except BaseException:
        two.close()
        four.close()
        raise
    return refs, two.results(), four.results(), one, cases


@pytest.fixture(scope="module")
def refs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ranks(runs):
    """Every rank's results by mesh: ``{shape: {rank: results}}``."""
    _, two, four, _, _ = runs
    return {(1, 2): two, (2, 2): four}


@pytest.fixture(scope="module")
def one(runs):
    return runs[3]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

SHAPES = pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
ARCH = pytest.mark.parametrize("arch", ARCHS, ids=["mamba2", "zamba2", "vision"])


@SHAPES
@ARCH
def test_generate_matches_reference(refs, ranks, arch, shape):
    """Tokens, prefill's and each decode step's logits against the
    reference on the global batch, on the eager route; the prefill cache
    (Mamba-2's conv windows and states, the shared and cross K/V) the
    rank's block of the reference's."""
    ref = refs["greedy"][arch]
    cfg = _cfg(arch)
    for rank, res in ranks[shape].items():
        r = res[("serve", arch, shape)]
        what = f"{arch} {shape} rank {rank}"
        assert np.array_equal(r["tokens"], _rows(ref["tokens"], shape, rank)), what
        assert r["route"] == "eager", what
        _close(r["prefill_logits"], _rows(ref["prefill_logits"], shape, rank),
               what=f"{what} prefill logits")
        assert len(r["logits"]) == N - 1
        for i, (g, w) in enumerate(zip(r["logits"], ref["logits"])):
            _close(g, _rows(w, shape, rank), what=f"{what} decode step {i}")
        want = convert.dense_cache(ref["cache"], cfg, "cpu",
                                   mesh=Mesh(dict(zip(("data", "model"), shape)), rank))
        for li, (got, w) in enumerate(zip(r["cache"], want["layers"])):
            assert set(got) == set(w), (what, li)
            for name, t in w.items():
                t = t.numpy()
                if name == "ssm":
                    assert t.shape[1] == _cfg(arch).ssm_heads // shape[1]
                _close(got[name][:, :S] if name in ("k", "v") and t.shape[1] > S else got[name],
                       t[:, :S] if name in ("k", "v") and t.shape[1] > S else t,
                       what=f"{what} layer {li} {name}")


@SHAPES
def test_vision_compressed_cache_on_a_ranks_heads(refs, ranks, shape):
    """The reference's sketches handed in whole: each rank keeps its rows'
    and KV heads' of the self-attention layers (the cross K/V pass
    through) and gets the reference's tokens and factors for them."""
    ref = refs["compressed"]
    d, m = shape
    for rank, res in ranks[shape].items():
        r = res[("compressed", shape)]
        assert np.array_equal(r["tokens"], _rows(ref["tokens"], shape, rank)), (shape, rank)
        di, mi = rank // m, rank % m
        assert len(r["factors"]) == len(ref["factors"]) == 4
        for layer, (got, want_layer) in enumerate(zip(r["factors"], ref["factors"])):
            for name, (v_s, sigma, u) in got.items():
                Bl, KVl = sigma.shape[:2]
                # the reference's (B, KV, ...) of a segment of one layer
                want = [x.reshape(-1, *x.shape[x.ndim - t:])[0, di * Bl:(di + 1) * Bl,
                                                             mi * KVl:(mi + 1) * KVl]
                        for x, t in zip(want_layer[name], (4, 3, 4))]
                _close(sigma, want[1], FAC_TOL, f"{shape} rank {rank} layer {layer} {name}")
                recon = lambda a, s, b: np.einsum("...sr,...r,...dr->...sd", a, s, b)  # noqa
                _close(recon(v_s, sigma, u), recon(*want), FAC_TOL,
                       f"{shape} rank {rank} layer {layer} {name} reconstruction")


def _whole_equal_on_the_model_ranks(ranks, shape, arch, key):
    m = shape[1]
    names = [k for k in ranks[0][("train", arch, shape)][key]["params"] if _leaf(k) in WHOLE]
    assert names
    for rank, res in ranks.items():
        other = ranks[rank - rank % m][("train", arch, shape)][key]["params"]
        mine = res[("train", arch, shape)][key]["params"]
        for k in names:
            assert np.array_equal(mine[k], other[k]), (arch, shape, key, rank, k)


@SHAPES
@ARCH
def test_plain_step_matches_reference(refs, ranks, arch, shape):
    """Over the global batch: loss, aux, every gradient leaf (the whole
    leaves included) and the gradient norm (the blocks' squares summed over
    the model axis); after the step every whole leaf is equal bit for bit
    on the model ranks."""
    ref = refs["train"][arch]
    seen = set()
    for rank, res in ranks[shape].items():
        r = res[("train", arch, shape)]
        m = r["plain"]["metrics"]
        assert abs(m["loss"] / ref["loss"] - 1) <= LOSS_TOL, (m["loss"], ref["loss"])
        if ref["aux"]:
            assert abs(m["aux"] / ref["aux"] - 1) <= LOSS_TOL
        assert abs(m["grad_norm"] / ref["grad_norm"] - 1) <= LOSS_TOL
        for k, g in _blocks(ref["grads"], shape, rank).items():
            assert _rel(r["grads"][k], g) <= GRAD_TOL, (k, _rel(r["grads"][k], g))
            seen.add(_leaf(k))
    assert seen & WHOLE == (MAMBA_WHOLE if arch != VISION else {"vision_proj", "gate"})
    _whole_equal_on_the_model_ranks(ranks[shape], shape, arch, "plain")


@pytest.mark.parametrize("arch", COMPRESSED, ids=["zamba2", "vision"])
def test_compressed_step_matches_reference(refs, ranks, arch):
    """At 1×2 on the reference's sketches: the reference's compressed step
    on a 1×1 mesh (metrics, every updated block); each whole leaf is
    compressed with the same sketches on both model ranks, so it is equal
    bit for bit on them."""
    ref = refs["train"][arch]["compressed"]
    shape = (1, 2)
    for rank, res in ranks[shape].items():
        r = res[("train", arch, shape)]["compressed"]
        m, want = r["metrics"], ref["metrics"]
        assert m["comp/ratio"] == pytest.approx(want["comp/ratio"], rel=1e-6)
        assert m["comp/wire_floats"] == want["comp/wire_floats"]
        assert abs(m["loss"] / want["loss"] - 1) <= LOSS_TOL
        assert abs(m["comp/rel_err"] / want["comp/rel_err"] - 1) <= 1e-3
        for k, w in _blocks(ref["params"], shape, rank).items():
            assert float(np.abs(r["params"][k] - w).max()) <= PARAM_TOL, k
    _whole_equal_on_the_model_ranks(ranks[shape], shape, arch, "compressed")


def test_whole_leaves_without_copy_to_tp_break_their_gradients(refs, ranks):
    """The control: zamba2's Mamba-2 layers reading ``bc``, ``dt``, ``A``,
    ``D`` and ``w_out`` without ``copy_to_tp`` leave each rank with the
    gradient of its heads' part of them."""
    ref = refs["train"][ZAMBA]
    got = ranks[(1, 2)][0][("control", "whole", (1, 2))]
    want = _blocks(ref["grads"], (1, 2), 0)
    worst = max(_rel(got[k], want[k]) for k in want if _leaf(k) in WHOLE)
    assert worst > 100 * GRAD_TOL, worst


def test_gated_norm_on_the_ranks_own_mean_fails(refs, ranks):
    """The control: mamba2's gated RMSNorm over the rank's own channels
    changes prefill's logits far beyond the bound."""
    ref = refs["greedy"][MAMBA]["prefill_logits"]
    got = ranks[(1, 2)][0][("control", "own_mean", (1, 2))]
    with pytest.raises(AssertionError):
        _close(got, ref, 100 * TOL, "own mean")


def test_reduce_after_the_cross_gate_breaks_its_gradient(refs, ranks):
    """The control: the vision model's cross output summed after the gate's
    product leaves each rank the gate gradient of its heads alone."""
    ref = refs["train"][VISION]
    got = ranks[(1, 2)][0][("control", "gate_after", (1, 2))]
    gates = [k for k in ref["grads"] if _leaf(k) == "gate"]
    assert gates
    assert max(_rel(got[k], ref["grads"][k]) for k in gates) > 100 * GRAD_TOL


@pytest.mark.parametrize("arch", CLI_ARCHS, ids=["zamba2", "vision"])
def test_launch_serve_cli_at_mesh_1x2_matches_1x1(ranks, one, arch):
    for res in ranks[(1, 2)].values():
        got = res[("cli_serve", tuple(CLI_SERVE + ["--arch", arch]))]
        assert np.array_equal(got, one[("cli_serve", arch)]), arch


@pytest.mark.parametrize("arch", CLI_ARCHS, ids=["zamba2", "vision"])
def test_launch_train_cli_at_mesh_1x2_matches_1x1(ranks, one, arch):
    for res in ranks[(1, 2)].values():
        got = res[("cli_train", tuple(CLI_TRAIN + ["--arch", arch]))]
        np.testing.assert_allclose(got, one[("cli_train", arch)], rtol=LOSS_TOL)
