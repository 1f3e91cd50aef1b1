"""End-to-end training driver (counterpart of ``repro/launch/train.py``, with
the reference's flags and defaults, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch llama3.2-1b --d-model 512 --layers 12 --heads 8 --kv-heads 4 \\
      --d-ff 2048 --vocab 8192 --batch 16 --seq 256 --steps 200 \\
      [--grad-compress --compress-rank 32] [--device cpu]

Runs on the card (``--device cpu`` runs on the CPU) through
``run_resilient_loop``, checkpointing every ``--ckpt-every`` steps into
``--ckpt-dir`` (default: ``repro_torch_ckpt_<arch>`` in the temporary
directory). ``--mesh d x m`` lays the process group's ``d · m`` ranks out as
the reference's (data, model) mesh (``launch/mesh.py``): 1x1 in one
process, else the ranks ``torchrun`` starts (the group is then made from
its environment: NCCL on the card, one rank a card; gloo on the CPU) or a
default group the caller made (gloo ranks sharing one card). Each rank
trains on its data-parallel share of the batch; ``m > 1`` is tensor
parallelism (each rank holds its block of every weight, the dense archs
only), ``d > 1`` data parallelism by the mean of the gradients, or by GMR
compression with ``--grad-compress``. The default is the world by 1. Each
rank keeps its own checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

from ..checkpoint import run_resilient_loop
from ..configs import get_arch
from ..data import DataConfig, SyntheticLM
from ..device import fold_in, generator, resolve_device
from ..distributed import ParallelismRules, shard_params
from ..models import init_params, param_count
from .mesh import cli_mesh
from ..train import (CompressionConfig, OptimizerConfig, compression_ratio, init_opt_state,
                     make_compressed_train_step, make_train_step)


def build_config(args):
    mod = get_arch(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    over = {}
    if args.d_model:
        over.update(d_model=args.d_model, d_ff=args.d_ff or 4 * args.d_model)
    if args.layers:
        base = mod.full_config()
        # rebuild the pattern at the requested depth with the same block mix
        reps = base.pattern * ((args.layers // len(base.pattern)) + 1)
        over.update(n_layers=args.layers, pattern=tuple(reps[: args.layers]))
    if args.heads:
        over.update(n_heads=args.heads)
    if args.kv_heads:
        over.update(n_kv_heads=args.kv_heads)
    if args.head_dim:
        over.update(head_dim=args.head_dim)
    if args.vocab:
        over.update(vocab_size=args.vocab)
    if args.dtype:
        over.update(dtype=args.dtype)
    if over:
        cfg = dataclasses.replace(cfg, **over)
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--heads", type=int, default=0)
    ap.add_argument("--kv-heads", type=int, default=0)
    ap.add_argument("--head-dim", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="", help="data x model, e.g. 2x1 (default: the world x 1)")
    ap.add_argument("--remat", default="dots", choices=["dots", "full", "none"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--compress-rank", type=int, default=32)
    ap.add_argument("--compress-factor", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at-step", type=int, default=-1, help="inject a crash (FT demo)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = cli_mesh(args.mesh, dev, args.batch)
    d, m = mesh.shape["data"], mesh.shape["model"]
    rank, world = mesh.rank, d * m
    cfg = build_config(args)

    params = init_params(generator(args.seed, dev), cfg, device=dev)
    n_params = param_count(params)
    ratio = None
    if args.grad_compress:
        ccfg = CompressionConfig(rank=args.compress_rank, sketch_factor=args.compress_factor,
                                 min_dim=min(512, cfg.d_model))
        ratio = compression_ratio(params, ccfg)  # of the whole leaves
    shard_params(params, ParallelismRules(), mesh)
    oc = OptimizerConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                         total_steps=args.steps)
    state = {"params": params, "opt": init_opt_state(params, oc)}
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, mesh {d}x{m}, "
          f"{args.steps} steps @ batch {args.batch}x{args.seq} on {dev}")

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                                  seq_len=args.seq, seed=args.seed), device=dev)
    share, at = args.batch // d, mesh.index("data")

    def batch_fn(step):
        return {k: v[at * share:(at + 1) * share] for k, v in data.batch_at(step).items()}

    remat = None if args.remat == "none" else args.remat

    if args.grad_compress:
        print(f"[train] GMR gradient compression: rank={ccfg.rank} s={ccfg.s} "
              f"DP volume ratio={ratio:.1f}x")
        cstep, init_err = make_compressed_train_step(cfg, oc, ccfg, mesh=mesh, remat=remat)
        state["err"] = init_err(params)

        def step_fn(state, batch, step):
            return cstep(state, batch, fold_in(9, step))
    else:
        base_step = make_train_step(cfg, oc, remat=remat, microbatch=args.microbatch, mesh=mesh)

        def step_fn(state, batch, step):
            return base_step(state, batch)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), f"repro_torch_ckpt_{cfg.name}")
    if world > 1:
        ckpt_dir = os.path.join(ckpt_dir, f"rank{rank}")  # each rank's blocks and err are its own
    t0 = time.time()
    report = run_resilient_loop(
        state=state,
        step_fn=step_fn,
        batch_fn=batch_fn,
        n_steps=args.steps,
        ckpt_dir=ckpt_dir,
        ckpt_every=args.ckpt_every,
        fail_at_step=args.fail_at_step if args.fail_at_step >= 0 else None,
    )
    dt = time.time() - t0
    print(f"[train] done: {report.steps_run} steps in {dt:.1f}s "
          f"({dt/max(report.steps_run,1)*1e3:.0f} ms/step), restarts={report.restarts}, "
          f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f}")
    return report


if __name__ == "__main__":
    main()
