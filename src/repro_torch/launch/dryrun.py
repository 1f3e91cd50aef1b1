"""Multi-pod dry run: census one rank's program of every (arch × shape ×
mesh) cell (counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's SPMD program for 256 or 512
devices and reads the compiled module. The port runs one rank's program
eagerly, on the ``meta`` device: the process is rank 0 of a ``fake``
process group of 256 (16×16) or 512 (2×16×16) ranks, the production mesh's
groups are made over it (:func:`~repro_torch.launch.mesh.world_mesh`),
the parameters are the run time's own cuts (``init_params(..., mesh=)``,
FSDP over ``data`` for :data:`FSDP_ARCHS`), and the optimizer state, the
caches, the tokens and the vision embeddings are one rank's shapes. A
:class:`~repro_torch.launch.hlo_census.Census` counts what the rank
dispatches: flops, bytes, ops, collectives (their bytes, not their data:
the fake group moves nothing), the hand-written kernels' shape-only
launches and the peak of the bytes live at once, which stands for the
reference's ``memory_analysis``. Nothing touches a card. ``lower_s``,
``compile_s`` and ``xla_cost_analysis`` have no counterpart; the record
holds the census's own wall seconds (``census_s``) instead.

Each cell writes ``dryrun_out/<arch>__<shape>__<mesh>[__<tag>].json`` at the
repository root. The ``long_500k`` cells (batch 1) cut the decode cache's
sequence over the data axes with the token replicated there (the
reference's ``seq_shard``): each rank decodes the whole token against its
block of every K/V cache, and the census counts the data axes' all-reduces
of the combine. ``--all`` reports a failing cell and exits 1, as the
reference's ``main`` does.

Usage (on the CPU, no card)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCHS, SHAPES, get_arch
from ..distributed.sharding import ParallelismRules, activation_sharding
from ..models import decode_step, init_cache, init_params, prefill
from ..models.config import ModelConfig
from ..models.transformer import Transformer
from ..train import (CompressionConfig, OptimizerConfig, init_opt_state,
                     make_compressed_train_step, make_train_step)
from .hlo_census import Census
from .mesh import world_mesh

__all__ = ["ARTIFACT_DIR", "FSDP_ARCHS", "active_param_count", "input_specs", "main",
           "rules_for", "run_cell"]

ARTIFACT_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                            "dryrun_out"))

# archs whose weight blocks on the model axis alone exceed a card (kimi-k2
# ≈ 2 TB, the vision model 163 GiB at 100 layers): FSDP over ``data``
FSDP_ARCHS = {"kimi-k2-1t-a32b", "llama-3.2-vision-90b"}

META = torch.device("meta")
_MESHES: dict = {}


def rules_for(arch_id: str, mesh, knobs: dict | None = None) -> ParallelismRules:
    rules = ParallelismRules(fsdp=arch_id in FSDP_ARCHS).with_mesh(mesh)
    knobs = knobs or {}
    if knobs.get("_no_fsdp"):
        rules = dataclasses.replace(rules, fsdp=False)
    if knobs.get("_seq_parallel"):
        rules = dataclasses.replace(rules, seq_parallel=True, tp_enabled=False)
    return rules


PRODUCTION = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}


def census_mesh(shape: dict):
    """A mesh of ``shape`` (the production mesh's by default, 16×16 or
    2×16×16) over a ``fake`` process group of as many ranks, this process
    rank 0; made once a shape (a new world replaces the process group)."""
    key = tuple(shape.items())
    if key not in _MESHES:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        world = math.prod(shape.values())
        if not dist.is_initialized() or dist.get_world_size() != world:
            if dist.is_initialized():
                dist.destroy_process_group()
            _MESHES.clear()
            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        _MESHES[key] = world_mesh(dict(shape))
    return _MESHES[key]


def _split(knobs_and_fields: dict | None):
    # underscore-prefixed overrides are step-level knobs, not config fields
    overrides = dict(knobs_and_fields or {})
    knobs = {k: overrides.pop(k) for k in list(overrides) if k.startswith("_")}
    return overrides, knobs


def input_specs(arch_id: str, shape_name: str, mesh, *, overrides: dict | None = None,
                config: ModelConfig | None = None):
    """One rank's program of a cell on ``meta``: ``(step, args, context)``,
    ``step(*args)`` run inside ``context`` (the activation sharding of a
    prefill or decode; a train step makes its own). ``config`` replaces the
    arch's full config (a smoke config in the tests)."""
    cfg = _config(arch_id, overrides, config)
    knobs = _split(overrides)[1]
    cell = SHAPES[shape_name]
    rules = rules_for(arch_id, mesh, knobs)
    params = init_params(torch.Generator(), cfg, device=META, mesh=mesh, rules=rules)
    # long_500k (batch 1): the cache's sequence over the data axes and the
    # token replicated there, as the reference's seq_shard cell
    seq_shard = shape_name == "long_500k"
    B = cell.global_batch if seq_shard else cell.global_batch // mesh.axis_size(rules.dp_axes)

    def tokens(seq):
        return torch.zeros((B, seq), dtype=torch.int32, device=META)

    vision = (torch.zeros((B, cfg.n_patches, cfg.d_vision), dtype=cfg.param_dtype, device=META)
              if cfg.d_vision else None)

    if cell.kind == "train":
        oc = OptimizerConfig(moments_dtype=knobs.get("_moments_dtype", "float32"))
        state = {"params": params, "opt": init_opt_state(params, oc)}
        batch = {"tokens": tokens(cell.seq_len)}
        if vision is not None:
            batch["vision"] = vision
        remat = knobs.get("_remat", "full")
        if knobs.get("_compress_rank"):
            ccfg = CompressionConfig(rank=int(knobs["_compress_rank"]),
                                     sketch_factor=int(knobs.get("_compress_factor", 4)),
                                     min_dim=int(knobs.get("_compress_min_dim", 1024)))
            cstep, init_err = make_compressed_train_step(cfg, oc, ccfg, mesh=mesh, rules=rules,
                                                         remat=remat)
            state["err"] = init_err(params)
            return (lambda st, b: cstep(st, b, 7)), (state, batch), contextlib.nullcontext()
        step = make_train_step(cfg, oc, remat=remat, microbatch=knobs.get("_microbatch", 1),
                               mesh=mesh, rules=rules)
        return step, (state, batch), contextlib.nullcontext()

    if cell.kind == "prefill":
        def step(params, toks, vision=None):
            return prefill(params, cfg, toks, cell.seq_len, vision)

        return step, (params, tokens(cell.seq_len), vision), activation_sharding(mesh, rules)

    # decode: one token against a seq_len cache
    with activation_sharding(mesh, rules, seq_shard=seq_shard):
        cache = init_cache(cfg, B, cell.seq_len, device=META)

    def step(params, cache, token):
        return decode_step(params, cfg, cache, token)

    return (step, (params, cache, tokens(1)),
            activation_sharding(mesh, rules, seq_shard=seq_shard))


def _config(arch_id: str, overrides: dict | None, config: ModelConfig | None) -> ModelConfig:
    cfg = config or get_arch(arch_id).full_config()
    fields = _split(overrides)[0]
    return dataclasses.replace(cfg, **fields) if fields else cfg


def active_param_count(cfg: ModelConfig, n_params: int) -> int:
    """Parameters touched per token: total minus the inactive expert share."""
    if not cfg.n_experts:
        return n_params
    expert = 3 * cfg.d_model * cfg.d_ff_expert  # gate+up+down per expert
    n_moe_layers = sum(1 for b in cfg.pattern if b.ffn == "moe")
    return n_params - n_moe_layers * (cfg.n_experts - cfg.moe_top_k) * expert


def _n_params(cfg: ModelConfig) -> int:
    model = Transformer(torch.Generator(), cfg, META)
    return sum(math.prod(p.shape) for p in model.parameters())


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False, out_dir: str = ARTIFACT_DIR,
             overrides: dict | None = None, tag: str = "", verbose: bool = True,
             mesh_shape: dict | None = None, config: ModelConfig | None = None) -> dict:
    """Census one cell and write its record; ``mesh_shape`` and ``config``
    replace the production mesh and the full config (the tests' small
    cells)."""
    shape = mesh_shape or PRODUCTION[multi_pod]
    mesh = census_mesh(shape)
    mesh_name = "x".join(str(v) for v in shape.values())
    t0 = time.time()
    step, args, context = input_specs(arch_id, shape_name, mesh, overrides=overrides,
                                      config=config)
    census = Census()
    census.track(args)
    argument_bytes = census.live
    with context, census:
        step(*args)
    cen = census.result()
    cfg = _config(arch_id, overrides, config)
    n_params = _n_params(cfg)
    record = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh_name,
        "tag": tag,
        "census_s": round(cen["wall_s"], 2),
        "cell_s": round(time.time() - t0, 2),
        "n_params": n_params,
        "n_active_params": active_param_count(cfg, n_params),
        # one rank's census
        "flops_per_device": cen["flops"],
        "hbm_bytes_per_device": cen["hbm_bytes"],
        "n_ops": cen["n_ops"],
        "collectives": cen["collectives"],
        "kernels": cen["kernels"],
        "memory": {
            "argument_bytes": argument_bytes,
            "peak_estimate_bytes": cen["peak_bytes"],
        },
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fname = f"{arch_id.replace('/', '_')}__{shape_name}__{mesh_name}{suffix}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(record, f, indent=1)
    if verbose:
        mem_gb = record["memory"]["peak_estimate_bytes"] / 1e9
        wire = sum(v["wire_bytes"] for v in cen["collectives"].values())
        colls = ", ".join(f"{k}:{int(v['count'])}" for k, v in cen["collectives"].items())
        print(f"[dryrun] {arch_id:22s} {shape_name:12s} {mesh_name:8s} "
              f"census={cen['wall_s']:6.1f}s flops/dev={record['flops_per_device']:.3e} "
              f"mem/dev={mem_gb:7.2f}GB wire/dev={wire / 1e9:8.3f}GB colls={{{colls}}}",
              flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch_id, mod in ARCHS.items():
            for shape in mod.SUPPORTED_SHAPES:
                cells.append((arch_id, shape))
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        cells.append((args.arch, args.shape))

    meshes = [False, True] if args.both_meshes or args.all else [args.multi_pod]
    failures = []
    for arch_id, shape in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            fname = os.path.join(args.out, f"{arch_id}__{shape}__{mesh_name}.json")
            if args.skip_existing and os.path.exists(fname):
                print(f"[dryrun] skip existing {arch_id} {shape} {mesh_name}")
                continue
            try:
                run_cell(arch_id, shape, multi_pod=mp, out_dir=args.out)
            except Exception as e:  # noqa: BLE001 — report all cell failures at the end
                failures.append((arch_id, shape, mesh_name, repr(e)))
                print(f"[dryrun] FAIL {arch_id} {shape} {mesh_name}: {e}", flush=True)
                if not isinstance(e, NotImplementedError):
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL CELLS OK")


if __name__ == "__main__":
    main()
