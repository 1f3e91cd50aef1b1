"""The port's dry run (``repro_torch.launch.dryrun``), hill-climbing
(``repro_torch.launch.hillclimb``) and scan-body census gate
(``tools/torch_census_check.py``), on ``meta`` and ``fake`` process groups.

* ``run_cell`` on smoke configs at small fake meshes, 2×2 and the
  multi-pod 2×2×2, for train, prefill and decode of one dense (llama3.2-1b),
  one MoE (deepseek-v2-lite), one SSM (mamba2-1.3b) and one vision arch
  (llama-3.2-vision-90b, FSDP as in the production cells): each record
  holds the reference's keys, and the census saw work and the collectives
  of the mesh (FSDP's gathers and reduce-scatters for the vision model's
  training).
* The ``long_500k`` cells of zamba2, gemma3 and mamba2 at smoke configs:
  the cache's sequence over the data axes, the token replicated (the
  reference's ``seq_shard``); the census counts three data-axis all-reduces
  a GQA layer over the same cell's decode without it. A long cell of an
  MLA arch (no reference cell: its latent is not cut over the sequence) and
  hill-climb cell C (sequence parallelism in prefill) raise
  ``NotImplementedError``, naming ROADMAP.md §1.
* The compressed step's all-reduce wire bytes on a fake 4×1 mesh lie below
  the plain step's, the reference's ``scenario_compressed_reduces_wire_bytes``
  (``tests/multidev_scenario.py``) on the port's census.
* ``tools/torch_census_check.py`` runs on its two configs: the streaming
  config passes its gates and its committed budget; the adaptive config's
  chunk route moves more bytes a panel than the per-panel body, whose
  kernel 3 admits in the kernel (ROADMAP.md §3), so its gate test is a
  strict ``xfail``.
"""

import dataclasses
import importlib.util
import json
import os

import pytest

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun, hillclimb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x2": {"data": 2, "model": 2}, "2x2x2": {"pod": 2, "data": 2, "model": 2}}
ARCHS = ["llama3.2-1b", "deepseek-v2-lite-16b", "mamba2-1.3b", "llama-3.2-vision-90b"]
KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
# the reference's record keys (``repro/launch/dryrun.py::run_cell``) that the
# port's census fills; lower_s, compile_s, while_trip_counts and
# xla_cost_analysis have no counterpart
KEYS = {"arch", "shape", "mesh", "tag", "n_params", "n_active_params", "flops_per_device",
        "hbm_bytes_per_device", "collectives", "memory"}


@pytest.fixture
def fake_pg():
    import torch.distributed as dist

    yield
    dryrun._MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_records_smoke_cells(fake_pg, tmp_path, arch, kind):
    cfg = get_arch(arch).smoke_config()
    for name, shape in MESHES.items():
        rec = dryrun.run_cell(arch, KINDS[kind], out_dir=str(tmp_path), mesh_shape=shape,
                              config=cfg, verbose=False)
        assert KEYS <= set(rec) and rec["mesh"] == name
        with open(tmp_path / f"{arch}__{KINDS[kind]}__{name}.json") as f:
            assert json.load(f) == rec
        assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
        assert rec["memory"]["peak_estimate_bytes"] >= rec["memory"]["argument_bytes"] > 0
        assert rec["n_active_params"] <= rec["n_params"]
        colls = rec["collectives"]
        assert colls["all-reduce"]["count"] > 0  # the model axis's sums
        fsdp = arch in dryrun.FSDP_ARCHS and kind == "train"
        assert ("reduce-scatter" in colls) == fsdp, colls
        if arch in dryrun.FSDP_ARCHS:
            assert colls["all-gather"]["group_size"] == shape["data"]


LONG = ["zamba2-1.2b", "gemma3-12b", "mamba2-1.3b"]


@pytest.mark.parametrize("arch", LONG)
def test_long_500k_cells_census_the_sequence_sharded_cache(fake_pg, tmp_path, arch):
    """Each rank decodes the whole token (batch 1) against its block of every
    K/V cache: three all-reduces a GQA layer over the data axes (the row
    max, the row sum, the partial outputs) beyond the model axis's, and the
    cache's bytes a rank fall by the data axes' size."""
    from repro_torch.models.config import ATTN, ATTN_LOCAL, SHARED_ATTN

    cfg = get_arch(arch).smoke_config()
    n_gqa = sum(s.mixer in (ATTN, ATTN_LOCAL, SHARED_ATTN) for s in cfg.pattern)
    assert (n_gqa > 0) == (arch != "mamba2-1.3b")
    for name, shape in MESHES.items():
        rec = dryrun.run_cell(arch, "long_500k", out_dir=str(tmp_path), mesh_shape=shape,
                              config=cfg, verbose=False)
        assert KEYS <= set(rec) and rec["mesh"] == name and rec["flops_per_device"] > 0
        whole = dryrun.run_cell(arch, "long_500k", out_dir=str(tmp_path), tag="whole",
                                mesh_shape={"data": 1, "model": shape["model"]}, config=cfg,
                                verbose=False)
        d = shape.get("pod", 1) * shape["data"]
        got, want = rec["collectives"]["all-reduce"], whole["collectives"]["all-reduce"]
        assert got["count"] == want["count"] + 3 * n_gqa, (got, want)
        assert got["group_size"] == (d if n_gqa else shape["model"])
        if n_gqa:  # the K/V caches dominate the arguments at 524288 slots
            ratio = rec["memory"]["argument_bytes"] / whole["memory"]["argument_bytes"]
            assert ratio < 1.1 / d, ratio


def test_long_cells_and_seq_parallel_raise(fake_pg, tmp_path):
    """A long cell of an MLA arch (the reference has none) raises: its latent
    is not cut over the sequence; hill-climb cell C, sequence parallelism in
    prefill, raises."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1"):
        dryrun.run_cell("deepseek-v2-lite-16b", "long_500k", out_dir=str(tmp_path),
                        mesh_shape=MESHES["2x2"],
                        config=get_arch("deepseek-v2-lite-16b").smoke_config())
    arch, shape, variants = hillclimb.PLAN["C"]
    assert [v[0] for v in variants] == ["C1_seqparallel", "C2_seqparallel_chunk512"]
    for _, overrides, _ in variants:
        with pytest.raises(NotImplementedError, match="sequence parallelism"):
            dryrun.run_cell(arch, shape, out_dir=str(tmp_path), mesh_shape=MESHES["2x2"],
                            config=get_arch(arch).smoke_config(), overrides=dict(overrides))


def test_hillclimb_plan_and_terms():
    """The reference's cells, tags and overrides; the terms are one rank's
    census over the H100's data-sheet peaks."""
    from repro.launch import hillclimb as ref

    assert {c: (a, s, [(t, o) for t, o, _ in v]) for c, (a, s, v) in hillclimb.PLAN.items()} \
        == {c: (a, s, [(t, o) for t, o, _ in v]) for c, (a, s, v) in ref.PLAN.items()}
    rec = dict(flops_per_device=989e12, hbm_bytes_per_device=3.35e12,
               collectives={"all-reduce": {"wire_bytes": 450e9}},
               memory={"peak_estimate_bytes": 2e9})
    assert hillclimb.terms(rec) == dict(compute=1.0, memory=1.0, collective=1.0, mem_gb=2.0)


def test_compressed_step_moves_fewer_all_reduce_bytes(fake_pg, tmp_path):
    cfg = dataclasses.replace(get_arch("llama3.2-1b").smoke_config(), d_model=512, d_ff=2048,
                              vocab_size=512)
    shape = {"data": 4, "model": 1}
    common = dict(out_dir=str(tmp_path), mesh_shape=shape, config=cfg, verbose=False)
    plain = dryrun.run_cell("llama3.2-1b", "train_4k", overrides={"_remat": None}, tag="plain",
                            **common)
    comp = dryrun.run_cell("llama3.2-1b", "train_4k", tag="gmr", overrides={
        "_remat": None, "_compress_rank": 8, "_compress_factor": 2, "_compress_min_dim": 512},
        **common)
    ar_plain = plain["collectives"]["all-reduce"]["wire_bytes"]
    ar_comp = comp["collectives"]["all-reduce"]["wire_bytes"]
    assert 0 < ar_comp < ar_plain, (ar_comp, ar_plain)
    assert comp["kernels"]["twoside_sketch"]["launches"] > 0  # M through kernel 4


def _census_check():
    spec = importlib.util.spec_from_file_location(
        "torch_census_check", os.path.join(ROOT, "tools", "torch_census_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def census_check():
    mod = _census_check()
    with open(mod.BUDGET_PATH) as fh:
        budget = json.load(fh)
    return mod, mod.measure(), budget


def test_census_check_streaming_passes(census_check):
    mod, results, budget = census_check
    name = "streaming_cur/512x512_p128_c16"
    assert mod.check({name: results[name]}, budget) == []
    assert set(results) == set(budget["configs"])


@pytest.mark.xfail(strict=True, reason="ROADMAP.md §3: on the port the adaptive config's chunk "
                   "route moves 1.60e7 bytes a panel against the per-panel body's 9.71e6 "
                   "(kernel 3 admits in the kernel); the 0.75 and 1.0 gates are not loosened")
def test_census_check_adaptive_passes(census_check):
    mod, results, budget = census_check
    name = "adaptive_cur/2048x1024_p256_c16"
    assert mod.check({name: results[name]}, budget) == []


def test_census_check_adaptive_within_budget(census_check):
    mod, results, budget = census_check
    name = "adaptive_cur/2048x1024_p256_c16"
    failures = mod.check({name: results[name]}, budget)
    assert failures and all("ratio" in f for f in failures), failures


def test_census_check_tool_imports_nothing_of_jax_or_the_reference():
    import ast

    path = os.path.join(ROOT, "tools", "torch_census_check.py")
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names and not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
