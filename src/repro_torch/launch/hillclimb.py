"""Hill-climbing: run tagged variants of the three chosen cells and
print hypothesis → before → after per roofline term (counterpart of
``repro/launch/hillclimb.py``).

Each variant is a :func:`~repro_torch.launch.dryrun.run_cell` of the port's
dry run, censused on ``meta`` at 16×16 (no card), written beside the
baseline records in ``dryrun_out/`` (``python -m
repro_torch.launch.dryrun --all`` writes the baselines first). The terms
are one rank's census over the data-sheet peaks of one NVIDIA H100 SXM at
its 700 W limit (the ``hopper-kernels`` guide): 989 TFLOP/s dense bf16,
3.35 TB/s of HBM, NVLink at 450 GB/s each way. A 16-wide axis crosses
hosts, whose link is slower than NVLink and is not modelled here. Cell C
runs sequence-parallel, which the run time does not take yet: its
variants raise ``NotImplementedError`` (ROADMAP.md §1).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell A|B|C] [--variant NAME]
"""

from __future__ import annotations

import argparse
import json
import os

from .dryrun import ARTIFACT_DIR, run_cell

OUT = ARTIFACT_DIR

# NVIDIA H100 SXM data sheet (700 W): dense bf16 FLOP/s, HBM bytes/s,
# NVLink bytes/s each way
PEAK, HBM, NVLINK = 989e12, 3.35e12, 450e9

# cell → (arch, shape, [(variant_tag, overrides, hypothesis), ...]); the
# reference's cells, tags and overrides
PLAN = {
    "A": ("llama3.2-1b", "train_4k", [
        ("A1_flashvjp", {"attn_impl": "custom_vjp"},
         "on the card both attention impls are one cuDNN SDPA op and its backward, so the "
         "custom-VJP flag changes nothing the census counts: expect every term flat"),
        ("A2_flashvjp_micro2", {"attn_impl": "custom_vjp", "_microbatch": 2},
         "two microbatches halve the activations live at once → peak memory down ~40 %; "
         "bytes ~flat (the same work in two passes, fp32 gradient accumulation adds a pass)"),
        ("A3_flashvjp_gmr64", {"attn_impl": "custom_vjp", "_compress_rank": 64,
                               "_compress_min_dim": 1024, "_remat": None},
         "Algorithm 1 replaces the dense data-axis gradient all-reduce: (C, R, M) sums of "
         "≈ (m+n)·64 + 256² floats a large leaf instead of m·n → all-reduce wire bytes down "
         "by the data axis's share; kernel 4 forms M once a leaf; no remat → flops down ~25 %"),
        ("A4_flashvjp_bf16mom", {"attn_impl": "custom_vjp", "_moments_dtype": "bfloat16"},
         "AdamW's m and v in bf16: the optimizer's resident bytes and its traffic halve → "
         "peak memory down by a quarter of the fp32 moments, memory term slightly down"),
    ]),
    "B": ("kimi-k2-1t-a32b", "train_4k", [
        ("B1_flashvjp", {"attn_impl": "custom_vjp"},
         "as A1: the card's SDPA is one fused op either way → flat"),
        ("B2_flashvjp_bf16mom", {"attn_impl": "custom_vjp", "_moments_dtype": "bfloat16"},
         "kimi's FSDP × expert blocks hold fp32 m and v of ~4 GB a rank: bf16 moments "
         "halve them → peak memory down a few GB"),
        ("B3_flashvjp_bf16mom_cap1_micro4",
         {"attn_impl": "custom_vjp", "_moments_dtype": "bfloat16",
          "capacity_factor": 1.0, "_microbatch": 4},
         "the MoE dispatch buffer (E/m, groups, cap + 1, D) scales with the tokens in "
         "flight: capacity 1.0 and 4 microbatches cut it ~5× → peak memory sharply down; "
         "four microbatches regather every FSDP block four times → wire up ~4×"),
        ("B4_ecd_dp_shard",
         {"attn_impl": "custom_vjp", "_moments_dtype": "bfloat16"},
         "the reference's sharding hint on the dispatch buffer: the port computes each "
         "rank's experts on its own dispatch, so the census equals B2"),
        ("B5_grouped_dispatch",
         {"attn_impl": "custom_vjp", "_moments_dtype": "bfloat16",
          "moe_dispatch_shards": 16},
         "16 dispatch groups: capacity per group, the same buffer bytes → flops and bytes "
         "~flat against B2"),
        ("B6_combined",
         {"attn_impl": "custom_vjp", "_moments_dtype": "bfloat16",
          "moe_dispatch_shards": 16, "capacity_factor": 1.0, "_microbatch": 2},
         "B5 with capacity 1.0 and 2 microbatches: buffers −2.5×, activations halve; FSDP "
         "regathers twice → wire up ~2×, peak memory down"),
    ]),
    "C": ("mamba2-1.3b", "prefill_32k", [
        ("C1_seqparallel", {"_seq_parallel": 1},
         "the model axis's all-reduces move the (B, S, D) residual twice a layer; "
         "sequence-parallel prefill (S over model, weights whole) passes only conv halos and "
         "chunk states → collective term down ~10×"),
        ("C2_seqparallel_chunk512", {"_seq_parallel": 1, "ssm_chunk": 512},
         "with S local a shard, SSD chunks of 512 halve the inter-chunk scan → fewer ops"),
    ]),
}


def terms(rec: dict) -> dict:
    wire = sum(v["wire_bytes"] for v in rec["collectives"].values())
    return dict(
        compute=rec["flops_per_device"] / PEAK,
        memory=rec["hbm_bytes_per_device"] / HBM,
        collective=wire / NVLINK,
        mem_gb=rec["memory"]["peak_estimate_bytes"] / 1e9,
    )


def show(label: str, t: dict, base: dict | None = None) -> None:
    def d(k):
        if base is None:
            return ""
        b = base[k]
        return f" ({t[k] / b:5.2f}x)" if b > 0 else ""

    print(f"  {label:28s} compute={t['compute']:9.3e}{d('compute')}  "
          f"memory={t['memory']:9.3e}{d('memory')}  "
          f"collective={t['collective']:9.3e}{d('collective')}  "
          f"mem/dev={t['mem_gb']:7.1f}GB{d('mem_gb')}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="all", choices=["A", "B", "C", "all"])
    ap.add_argument("--variant", default="")
    args = ap.parse_args(argv)

    cells = PLAN if args.cell == "all" else {args.cell: PLAN[args.cell]}
    for cell_id, (arch, shape, variants) in cells.items():
        with open(os.path.join(OUT, f"{arch}__{shape}__16x16.json")) as f:
            base = terms(json.load(f))
        print(f"\n=== Cell {cell_id}: {arch} / {shape} ===")
        show("baseline (paper-faithful)", base)
        for tag, overrides, hypothesis in variants:
            if args.variant and args.variant != tag:
                continue
            print(f"  -- {tag}: {hypothesis[:110]}...")
            rec = run_cell(arch, shape, multi_pod=False, out_dir=OUT, overrides=dict(overrides),
                           tag=tag, verbose=False)
            show(tag, terms(rec), base)


if __name__ == "__main__":
    main()
