#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits nonzero:

0. device — the card's name and power limit; TF32 off; the CUDA kernels
   built from ``src/repro_torch/kernels/csrc`` (first use, timed);
1. kernels — each hand-written kernel (countsketch, panel_score,
   panel_update, twoside_sketch) against its plain PyTorch version on the
   card at the main path's shapes (kernel 1 also at the per-panel M fold,
   which must equal ``M.add_(apply_t(...))`` bit for bit in fp32 and bf16,
   at the selection sketches of (e) and (g), on A and on the strided view
   Aᵀ, whose view kernel must give a contiguous copy's bits, and at (e)'s
   core fold by both of its mappings), plus a ragged panel,
   an empty admission, an exhausted budget, tied scores, bf16 inputs, the
   fp32-sketch/bf16-panel pair of a bf16 Gaussian stream (kernel 3 also
   with bf16 C and M, after that pair, fp32 or bf16 sketch and panel),
   kernel 4's example and ragged shapes and the compressed train step's two
   largest launches ((y)'s embedding, 128256 x 2048, and w_up's stack, 16 x
   2048 x 8192, at s = 128, with their stream-K plans, and (tp)'s blocks
   of the embedding, w_up and w_down at model axis 2), and second
   launches of kernels 2-4 compared bitwise; CUDA-event times of the
   kernel, the plain version and one library call, beside the card's bound;
   the launch plans of kernels 2-4 against the resident slots, and every
   kernel's registers and spills from ``ptxas`` (no kernel may spill);
2. paths — streaming CUR at m = 32768, n = 65536 (fp32 on the card), panel
   L = 256, c = r = 128, Table-2 sketch sizes: (a) fixed, countsketch;
   (b) adaptive, countsketch, admission-only, chunk route; (c) adaptive,
   gaussian, admission-only (Route B: kernel 3 every panel); (d) adaptive,
   gaussian, eviction plus adaptive rows (per-panel body: kernel 2 every
   panel). Then one-shot and batched CUR: (e) ``fast_cur`` on the same
   matrix, c = r = 128, approx-leverage selection, countsketch core
   (kernel 1); (f) ``batched_fast_cur`` on 32 power-law 4096 × 4096
   matrices, c = r = 64, s_c = s_r = 960, uniform selection (kernel 4);
   (g) the same with approx-leverage selection. Launch counts are reset
   just before and read just after each run;
   Then the paper's two other applications at full width: (h) Algorithm 3,
   ``fast_sp_svd`` on the same matrix at ``sp_svd_sizes(k=64, eps=0.5)``
   (c = r = 384, c0 = r0 = 1292, s_c = s_r = 544, OSNAP p = 2, panel 512:
   kernel 1 eight times per panel), beside ``practical_sp_svd`` (Algorithm
   4) at c = r = 384, and ``svd_error_ratio`` at k = 10 of both on one
   4096 × 4096 item of (f)'s stack; on an RBF kernel over 32768 seeded
   points in 64 dimensions (16 clusters, 4 GiB), c = 128, s = 1280, panel
   256: (i) fixed streaming SPSD, CountSketch pair (Route A: kernel 1's
   chunk sketch and fold); (j) adaptive SPSD, Gaussian pair, admission
   only (Route B: kernel 3 every panel, M of 1280 × 1280); (k) batch
   Algorithm 2 (``faster_spsd``) beside Nyström, ``fast_spsd_wang`` and
   the optimal core. Launch counts are reset just before and read just
   after each run; the kernels' new launch shapes ((h)'s Ψ part and Ω
   window, kernel 3 at s = 1280) are held against their plain versions;
3. route parity — the first 8 panels of (b), (c), (d), (h), (i), (j), and
   the first 4 items of (f), with the kernels and with ``force_plain()``:
   indices equal, C (and R) bitwise, M (and U) within tolerance; (i)'s
   chunk and per-panel routes; (i)'s stream against batch ``faster_spsd``
   on the same columns and leverage sampling pair (X within 1e-4);
4. profile — ``torch.profiler`` over the whole of (a) and (h) (no sort,
   bincount or scan launched per panel), over 8 panels of (b), (c), (d),
   (j), over (i) and over run (f) and one ``faster_spsd``: device time by
   kernel and the device's idle share;
5. (l) Algorithm 1 — ``fast_gmr`` on (e)'s matrix with (e)'s C and R at
   s_c = s_r = 1920, with CountSketch (kernel 1: the chunk sketch of A and
   the view kernel) and with Gaussian sketches, each one's ``error_ratio``
   against ``exact_gmr`` (at most (e)'s core ratio plus 0.05), ρ, and the
   §6.1 CountSketch norm estimate against ``torch.linalg.norm(A)``;
6. (m) telemetry — (a)-(d), (i) and (j) again with ``telemetry=True`` and
   without, from the same seeds: factors and index sets bitwise equal,
   launch counts equal, Ψ within 1e-5 of a float64 ``A[:1024]·Ω_test``, the
   error estimate within 2× of the true error; host and device ms per panel
   on and off, and the frame's totals;
7. (n) sharding — ``simulate_sharded_stream`` at W = 4 on (a) (C and R
   bitwise, kernel 1: 4 chunk sketches and 256 folds), a telemetered (a)
   (merged frame equals the single stream's), (c) (kernel 3 on every panel,
   each worker's columns in its slot range), (d) (kernel 2 every panel, no
   duplicate row), (h) (the reconstruction within 1e-3 of single-host's)
   and (i) (X within 1e-4); kernel 3 is also held against its plain version
   at a slot offset (worker 2 of 4) in the kernels phase;
8. (o) resume — ``run_resilient_stream`` with telemetry on (a), (b), (c)
   and (i): killed at panel 150 of 256 (70 of 128 for (i)) and resumed from
   its checkpoints in a second invocation, equal bit for bit to the
   uninterrupted drive at the same cadence (chunks of 4, a checkpoint every
   2; (c) 16 and 4); bytes per checkpoint, save and restore ms, panels
   replayed, host ms per panel of the chunked drive beside the whole
   stream; (a) also at its last panel, the ``ckpt_every=8`` overhead, one
   of four workers of ``run_resilient_sharded_stream`` killed, and
   ``run_resilient_loop`` restoring onto the card after ``fail_at_step``;
9. (p) chaos — the chaos lane's seeded schedule (``tools/chaos_check.py``:
   a crash, two NaN panels, a drop, a duplicate, a straggler) over (a),
   (b), (i), equal bit for bit to a clean quarantined drive with those
   panels zeroed, the registry's counts those of the faults;
10. (q) mesh — ``mesh_sharded_stream`` in 2 and 4 gloo ranks on this one
   card, sharing A and K through CUDA IPC (one copy of each, never one per
   rank), for (a) telemetered, (c), (d) and (i), against
   ``simulate_sharded_stream`` (and (a) at W = 2 against the resilient
   sharded driver); an NCCL group of one rank runs (a) against the
   single-host stream. Checkpoints go to ``build/chip_smoke_ckpt/``
   (gitignored) and are removed;
11. (r) dense serving — llama3.2-1b at full width (16 layers, d_model 2048,
   GQA 32/8 heads of 64, d_ff 8192, vocab 128256, tied, bf16), weights
   from ``init_params`` with a seeded generator, ``generate`` over 8
   requests of 2048 seeded tokens, 64 greedy tokens (every serving phase's
   ``generate`` replays its CUDA graphs of the decode step): parameters,
   prefill, capture and decode ms (CUDA events), tokens/s, peak GiB,
   ``cache_nbytes``; one
   request's prefill logits through SDPA against the plain attention path;
   a second run's tokens equal;
12. (s) compressed serving — (r) with the reference CLI's
   ``KVCompressionConfig(rank=16, oversample=2, panel=32, decode_panel=8,
   refresh_every=32, min_rank=4)``, uniform then adaptive: conversion and
   decode ms, kernel 1's stacked launches per conversion (at 1024 heads and
   at 128: equal) and per fold, ``cache_nbytes`` against (r)'s, the
   ``serve/kv_rel_err`` histogram, each head's error over the optimal
   error at its rank (never below it), the tokens against (r), a second
   run's tokens equal; a rank-8
   head batch within the reference's 0.05, and the stacked engine against
   a per-head loop of the plain versions on 4 heads (1e-5).
   The kernels phase holds kernel 1's stacked launch (gather, transposed,
   fold, view; fp32 and bf16) against its plain version at (s)'s shapes:
   the conversion's 1024 heads and a fold's 64, at (u)'s: 64 heads of
   head_dim 128, the conversion's and a fold's, and at (x)'s conversion:
   128 heads of head_dim 128;
13. (t) MoE and MLA serving — deepseek-v2-lite's full config, nothing cut
   (27 layers, d_model 2048, MLA with kv_lora 512 and rope 64, 64 experts
   top-6 plus 2 shared, bf16; 15,706,470,400 parameters), (r)'s 8 requests
   of 2048 seeded tokens, 64 greedy tokens through ``generate`` with the
   capacity dispatch: prefill and decode ms, tokens/s, the latent cache's
   bytes, peak memory, the dropped share of prefill assignments (16 groups
   of 1024 tokens, capacity 120) and the expert loads, read by rerunning
   ``generate`` block by block (``walk_generate``: its tokens must be
   ``generate``'s) with ``route`` and ``dispatch_slots`` on each MoE
   layer's input; beside them, at the first MoE layer, an fp32 rerun and
   Gaussian router inputs (``routing_witness``); gates: (1) SDPA's
   prefill logits against the plain attention path's, which a wrong
   softmax scale (1/sqrt(128)) must fail, (2) ``moe_ffn`` at
   capacity factor E/k against ``moe_ffn_dense`` on one MoE layer over 2 x
   2048 tokens, (3) no decode assignment dropped, (4) the compressed-cache
   conversion passes every latent through, bit for bit; which SDPA
   backends take MLA's shapes (Q, K 192 wide, V 128);
14. (u) kimi-k2 at full width, depth cut to its first two layers (one
   dense, one MoE of 384 experts; 19,967,675,392 parameters), 8 requests
   of 2048 seeded tokens, 32 greedy tokens, with the dense KV cache and
   with (s)'s compressed one: prefill, conversion and decode ms, kernel
   1's stacked launches (head_dim 128), ``cache_nbytes`` against the dense
   cache, each head's error over its optimum (never below it);
15. (v) mamba2-1.3b's full config, nothing cut (48 Mamba-2 layers,
   d_model 2048, 64 heads of 64, state 128, chunk 256; 1,446,714,368
   parameters), (r)'s 8 requests of 2048 seeded tokens, 64 greedy tokens:
   prefill and decode ms, the decode state's bytes (constant in length);
   gates: (1) one full-width layer in fp32, the chunked scan against the
   token-by-token recurrence over 2048 tokens, y and the final state
   within 1e-4; (2) decode after a 2048-token prefill against the last
   logits of a 2049-token prefill, within 48 x 2^-8 (the previous
   position's logits must fail it); ``torch.profiler`` over a prefill and
   8 decode steps, as for (w) and (x);
16. (w) zamba2-1.2b's full config, nothing cut (38 layers, one shared GQA
   at six positions; 1,268,633,600 parameters), dense and with (s)'s
   compressed cache: no layer converted (the reference converts only
   ``ATTN``), kernel 1 never launched, the tokens identical; the shared
   K/V and Mamba-2 state bytes;
17. (x) llama-3.2-vision-90b at full width, depth cut to 10 (two [4 self
   + 1 cross] units, one scanned segment of 2 repeats; 10,668,384,258
   parameters, 19.9 GiB), 2048 synthetic patches of width 1280 a request,
   the cross gates set to 0.5 (0 at init adds nothing), 32 greedy tokens,
   dense and compressed: prefill, conversion and decode ms, kernel 1's
   stacked launches (4 stacks of 128 heads of head_dim 128), cache bytes;
   gates: (1) the first cross layer at gate 1 through SDPA against the
   plain einsum path (tiled kv heads must fail it; SDPA's chosen
   backend), (2) each head's error over its optimum (never below it);
18. (y) training — llama3.2-1b's full config (1,235,814,400 parameters,
   bf16) from a seeded ``init_params``, 8 steps of ``make_train_step``
   (``remat="dots"``, the reference CLI's AdamW for 8 steps) on
   ``SyntheticLM`` batches of 4 x 2048 tokens, then from the same initial
   state 8 steps of ``make_compressed_train_step`` (rank 32, factor 4,
   min_dim 512) in a world of one rank: step ms (CUDA events, the
   median of steps 2-8), tokens/s, peak GiB, every step's loss and
   grad_norm, ``comp/*`` (the ratio must be the reference's 43.160360...),
   kernel 4's launches (8 a step: 64), ``torch.profiler`` over one plain and
   one compressed step (the compression's device ms, the idle share);
   (z) the decode graphs — on (r), (s) uniform, (t), (u) compressed, (v),
   (w) and (x) compressed, at their sizes, ``generate`` replaying CUDA
   graphs against ``eager_route()`` from one seed: greedy tokens equal,
   every step's logits equal (or within ``SERVE_LOGIT_TOL``, the
   difference printed), launches equal (kernel 1's fold counted through
   the replays), two graph runs at temperature 0.8 equal (equality with
   eager printed); decode ms a token on both routes, capture ms, eager
   refresh steps, graphs and pool bytes, one profiled step of each route
   (device busy ms, idle share, host launch calls); every graph's warm-up
   step runs under ``set_sync_debug_mode("error")``; on (r) a graph whose
   replays leave the length where it was must fail the token check
   (``serve/z_decode_graph``, emitted inside each serving phase);
   gates: (1) at depth 2, the loss and every gradient through SDPA against
   the plain attention path (a wrong softmax scale must fail it), (2)
   ``remat`` None / dots / full agree (another batch's gradients must
   not), (3) every loss, grad_norm and ``comp/*`` finite, (4) a rank-8
   stacked gradient of w_up's shape reconstructs within the reference's
   0.03 (a full-rank one must not), (5) ``python -m
   repro_torch.launch.train`` at depth 2 on (y)'s batch shape, compressed,
   a crash at step 3: one restart, 6 steps; the process runs beside (hy) and
   is checked after it (``train/y_cli``). The serving phases (r)-(x) run under ``no_grad``;
19. (tp) tensor parallelism — (y)'s model cut to its first ``TP_DEPTH`` = 4
   of 16 layers (the script's time limit; each rank drawing its blocks of
   the seeded initial weights leaf by leaf) and batches in the gloo
   rank pools on this one card (their collectives staged through the
   host; NCCL cannot hold two ranks of a group on one GPU): 1x2 plain, 3
   steps; two controls, one whose ``reduce_from_tp`` backward all-reduces
   again, one whose ``cross_entropy`` leaves out the model axis's sum of
   exponentials; 1x2 compressed, 3 steps; 2x2 plain and compressed, 2 steps
   each; then the CLI (``launch.train.main``) at ``--mesh 2x2
   --grad-compress``, (y)'s gate depth and batch shape, a crash at step 3
   (one restart, the replayed step's loss equal). Gates against one rank's run of the same
   depth and kind (plain or compressed, ``train_reference``, made first in
   this process): step 1's loss (``TP_LOSS0_TOL``), every step's
   loss (``TP_LOSS_TOL``), every gradient leaf (relative Frobenius,
   ``TP_GRAD_TOL``), grad_norm (``TP_GRAD_NORM_TOL``) and step 1's update
   (``TP_UPDATE_TOL``); each control must fail them; kernel 4 8
   times a compressed step on each rank, on its block; ``comp/ratio`` the
   reference's; at 2x2 the compressed step's data-axis all-reduce bytes
   below the plain step's. Each run prints step ms (CUDA events), tokens/s,
   peak GiB a rank, all-reduce calls, bytes and ms a step by group, and the
   collectives' share of the step. Kernel 4 is held against its plain
   version at the blocks' shapes in the kernels phase;
20. (ts) serving under a mesh — run right after (s): (r)'s model cut to
   its first ``TS_DEPTH`` = 2 of 16 layers (the script's time limit; its
   seeded weights drawn whole on each rank, then cut by ``shard_params``),
   (r)'s 8 requests of 2048 seeded tokens and 64 new tokens, in the gloo
   rank pools on this one card: 2x1 dense (each rank its 4 requests, replaying
   its own CUDA graphs), 1x2 dense, compressed uniform and adaptive ((s)'s
   ``KVCompressionConfig``, kernel 1's stacked launch on each rank's 512
   heads), sampled at (z)'s temperature, and two controls (``_gqa_decode``
   without its ``reduce_from_tp``; the vocab's shards gathered in the
   wrong order), 2x2 dense and compressed uniform (256 heads a rank), then
   the serve CLI at ``--mesh 1x2 --kv-compress 16`` in the two ranks. Gates
   against one rank's dense, sampled and compressed runs of the same depth
   (``ts_references``, after (s); ``TS_REF``): (1) prefill's last
   logits and (2) each of (r)'s 63 tokens through ``decode_step``, within
   ``TS_LOGIT_TOL`` of the largest logit; (3) greedy tokens equal up to
   the first token whose one-rank logits had a top-2 margin below that;
   (4) a model-axis group's ranks return the same tokens, sampled too;
   (5) every head's error at least its optimum, each rank's adaptive
   ranks its block of one allocation over the gathered sigma; (6) 2x1 on
   the graph route, one host launch a replayed step as (r)'s graph; (7)
   each control fails gate 1 or 2; kernel 1's launches in each compressed
   ``generate`` those of (s). Each run prints prefill and decode ms a token
   (CUDA events in the rank), the all-reduces' calls, bytes and ms by axis
   (prefill and a decode step), their share, peak GiB a rank,
   ``cache_nbytes`` a rank beside (r)'s and (s)'s, and the pool job's
   seconds. The kernels phase holds kernel 1's stacked launch at the
   ranks' head counts;
21. (ep) expert parallelism and MLA heads on the model axis — run right
   after (t) and (u), in the gloo rank pools on this one card, each rank
   drawing its blocks leaf by leaf (``init_params(mesh=)``): deepseek-v2-lite's
   full config served at 1x2 and 2x2 on (r)'s requests, ``EP_DS_T`` = 8
   greedy tokens (the first of (t)'s 64: the time limit), the capacity
   dispatch and the dense latent cache; kimi-k2 at (u)'s depth
   2 at 1x2, dense and compressed ((s)'s settings, kernel 1's stacked
   launch on each rank's 32 heads); deepseek cut to ``EP_TRAIN_DEPTH`` = 3
   of 27 layers trained at 1x2 (plain 2 steps, compressed 2 with kernel 4
   on every rank's blocks) and 2x2 (plain 2) against one rank's run of the
   same depth. Gates: (1) deepseek's first MoE layer on (t)'s recorded
   inputs — routing, slots and keep bitwise at 1x2; at 2x2 choices equal
   bar near ties, slots and keep equal given (t)'s choices, the data
   ranks' drops summing to (t)'s; the MoE and MLA outputs within their
   bf16 bounds; (2) prefill's and each teacher-forced step's logits
   within ``EP_LOGIT_TOL`` of the largest with (t)'s or (u)'s expert
   choices replayed (``moe.forced_experts``: on random weights the ranks'
   own choices flip 4-26 % of the assignments, which alone breaks it), the
   ranks' own flips counted by layer and step; (3)
   tokens equal up to each request's first small margin, a model group's
   tokens equal; (4) kimi compressed: kernel 1's launches (u)'s, every
   head's error at least its optimum, ``cache_nbytes`` a rank; (5)
   training as (tp)'s gates, the ``router`` and ``w_dkv`` gradients
   printed, kernel 4 18 times a compressed step a rank, ``comp/ratio`` the
   reference's; (6) controls that must fail: at gate 1 the MoE combine
   without its ``reduce_from_tp`` and MLA without its ``reduce_from_tp``
   after ``w_o``; at gate 2 every rank on expert block 0 (deepseek, kimi)
   and kimi's combine without its sum; at gate 5 the gates without
   ``copy_to_tp`` (the router gradient). The kernels phase holds
   kernel 4 at deepseek's MLA and shared-FFN rank blocks and kernel 1 at
   kimi's rank heads;
22. (hy) Mamba-2, shared and cross attention on the model axis — after
   (y), at 1x2 in the two-rank pool, each rank drawing its blocks leaf by
   leaf: mamba2-1.3b cut to 8 of 48 layers, zamba2-1.2b to 14 of 38 (its
   shared positions 7 and 13) and the vision model to one [4 self + 1
   cross] unit of 20 (cross gates 0.5), at full width, served on
   ``HY_B`` = 4 requests of 2048 tokens (the vision model's with the
   stub's patches), ``HY_T`` = 16 greedy tokens, dense and (the vision model) with (s)'s
   compressed cache; zamba2 trained 3 plain and 3 compressed steps on
   (y)'s batches and settings. Gates against one rank's runs of the same
   models and depths, made first in this process (``HY_REF``,
   ``HY_TRAIN_REF``): (1)-(4) as (ts)'s within ``HY_LOGIT_TOL``; the
   first Mamba-2 layer's gated RMSNorm output on this rank's channels
   within ``HY_LAYER_TOL`` of one rank's; kernel 1's launches a compressed
   ``generate`` a rank those of one rank's run (each launch over the
   rank's half of the heads, (ep)'s kimi shape); (tp)'s training gates,
   every replicated leaf (Mamba-2's ``w_out``, ``w_bc``, ``w_dt``,
   ``conv_bc_*``, ``dt_bias``, ``a_log``, ``d_skip``, the norms) equal
   bit for bit on both ranks after every step, kernel 4 30 times a
   compressed step a rank, ``comp/ratio`` the reference's; the cross
   layer's output within ``HY_LAYER_TOL`` of one rank's; controls that
   must fail: Mamba-2's output unsummed over the model axis (gate 1), the
   gated norm over the rank's own channels and the cross output unsummed
   (their layer gates), the whole leaves read without ``copy_to_tp`` (the
   training gates). Each run prints prefill and decode ms a token, peak
   GiB a rank, the all-reduces' calls, bytes and ms (prefill, a decode
   step, a train step) and their share. The kernels phase holds kernel 4
   at zamba2's rank blocks and whole ``w_out``.

The mesh phases' ranks are two pools (``RankPool``) of two and four gloo
ranks on the card, started after (h) beside (m)-(p) and closed after
(tp): each phase hands them its job instead of spawning its
own. (m)'s host times take one more timed drive a side, (o)'s one (the
time limit).

The line before the last lists every kernel with its launches, error and
times; the last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the repository's ``src/repro_torch`` beside it, the script prints
no result and exits 1.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
M_ROWS, N_COLS, PANEL, C_BUDGET, R_BUDGET = 32768, 65536, 256, 128, 128
# batched CUR: a stack of B power-law matrices, c = r = 64, and the Table-2
# sketch size for c = 64 (ε = 0.05, ρ = 2): s_c = s_r = 960
BATCH, B_ROWS, B_COLS, B_BUDGET, B_SKETCH = 32, 4096, 4096, 64, 960
# (h): Algorithm 3 at sp_svd_sizes(k=64, eps=0.5), in the reference's 512-wide
# panels; svd_error_ratio at rank k = 10 on one item of the stack, at
# sp_svd_sizes(10, 0.5) (Practical SP-SVD at the same c = r)
SVD_K, SVD_EPS, SVD_PANEL, SVD_RATIO_K = 64, 0.5, 512, 10
# (i)-(k): an RBF kernel over n points in d dimensions, 16 Gaussian clusters;
# c columns and the reference's default s = 10c (the paper's §6.2 point)
SPSD_N, SPSD_D, SPSD_CLUSTERS, SPSD_C = 32768, 64, 16, 128
SPSD_S = 10 * SPSD_C
SPSD_MIN_GAIN = 0.01  # (j)'s admission threshold, in mean column energies
# (l): fast_gmr's sketch size on (e)'s matrix (Table 2 at c = r = 128) and the
# margin by which its error ratio may exceed (e)'s fast_cur core's (both are
# draws of the same sketched solve at s = 1920)
GMR_SKETCH, GMR_MARGIN = 1920, 0.05
# (m): the estimator's band (the reference's acceptance); (n): data-parallel workers.
# (m)'s host times: the larger of the bitwise run's and one more timed drive,
# on and off (cut from two rounds of four drives for the script's time limit)
EST_BAND, WORKERS = 2.0, 4
OBS_TIMED = (True, False)
SEED = 0
# fp32 sums over up to m = 32768 terms, in the kernel's fixed order against
# cuBLAS's / index_add_'s order: relative to the largest entry of the output
TOL = 1e-4
# (r), (s): llama3.2-1b at full width serving 8 requests of 2048 seeded tokens,
# 64 greedy tokens each; (s) compresses the KV caches with the reference CLI's
# settings (src/repro/launch/serve.py:42-45 at --kv-compress 16)
SERVE_ARCH, SERVE_B, SERVE_S, SERVE_T = "llama3.2-1b", 8, 2048, 64
SERVE_KC = dict(rank=16, oversample=2, panel=32, decode_panel=8, refresh_every=32, min_rank=4)
# SDPA's prefill logits against the plain attention path's, both bf16: each of
# the 16 layers rounds its attention output to bf16 (2^-8) at other places, so
# at most 16 x 2^-8 of the largest logit if the roundings added up
SERVE_LOGIT_TOL = 16 * 2.0 ** -8
# (t): deepseek-v2-lite's full config (15,706,470,400 parameters) serving (r)'s
# requests; its latent cache is 27 layers x 8 x 2112 x (512 + 64) bf16. (u):
# kimi-k2 at full width cut to its first two layers (one dense, one MoE),
# 32 greedy tokens. SDPA's MLA prefill logits against the plain path's: (r)'s
# bound scaled to 27 layers
DEEPSEEK_ARCH, DEEPSEEK_PARAMS = "deepseek-v2-lite-16b", 15_706_470_400
DEEPSEEK_LATENT_BYTES = 27 * SERVE_B * (SERVE_S + SERVE_T) * (512 + 64) * 2
DEEPSEEK_LOGIT_TOL = 27 * 2.0 ** -8
KIMI_ARCH, KIMI_DEPTH, KIMI_PARAMS, KIMI_T = "kimi-k2-1t-a32b", 2, 19_967_675_392, 32
# (v): mamba2-1.3b's full config; its decode state, constant in length: 48
# layers x 8 requests x (64 x 128 x 64 fp32 SSM state + 3 x (4096 + 256)
# bf16 conv windows). (w): zamba2-1.2b's full config; 6 shared-attention
# K/V caches of 8 x 2112 x 32 x 64 bf16, and 32 Mamba-2 states of 8 x (64 x
# 64 x 64 fp32 + 3 x (4096 + 128) bf16). (x): llama-3.2-vision-90b at full
# width, depth cut to 10 (two [4 self + 1 cross] units), 2048 patches of
# 1280 a request, 32 greedy tokens
MAMBA_ARCH, MAMBA_PARAMS = "mamba2-1.3b", 1_446_714_368
MAMBA_STATE_BYTES = 48 * SERVE_B * (64 * 128 * 64 * 4 + 3 * (4096 + 256) * 2)
ZAMBA_ARCH, ZAMBA_PARAMS = "zamba2-1.2b", 1_268_633_600
ZAMBA_KV_BYTES = 6 * 2 * SERVE_B * (SERVE_S + SERVE_T) * 32 * 64 * 2
ZAMBA_SSM_BYTES = 32 * SERVE_B * (64 * 64 * 64 * 4 + 3 * (4096 + 128) * 2)
VISION_ARCH, VISION_DEPTH, VISION_PARAMS, VISION_T = "llama-3.2-vision-90b", 10, 10_668_384_258, 32
# (z): the decode loop's CUDA graphs against the eager route on (r)-(x): the
# sampled runs' temperature, and the decode step a one-step profile reads (a
# plain replay: the plain graph is warmed up and captured at step 0)
Z_TEMPERATURE, Z_PROFILE_STEP = 0.8, 2
# (v) gate (1): the chunked scan against the token-by-token recurrence, fp32,
# one full-width layer over 2048 tokens: exp of within-chunk cumulative sums
# against products of per-step decays, relative to the largest entry (the
# same layer on the CPU at one request differs by 2.4e-6 in y, 4.5e-6 in
# the state). Gate (2): decode after a 2048-token prefill against the
# 2049-token prefill's last logits, bf16: each of the 48 layers rounds its
# output to bf16 at other places, (r)'s bound scaled to 48 layers
SCAN_TOL = 1e-4
MAMBA_LOGIT_TOL = 48 * 2.0 ** -8
# (x) gate (1): one cross layer (gate 1) through SDPA against the reference's
# einsums: both round p and the output to bf16, at other places
CROSS_TOL = 4 * 2.0 ** -8
# (y): llama3.2-1b's full config trained for 8 steps on SyntheticLM batches of
# 4 x 2048 tokens, plain and with GMR gradient compression at the reference
# CLI's rank 32, factor 4, min_dim 512 (src/repro/launch/train.py:117-119),
# the CLI's OptimizerConfig for 8 steps (warmup min(20, 8 // 10 + 1) = 1);
# the reference's compression_ratio of this tree (jax.eval_shape); its 8
# compressible leaves take one kernel-4 launch each per step
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = "llama3.2-1b", 4, 2048, 8, 3e-3
TRAIN_PARAMS, TRAIN_LEAVES, TRAIN_RATIO = 1_235_814_400, 8, 43.160360489235394
TRAIN_CCFG = dict(rank=32, sketch_factor=4, min_dim=512)
TRAIN_GATE_DEPTH = 2
# (y) gate (1): the loss and each gradient (relative Frobenius error), SDPA
# against the plain attention path, bf16: each of the 2 layers rounds its
# attention output (forward) and its q, k, v gradients (backward) to bf16
# (2^-8) at other places, at most 2 x 2 x 2^-8 if the roundings added up.
# Gate (2): remat None / "dots" / "full" rerun the same kernels on the same
# inputs; FlashAttention's backward sums dq in any order (float atomics), one
# bf16 rounding apart. Gate (4): the reference's reconstruction bound on a
# rank-8 stacked gradient (tests/test_train.py:162-171)
TRAIN_SDPA_TOL = 2 * TRAIN_GATE_DEPTH * 2.0 ** -8
TRAIN_REMAT_TOL = 2.0 ** -8
TRAIN_RECON_TOL = 0.03
# (tp): (y)'s model at TP_DEPTH, its initial state and (y)'s batches in gloo
# ranks sharing this one card: 1x2 plain, its control (reduce_from_tp's backward all-reducing again:
# a doubled gradient upstream), 1x2 compressed; 2x2 plain and compressed; then
# the CLI at --mesh 2x2 --grad-compress, (y)'s gate depth, a crash at step 3.
# Limits, each set between the sound runs' largest reading and a control's
# (H100 runs of this script at TP_DEPTH, NVIDIA H100 80GB HBM3 at 700 W, in
# PERF.md; also (ep)'s training gates). Step 1's loss: read <= 7.7e-6; the
# cross-entropy control (each rank's softmax over its half of the vocab)
# 5.8e-2; the limit is the reference's own sharded-equals-single bound
# (tests/multidev_scenario.py:47-75). Every step's loss: read <= 2.3e-3 (the
# bf16 differences of step 1's update carried on), the same control 5.8e-2.
# The worst gradient leaf (relative Frobenius): read <= 0.092 (2x2's
# embed.tok: the data-axis mean sums bf16 partial sums that cancel there),
# the doubled backward 75. grad_norm: read <= 8.5e-3, the doubled backward
# 40. Step 1's update (the parameters after it against the one-rank run's
# of the same kind, over the norm of that run's update): read <= 0.023
# plain, <= 0.157 compressed (2x2), the doubled backward 0.70. AdamW's first
# step moves each weight by about lr times its gradient's sign, so this
# error counts sign flips, and it grows as the depth falls (0.095 at 16
# layers, 0.157 at 4, 0.214 at 2 for 2x2 compressed): the tied embedding,
# where 2x2's gradient differs most, holds a larger share of the weights
# (update_by_leaf: at depth 4, embed.tok 85 % of that error at 0.213, 45 %
# of the update, no block leaf above 0.093). The cross-entropy
# control's gradients stay near the one-rank run's (at init the one-hot
# term dominates the logit gradient: 0.130, grad_norm 1.4e-4, update
# 0.105); only the loss limits catch it
TP_RUNS = {(1, 2): (("plain", 3), ("control", 1), ("control_ce", 1), ("compressed", 3)),
           (2, 2): (("plain", 2), ("compressed", 2))}
# (tp)'s depth: (y)'s model cut to its first 4 of 16 layers (the script's time
# limit), held to one rank's run of the same depth (``train_reference``); the
# reference's compression_ratio of that tree (jax.eval_shape)
TP_DEPTH, TP_RATIO = 4, 49.12487572081925
TP_LOSS0_TOL = 1e-4
TP_LOSS_TOL = 2e-2
TP_GRAD_TOL = 0.15
TP_GRAD_NORM_TOL = 2e-2
TP_UPDATE_TOL = 0.2
# the CLI's 4 steps, a checkpoint after step 2, a crash at step 3: step 2 runs
# again from the checkpoint, 5 steps in all, the replayed loss equal
TP_CLI_STEPS = 4
TP_REF = ROOT / "build" / "chip_smoke_tp_ref.pt"
# a 2x2 rank's card memory: 16.0 GiB allocated at its compressed step's peak
# (measured with the four ranks on one H100), the allocator's slack and a
# CUDA context
TP_RANK_GIB = 17.5
# (ts): (r)'s model served under a (data, model) mesh in gloo ranks sharing
# this card, its weights drawn whole from (r)'s seed on every rank and cut;
# (r)'s requests and tokens, (s)'s compression. The two-rank spawn runs 2x1
# (each rank replays its own graphs) and then 1x2; the four-rank spawn 2x2.
# The one-rank references reach the ranks through TS_REF, memory-mapped.
TS_RUNS = {2: (((2, 1), ("dense",)),
               ((1, 2), ("dense", "uniform", "adaptive", "sampled", "control_reduce",
                         "control_gather"))),
           4: (((2, 2), ("dense", "uniform")),)}
TS_REF = ROOT / "build" / "chip_smoke_ts_ref.pt"
# (ts)'s depth: (r)'s model cut to its first 2 of 16 layers (the script's time
# limit), held to one rank's runs of the same depth (``ts_references``)
TS_DEPTH = 2
TS_CLI = ["--mesh", "1x2", "--kv-compress", "16"]
TS_CONTROL_STEPS = 4
# gates 1 and 2: prefill's and each teacher-forced decode step's logits
# against one rank's, relative to the largest logit: (r)'s SDPA bound, each
# of the 16 layers rounding its two partial sums to bf16 at other places than
# one rank does. Set between the sound runs' largest reading and a
# control's (H100 runs of this script at TS_DEPTH, NVIDIA H100 80GB HBM3 at
# 700 W, in PERF.md): prefill read 0.009 (1x2, 2x2; 0 at 2x1), a decode step
# <= 0.0121; the controls 0.98 (_gqa_decode without its sum) and 1.48 (the
# vocab shards reversed). At full depth these read 0.0151, 0.0176, 1.15, 1.36
TS_LOGIT_TOL = SERVE_LOGIT_TOL
# (ep): expert parallelism and MLA heads on the model axis in gloo ranks
# sharing this card, right after (t) and (u), whose one-rank runs (tokens,
# the layer walks' logits and expert choices, margins, gate 1's layer inputs
# and outputs) reach the ranks through EP_REF, memory-mapped. The two-rank
# spawn runs 1x2: deepseek-v2-lite's full config served (capacity dispatch,
# dense cache) with its three controls, kimi-k2 at (u)'s depth 2 dense and
# compressed, then deepseek trained at EP_TRAIN_DEPTH; the four-rank spawn
# 2x2: deepseek served and trained. Each rank draws its blocks leaf by leaf
# (init_params(mesh=)): deepseek whole is 31.4 GB, kimi at depth 2 39.9 GB;
# a 2x2 rank holds 15.8 GB of deepseek's blocks, EP_RANK_GIB with its
# prefill's working set and a CUDA context
EP_REF = ROOT / "build" / "chip_smoke_ep_ref.pt"
EP_TRAIN_REF = ROOT / "build" / "chip_smoke_ep_train_ref.pt"
EP_RUNS = {2: ((1, 2), ("ds_serve", "kimi", "ds_train")), 4: ((2, 2), ("ds_serve", "ds_train"))}
EP_RANK_GIB = 16.5
# training: deepseek cut to its first 3 of 27 layers (one dense, two MoE: the
# MoE layers' expert stacks (2, 64, 2048, 1408) are 4-D, which the reference
# does not compress), (y)'s batches, optimizer and compression settings; the
# reference's compression_ratio of this tree (jax.eval_shape) and its 18
# compressible leaves (kernel 4's launches a compressed step a rank). One
# rank's run of the same depth, in this process, is the reference
EP_TRAIN_DEPTH, EP_TRAIN_PARAMS = 3, 1_670_133_760
EP_TRAIN_LEAVES, EP_TRAIN_RATIO = 18, 1.4932004489699509
EP_TRAIN_RUNS = {(1, 2): (("plain", 2), ("control_gates", 1), ("compressed", 2)),
                 (2, 2): (("plain", 2),)}
# gate 1, deepseek's first MoE layer (1) on (t)'s recorded inputs: its FFN
# ((t)'s gate-2 bound, k weighted terms and their sum rounded to bf16 at other
# places, plus the model axis's partial sums and their sum) and its MLA mixer
# (each side rounds the heads' output and w_o's partial sums to bf16)
EP_MLA_TOL = 4 * 2.0 ** -8
# gates 2 and 3: TS_LOGIT_TOL's reasoning, each layer's two sums over the
# model axis rounded to bf16 at other places than one rank's: 27 x 2^-8 for
# deepseek; kimi at depth 2 takes (ts)'s 16 x 2^-8 as a floor, since its
# readings with the one-rank expert choices replayed (0.009 prefill, 0.011 a
# step; H100 runs of this script, in PERF.md) exceed the 2 x 2^-8 its depth
# alone would give: the vocab-parallel head's bf16 products, rounded at other
# places, and the embedding weigh as much as its two layers. Each limit lies
# below its controls' readings (deepseek's 0.27-1.16)
EP_LOGIT_TOL = {DEEPSEEK_ARCH: 27 * 2.0 ** -8, KIMI_ARCH: TS_LOGIT_TOL}
# deepseek's greedy tokens at 1x2 and 2x2 (generate, and gate 2's decode steps
# fed (t)'s tokens): the first 8 of (t)'s 64, cut for the script's time
# limit (each step costs 0.33-0.50 s a rank through gloo on one card)
EP_DS_T = 8
EP_SAVE: dict = {}  # (t)'s and (u)'s one-rank records, written to EP_REF by (ep)
# (hy): Mamba-2, shared and cross attention on the model axis at 1x2 in the
# two-rank pool on this card, at full width, depth cut for the script's time
# limit: mamba2-1.3b to 8 of 48 layers, zamba2-1.2b to 14 of 38 (its first
# two shared-attention positions, 7 and 13), the vision model to one [4 self
# + 1 cross] unit of 20 (its cross gate 0.5: 0 at init adds nothing). HY_B
# requests of 2048 tokens ((r)'s 8 cut to 4 for the time limit; the vision
# model's with the stub's patches), HY_T greedy tokens, each run held to one
# rank's run of the same model and
# depth in this process (HY_REF, memory-mapped); zamba2 trained 3 plain and
# 3 compressed steps on (y)'s batches, optimizer and compression settings
# against one rank's (HY_TRAIN_REF). Its tree: the reference's
# compression_ratio (jax.eval_shape) and 30 compressible leaves (kernel 4's
# launches a compressed step a rank: 23 rank blocks, 7 whole w_out)
HY_REF = ROOT / "build" / "chip_smoke_hy_ref.pt"
HY_TRAIN_REF = ROOT / "build" / "chip_smoke_hy_train_ref.pt"
HY_DEPTH = {MAMBA_ARCH: 8, ZAMBA_ARCH: 14, VISION_ARCH: 5}
HY_SEED = {MAMBA_ARCH: SEED + 150, ZAMBA_ARCH: SEED + 153, VISION_ARCH: SEED + 156}
HY_B, HY_T = 4, 16
HY_ZAMBA_PARAMS, HY_ZAMBA_LEAVES, HY_ZAMBA_RATIO = 555_560_704, 30, 31.580188885170042
HY_TRAIN_RUNS = (("plain", 3), ("compressed", 3), ("control_whole", 1))
HY_TAG = {MAMBA_ARCH: "mamba2", ZAMBA_ARCH: "zamba2", VISION_ARCH: "vision"}
# the whole leaves of Mamba-2 and the cross layers, watched in the gradients
HY_WHOLE = ("w_out", "w_bc", "w_dt", "conv_bc_w", "conv_bc_b", "dt_bias", "a_log", "d_skip",
            "vision_proj", "gate")
# gates 1-2: (ts)'s limit, each of at most 16 layers rounding its partial
# sums over the model axis to bf16 at other places than one rank does
HY_LOGIT_TOL = TS_LOGIT_TOL
# the layer gates, over HY_LAYER_B of the requests on one rank's recorded
# inputs: mamba2's first Mamba-2 layer, its gated RMSNorm's output (bf16) on
# this rank's channels (the sum of squares summed in another order, y's
# products rounded to bf16 at other places), and the vision model's cross
# layer's output ((x)'s CROSS_TOL: p and the output rounded to bf16 at other
# places, and the partial outputs' sum), against one rank's
HY_LAYER_B, HY_LAYER_TOL = 2, 4 * 2.0 ** -8
# no head's error may fall below the optimal rank-k error (Eckart-Young), bar
# fp32 rounding of the two norms
OPT_SLACK = 1e-3
# published H100 peaks (NVIDIA data sheet, dense, at the full power limit):
# non-tensor fp32 FLOP/s and HBM bytes/s, by form factor
PEAKS = {"SXM": (67e12, 3.35e12), "PCIe": (51e12, 2.0e12)}

KERNEL_INFO = {
    "countsketch": dict(source="src/repro_torch/kernels/csrc/countsketch.cu",
                        replaces="src/repro/kernels/countsketch.py:42"),
    "panel_score": dict(source="src/repro_torch/kernels/csrc/panel_score.cu",
                        replaces="src/repro/kernels/panel_score.py:67"),
    "panel_update": dict(source="src/repro_torch/kernels/csrc/panel_update.cu",
                         replaces="src/repro/kernels/panel_update.py:143"),
    "twoside_sketch": dict(source="src/repro_torch/kernels/csrc/twoside_sketch.cu",
                           replaces="src/repro/kernels/twoside_sketch.py:46"),
    # kernel 1's stacked launch: a head batch of OSNAPs in one launch
    "countsketch_batched": dict(source="src/repro_torch/kernels/csrc/countsketch.cu",
                                replaces="src/repro/kernels/countsketch.py:42"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def fault_schedule(rng, num_panels: int) -> dict:
    """The chaos lane's seeded fault plan (``tools/chaos_check.py``): a
    crash, two NaN panels, a drop, a duplicate and a straggler at distinct
    panels drawn from one permutation."""
    panels = rng.permutation(num_panels)
    return dict(
        crash_at_panel=int(panels[0]),
        corrupt_panels=tuple(sorted(int(p) for p in panels[1:3])),
        drop_panels=(int(panels[3]),),
        duplicate_panels=(int(panels[4]),),
        straggler_panels=(int(panels[5]),),
    )


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def err(got, want) -> tuple:
    """(max abs error, max abs error / max |want|)."""
    d = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return d, d / scale if scale > 0 else d


def timed(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(torch, fn, iters: int = 20) -> tuple:
    """``(device busy ms, device ops)`` per call of ``fn`` under
    ``torch.profiler``, after two warm-up calls: the kernel time without the
    host's launch overhead, which bounds a CUDA-event time of short calls.
    Now and then a profile of calls of a few microseconds comes back with no
    device entries at all (at the vision model's rank heads, and once at
    (x)'s 128 heads): such a profile is taken again, up to twice, and a time
    of 0 fails the run."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    for _ in range(3):
        _, busy, n_ops, _ = device_profile(torch, run)
        if busy > 0:
            break
    check(busy > 0, "device_ms: three profiles saw no device time")
    return busy / iters, n_ops / iters


def card_peaks(torch) -> tuple:
    """(fp32 FLOP/s, HBM bytes/s) of the card's form factor."""
    return PEAKS["PCIe"] if "PCIe" in torch.cuda.get_device_name(0) else PEAKS["SXM"]


def bound_ms(nbytes: float, flops: float, peaks) -> tuple:
    t_ops = flops / peaks[0] * 1e3
    t_bytes = nbytes / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, ops, peaks, dev) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    m, L, s, c = M_ROWS, PANEL, 1920, C_BUDGET
    n_rot = 4  # rotate panels so each launch reads A_L from device memory, not L2
    A_buf = torch.randn((m, n_rot * L), generator=g, device=dev)
    panels = [A_buf[:, i * L : (i + 1) * L] for i in range(n_rot)]
    sc = torch.randn((s, m), generator=g, device=dev) / math.sqrt(s)
    srt_full = torch.randn((s, 4 * L), generator=g, device=dev) / math.sqrt(s)
    srt = srt_full[:, L : 2 * L].T  # a transposed window, as on the path
    Q, _ = torch.linalg.qr(torch.randn((s, c), generator=g, device=dev))
    q = (Q * (torch.arange(c, device=dev) < c // 2)).contiguous()
    h = torch.randint(0, s, (m,), generator=g, device=dev, dtype=torch.int32)
    sg = (torch.randint(0, 2, (m,), generator=g, device=dev) * 2 - 1).float()
    order = ops.bucket_order(h, s)
    out = {}

    # --- kernel 1: countsketch, per panel (w = 256) and the M-fold shape ---
    got = ops.countsketch_apply(h, sg, panels[0], s, order=order)
    with ops.force_plain():
        want = ops.countsketch_apply(h, sg, panels[0], s)
    e_abs, e_rel = err(got, want)
    check(e_rel <= TOL, f"countsketch: rel err {e_rel} > {TOL}")
    sca = torch.randn((s, L), generator=g, device=dev)
    hw, sgw = h[:L].contiguous(), sg[:L].contiguous()
    got_t = ops.countsketch_apply(hw, sgw, sca.T, s, transpose_out=True)
    with ops.force_plain():
        want_t = ops.countsketch_apply(hw, sgw, sca.T, s, transpose_out=True)
    e2 = err(got_t, want_t)
    check(e2[1] <= TOL, f"countsketch apply_t: rel err {e2[1]} > {TOL}")
    bf = panels[0].to(torch.bfloat16)
    e3 = err(ops.countsketch_apply(h, sg, bf, s, order=order), ops.ref.countsketch_ref(h, sg, bf, s))
    check(e3[1] <= TOL, f"countsketch bf16: rel err {e3[1]} > {TOL}")
    it = iter(range(10**9))
    # calls this short are bound by the host's launch rate under CUDA events,
    # so the kernels line gives kernel 1's device time per call (profiler)
    kern = lambda: ops.countsketch_apply(h, sg, panels[next(it) % n_rot], s, order=order)  # noqa: E731
    plain = lambda: ops.countsketch_apply(h, sg, panels[next(it) % n_rot], s)  # noqa: E731
    signed = [p * sg[:, None] for p in panels]
    acc = torch.zeros((s, L), device=dev)
    lib = lambda: acc.index_add_(0, h.long(), signed[next(it) % n_rot])  # noqa: E731
    k_ev, k_ms = timed(torch, kern), device_ms(torch, kern)[0]
    with ops.force_plain():
        p_ev, p_ms = timed(torch, plain), device_ms(torch, plain)[0]
    lib_ev, lib_ms = timed(torch, lib), device_ms(torch, lib)[0]
    t_ms = timed(torch, lambda: ops.countsketch_apply(hw, sgw, sca.T, s, transpose_out=True))
    # the M fold's shape: (S_R window · sc_aᵀ)ᵀ, L rows into s buckets, (s, s) out
    signed_t = sca.T * sgw[:, None]
    acc_t = torch.zeros((s, s), device=dev)
    t_lib = lambda: acc_t.index_add_(0, hw.long(), signed_t)  # noqa: E731
    t_lib_ms, t_lib_dev_ms = timed(torch, t_lib), device_ms(torch, t_lib)[0]
    t_bound = bound_ms(4 * (L * s + 2 * L + s * s), L * s, peaks)
    fold = countsketch_fold_case(torch, ops, dev, g, sca, peaks)
    sel = countsketch_selection(torch, ops, dev, g, peaks)
    b, by = bound_ms(4 * (m * L + 2 * m + s * L), m * L, peaks)
    errs = [(e_abs, e_rel), e2, fold["err"], *sel.values()]
    out["countsketch"] = dict(max_abs_err=max(e[0] for e in errs),
                              max_rel_err=max(e[1] for e in errs),
                              ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b, bound_by=by)
    emit("kernel/countsketch", shape=[s, m, L], rel_err=e_rel, rel_err_apply_t=e2[1],
         rel_err_bf16=e3[1], ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
         timing="device ms per call (torch.profiler)", events_ms=k_ev, plain_events_ms=p_ev,
         library_events_ms=lib_ev, library="index_add_ of pre-signed rows", bound_ms=b, bound_by=by,
         apply_t_ms=t_ms, apply_t_shape=[s, L, s], apply_t_library_ms=t_lib_ms,
         apply_t_library_device_ms=t_lib_dev_ms,
         apply_t_bound_ms=t_bound[0], apply_t_bound_by=t_bound[1],
         **{k: v for k, v in fold.items() if k != "err"})

    # --- kernel 2: panel_score ---
    def score_case(a_l, qq, dtype=torch.float32, sc_dtype=None):
        sc_ = sc.to(sc_dtype or dtype)
        got = ops.panel_score(sc_, a_l.to(dtype), qq)
        with ops.force_plain():
            want = ops.panel_score(sc_, a_l.to(dtype), qq)
        errs = [err(x, y) for x, y in zip(got, want)]
        return max(e[0] for e in errs), max(e[1] for e in errs), got

    cases = {
        "full": (panels[0], q),
        "ragged_L200": (panels[1][:, :200], q),
        "empty_basis": (panels[2], torch.zeros_like(q)),
    }
    ps_err = {}
    for name, (a_l, qq) in cases.items():
        ps_err[name] = score_case(a_l, qq)[:2]
        check(ps_err[name][1] <= TOL, f"panel_score {name}: rel err {ps_err[name][1]} > {TOL}")
    _, _, (_, r2e, ene) = score_case(panels[2], torch.zeros_like(q))
    check(bool(torch.equal(r2e, ene)), "panel_score: empty basis must give resid2 == energy")
    ps_err["bf16"] = score_case(panels[0], q, torch.bfloat16)[:2]
    # a bf16 Gaussian stream: the sketch is drawn in fp32, the panel is bf16
    ps_err["mixed"] = score_case(panels[0], q, torch.bfloat16, torch.float32)[:2]
    for name in ("bf16", "mixed"):
        check(ps_err[name][1] <= TOL, f"panel_score {name}: rel err {ps_err[name][1]} > {TOL}")
    first = ops.panel_score(sc, panels[0], q)
    second = ops.panel_score(sc, panels[0], q)
    mixed = (sc, panels[0].to(torch.bfloat16), q)
    bitwise = all(torch.equal(x, y) for x, y in zip(first, second)) and all(
        torch.equal(x, y) for x, y in zip(ops.panel_score(*mixed), ops.panel_score(*mixed)))
    check(bitwise, "panel_score: two launches differ")
    k_ms = timed(torch, lambda: ops.panel_score(sc, panels[next(it) % n_rot], q))
    with ops.force_plain():
        p_ms = timed(torch, lambda: ops.panel_score(sc, panels[next(it) % n_rot], q))
    lib_ms = timed(torch, lambda: torch.matmul(sc, panels[next(it) % n_rot]))
    flops = 2 * s * m * L + 2 * c * s * L + 3 * s * L
    b, by = bound_ms(4 * (s * m + m * L + s * c + s * L + 2 * L), flops, peaks)
    out["panel_score"] = dict(max_abs_err=max(e[0] for e in ps_err.values()),
                              max_rel_err=max(e[1] for e in ps_err.values()),
                              ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b, bound_by=by)
    emit("kernel/panel_score", shape=[s, m, L, c], rel_err={k: v[1] for k, v in ps_err.items()},
         bitwise_relaunch=bitwise, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
         library="torch.matmul(S_C, A_L), fp32 highest", bound_ms=b, bound_by=by,
         tflops=flops / k_ms / 1e9, library_tflops=2 * s * m * L / lib_ms / 1e9)

    # --- kernel 3: panel_update ---
    C0 = torch.randn((m, c), generator=g, device=dev) * (torch.arange(c, device=dev) < c // 2)
    M0 = torch.randn((s, s), generator=g, device=dev)
    base = dict(min_gain=0.5, run_mean=0.0, true_cols=float(L), n_filled=c // 2,
                free=c - c // 2, panel_cap=16)

    def update_case(a_l, qq, kw, dtype=torch.float32, sc_=sc, srt_=srt, C_=C0, M_=M0,
                    sc_dtype=None, acc_dtype=torch.float32):
        args = (sc_.to(sc_dtype or dtype), a_l.to(dtype), srt_.to(sc_dtype or dtype), qq)
        got = ops.panel_update(*args, C_.to(acc_dtype, copy=True), M_.to(acc_dtype, copy=True),
                               **kw)
        with ops.force_plain():
            want = ops.panel_update(*args, C_.to(acc_dtype, copy=True),
                                    M_.to(acc_dtype, copy=True), **kw)
        check(bool(torch.equal(got[5], want[5])), f"panel_update: slots differ {kw}")
        check(bool(torch.equal(got[0], want[0])), "panel_update: C differs")
        # a bf16 M is held to the fp32 outputs' tolerance only through them
        errs = [err(x, y) for x, y in zip(got[1 if acc_dtype == torch.float32 else 2:5],
                                          want[1 if acc_dtype == torch.float32 else 2:5])]
        return max(e[0] for e in errs), max(e[1] for e in errs), got, want

    pu_err, admitted = {}, {}
    for name, a_l, kw, srt_ in (
        ("full", panels[0], base, srt),
        ("ragged_L200", panels[1][:, :200], dict(base, true_cols=200.0), srt[:200]),
        ("empty_admission", panels[2], dict(base, min_gain=1e9), srt),
        ("budget_exhausted", panels[3], dict(base, n_filled=c, free=0), srt),
    ):
        e_abs, e_rel, got, _ = update_case(a_l, q, kw, srt_=srt_)
        check(e_rel <= TOL, f"panel_update {name}: rel err {e_rel} > {TOL}")
        pu_err[name] = (e_abs, e_rel)
        admitted[name] = int((got[5] < c).sum())
    check(admitted["full"] > 0 and admitted["empty_admission"] == 0
          and admitted["budget_exhausted"] == 0, f"panel_update admissions {admitted}")
    # tied scores: integer-valued operands make every sum exact in any order
    sci = torch.randint(-1, 2, (s, m), generator=g, device=dev).float()
    ai = torch.randint(-1, 2, (m, L), generator=g, device=dev).float()
    ai *= torch.rand((m, L), generator=g, device=dev) < 0.01
    ai[:, [7, 70, 170]] = 4 * ai[:, [3]]  # 16x the energy of a typical column
    e_abs, e_rel, got, _ = update_case(ai, torch.zeros_like(q), dict(base, min_gain=1.0, free=2),
                                       sc_=sci, srt_=torch.zeros_like(srt))
    r2 = got[3]
    check(bool(r2[7] == r2[70]) and bool(r2[70] == r2[170]) and bool(r2[7] == r2.max()),
          "tie case: duplicated columns must tie at the top")
    check(got[5][7].item() == c // 2 and got[5][70].item() == c // 2 + 1
          and got[5][170].item() == c, "ties must go to the lower index")
    pu_err["ties"] = (e_abs, e_rel)
    pu_err["bf16"] = update_case(panels[0], q, base, torch.bfloat16)[:2]
    # a bf16 Gaussian stream: fp32 sketch and srt, bf16 panel, C and M in
    # fp32 or, as adaptive_cur_init(dtype=bf16) holds them, in bf16
    pu_err["mixed"] = update_case(panels[0], q, base, torch.bfloat16, sc_dtype=torch.float32)[:2]
    # bf16 C and M: with the mixed pair, as adaptive_cur_init(dtype=bf16)
    # holds them for a bf16 stream; with an fp32 sketch and panel (an fp32
    # stream with bf16 state); with a bf16 sketch and panel. A bf16 M is
    # within one bf16 rounding step (2^-7) of its largest entry, since the
    # two fp32 folds may round to bf16 the other way.
    m_bf16 = (0.0, 0.0)
    for name, dtype, sc_dtype in (("mixed_bf16_acc", torch.bfloat16, torch.float32),
                                  ("fp32_bf16_acc", torch.float32, torch.float32),
                                  ("bf16_bf16_acc", torch.bfloat16, torch.bfloat16)):
        *e_acc, got, want = update_case(panels[0], q, base, dtype, sc_dtype=sc_dtype,
                                        acc_dtype=torch.bfloat16)
        pu_err[name] = tuple(e_acc)
        m_bf16 = max(m_bf16, err(got[1], want[1]), key=lambda e: e[1])
    for name in ("bf16", "mixed", "mixed_bf16_acc", "fp32_bf16_acc", "bf16_bf16_acc"):
        check(pu_err[name][1] <= TOL, f"panel_update {name}: rel err {pu_err[name][1]} > {TOL}")
    check(m_bf16[1] <= 2.0 ** -7, f"panel_update bf16 M: rel err {m_bf16[1]} > 2^-7")
    pu_err["slot_offset"] = panel_update_slot_offset(torch, ops, dev, g, sc, panels[1], srt, C0, M0)
    bf = torch.bfloat16
    bitwise = True
    for a_l, C_, M_ in ((panels[0], C0, M0), (panels[0].to(bf), C0.to(bf), M0.to(bf)),
                        (panels[0], C0.to(bf), M0.to(bf))):
        relaunch = [ops.panel_update(sc, a_l, srt, q, C_.clone(), M_.clone(), **base)
                    for _ in range(2)]
        bitwise = bitwise and all(torch.equal(x, y) for x, y in zip(*relaunch))
    check(bitwise, "panel_update: two launches differ")
    del relaunch
    Ct, Mt = C0.clone(), M0.clone()
    k_ms = timed(torch, lambda: ops.panel_update(sc, panels[next(it) % n_rot], srt, q, Ct, Mt, **base))
    with ops.force_plain():
        p_ms = timed(torch, lambda: ops.panel_update(sc, panels[next(it) % n_rot], srt, q, Ct, Mt,
                                                     **base))
    lib_ms = timed(torch, lambda: torch.matmul(sc, panels[next(it) % n_rot]))
    flops = 2 * s * m * L + 2 * c * s * L + 2 * s * L * s
    nbytes = 4 * (s * m + m * L + L * s + s * c + 2 * s * s + admitted["full"] * m + s * L + 3 * L)
    b, by = bound_ms(nbytes, flops, peaks)
    out["panel_update"] = dict(max_abs_err=max(e[0] for e in pu_err.values()),
                               max_rel_err=max(e[1] for e in pu_err.values()),
                               ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b, bound_by=by)
    emit("kernel/panel_update", shape=[s, m, L, c, s], rel_err={k: v[1] for k, v in pu_err.items()},
         rel_err_bf16_M=m_bf16[1], bitwise_relaunch=bitwise, admitted=admitted, ms=k_ms,
         plain_ms=p_ms, library_ms=lib_ms, library="torch.matmul(S_C, A_L), fp32 highest",
         bound_ms=b, bound_by=by, tflops=flops / k_ms / 1e9)
    launch_plan(torch, ops, dev, s, m, L)
    del A_buf, panels, signed
    torch.cuda.empty_cache()
    out["panel_update"]["max_abs_err"] = max(out["panel_update"]["max_abs_err"],
                                             panel_update_spsd(torch, ops, dev, g, peaks)[0])
    out["countsketch"]["max_abs_err"] = max(out["countsketch"]["max_abs_err"],
                                            countsketch_sp_svd(torch, ops, dev, g, peaks)[0])
    out["twoside_sketch"] = kernel_twoside(torch, ops, peaks, dev, g)
    blocks = kernel_twoside_compress(torch, ops, peaks, dev, g)
    out["twoside_sketch_tp"] = {k: v for k, v in blocks.items() if k.startswith("tp ")}
    out["twoside_sketch_ep"] = {k: v for k, v in blocks.items() if k.startswith("ep ")}
    out["twoside_sketch_hy"] = {k: v for k, v in blocks.items() if k.startswith("hy ")}
    out["twoside_sketch"]["max_abs_err"] = max(
        [out["twoside_sketch"]["max_abs_err"]] + [v["max_abs_err"] for v in blocks.values()])
    out["countsketch_batched"] = kernel_batched(torch, ops, dev, g, peaks)
    return out


def kernel_batched(torch, ops, dev, g, peaks) -> dict:
    """Kernel 1's stacked launches at (s)'s and (u)'s shapes, one launch per
    OSNAP apply for a whole head batch: (s)'s prefill conversion, N = 1024
    heads (16 layers x 8 requests x 8 kv-heads, one of K and V) at head_dim
    64 and panel 32, and a decode fold's N = 64 (one layer) at panel 8;
    (u)'s conversion and decode folds, N = 64 heads (8 requests x 8
    kv-heads of one layer) at head_dim 128, panel 32 and 8; (x)'s
    conversion, N = 128 heads (2 repeats x 8 requests x 8 kv-heads of one
    segment position) at head_dim 128, panel 32; (ts)'s rank blocks of
    (s)'s heads: the conversion's 512 heads at 1x2 and 256 at 2x2 (panel 32)
    and a decode fold's 32 and 16 (one layer, panel 8); (ep)'s rank blocks of
    (u)'s heads at 1x2, 32 (8 requests x 4 kv-heads of one layer) at head_dim
    128, panel 32 and 8; (hy)'s rank heads of the vision model at 1x2, 16 (4
    requests x 4 kv-heads of one layer) at head_dim 128, panel 32 and 8; the
    folds' windows from
    the prompt's end; OSNAP p = 4, s_c = s_r = 96, c0 = 64. Each held against
    its plain version (``force_plain``) with fp32 and bf16 operands: S_C on
    a panel window (gather), the Ω window on the panel's transpose
    (transposed output), the S_R fold into M, and, for the conversions, S_R
    on the column-major V_R of finalize (the view kernel).
    Times at each conversion's S_C panel shape: the kernel, the plain
    version and one ``index_add_`` over the flattened ``item·s + hash``
    buckets of pre-signed rows (the kernels line carries (s)'s; (u)'s goes
    to its own line, (x)'s to another)."""
    from repro_torch.core.sketching import StackedOSNAPSketch

    n_max, p, s, c0, r = SERVE_S + SERVE_T, 4, 96, 64, 32
    errs, shapes, out = {}, {}, {}
    for name, N, L, hd in (("conversion", 1024, SERVE_KC["panel"], 64),
                           ("decode_fold", 64, SERVE_KC["decode_panel"], 64),
                           ("conversion_hd128", SERVE_B * 8, SERVE_KC["panel"], 128),
                           ("decode_fold_hd128", SERVE_B * 8, SERVE_KC["decode_panel"], 128),
                           ("conversion_h128_hd128", 2 * SERVE_B * 8, SERVE_KC["panel"], 128),
                           ("conversion_ts_1x2", 512, SERVE_KC["panel"], 64),
                           ("decode_fold_ts_1x2", SERVE_B * 8 // 2, SERVE_KC["decode_panel"], 64),
                           ("conversion_ts_2x2", 256, SERVE_KC["panel"], 64),
                           ("decode_fold_ts_2x2", SERVE_B * 8 // 4, SERVE_KC["decode_panel"],
                            64),
                           ("conversion_ep_kimi_1x2", SERVE_B * 8 // 2, SERVE_KC["panel"], 128),
                           ("decode_fold_ep_kimi_1x2", SERVE_B * 8 // 2,
                            SERVE_KC["decode_panel"], 128),
                           ("conversion_hy_vision_1x2", HY_B * 8 // 2, SERVE_KC["panel"], 128),
                           ("decode_fold_hy_vision_1x2", HY_B * 8 // 2, SERVE_KC["decode_panel"],
                            128)):
        base = 0 if name.startswith("conversion") else SERVE_S
        S_C = StackedOSNAPSketch.draw(g, N, s, hd, p=p)
        S_R = StackedOSNAPSketch.draw(g, N, s, n_max, p=p).index_windows(L, base)
        Om = StackedOSNAPSketch.draw(g, N, c0, n_max, p=p).index_windows(L, base)
        hist = torch.randn((N, hd, n_max), generator=g, device=dev)
        off = base + 3 * L
        for dt in (torch.float32, torch.bfloat16):
            A_L = hist.to(dt)[:, :, off : off + L]
            M0 = torch.randn((N, s, s), generator=g, device=dev)
            cases = {
                "gather": lambda: S_C.apply(A_L),  # noqa: B023
                "transposed": lambda: Om.cols(off, L).apply_t(A_L),  # noqa: B023
                "fold": lambda: S_R.cols(off, L).fold_t(  # noqa: B023
                    S_C.apply(A_L).to(dt), M0.clone()),  # noqa: B023
            }
            if name.startswith("conversion"):
                V = torch.randn((N, r, n_max), generator=g, device=dev).to(dt).transpose(1, 2)
                cases["view"] = lambda: S_R.apply(V)  # noqa: B023
            for case, fn in cases.items():
                ops.reset_launches()
                got = fn()
                launched = ops.LAUNCHES["countsketch_batched"]
                check(launched == (2 if case == "fold" else 1),
                      f"countsketch batched {name}/{case}: {launched} launches")
                with ops.force_plain():
                    want = fn()
                e = err(got, want)
                check(e[1] <= TOL, f"countsketch batched {name}/{case} {dt}: rel err {e[1]}")
                errs[f"{name}/{case}/{str(dt).split('.')[-1]}"] = e
        shapes[name] = dict(items=N, parts=p, head_dim=hd, panel=L, s=s, c0=c0)
        if not name.startswith("conversion"):
            continue
        # times at the conversion's S_C panel shape, panels rotated out of L2
        n_rot = 8
        panels = [hist[:, :, i * L : (i + 1) * L] for i in range(n_rot)]
        it = iter(range(10**9))
        kern = lambda: S_C.apply(panels[next(it) % n_rot])  # noqa: E731
        idx = (S_C.hashes.long() + (torch.arange(N, device=dev) * s)[:, None, None]).reshape(-1)
        signed = [(P[:, None] * S_C.signs[..., None]).reshape(N * p * hd, L) for P in panels]
        acc = torch.zeros((N * s, L), device=dev)
        lib = lambda: acc.index_add_(0, idx, signed[next(it) % n_rot])  # noqa: E731
        k_ev, k_ms = timed(torch, kern), device_ms(torch, kern)[0]
        with ops.force_plain():
            p_ev, p_ms = timed(torch, kern), device_ms(torch, kern)[0]
        lib_ev, lib_ms = timed(torch, lib), device_ms(torch, lib)[0]
        K = N * p
        # the panel read once; each part's order (rows and offsets) and signs;
        # the output written once
        nbytes = 4 * (N * hd * L + K * hd + K * (s + 1) + K * hd + N * s * L)
        b, by = bound_ms(nbytes, K * hd * L, peaks)
        out[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b, bound_by=by)
        line = "kernel/countsketch_batched" + name[len("conversion"):]
        emit(line, shape=shapes[name], ms=k_ms, plain_ms=p_ms,
             library_ms=lib_ms, timing="device ms per call (torch.profiler)", events_ms=k_ev,
             plain_events_ms=p_ev, library_events_ms=lib_ev,
             library="one index_add_ over item*s + hash buckets of pre-signed rows",
             bound_ms=b, bound_by=by, bytes=nbytes, rel_err={k: v[1] for k, v in errs.items()})
        del panels, signed, acc
    out = dict(out["conversion"], ep={k: v for k, v in out.items() if "_ep_" in k},
               hy={k: v for k, v in out.items() if "_hy_" in k})
    out["max_abs_err"] = max(e[0] for e in errs.values())
    out["max_rel_err"] = max(e[1] for e in errs.values())
    emit("kernel/countsketch_batched_cases", shape=shapes,
         max_abs_err=out["max_abs_err"], rel_err={k: v[1] for k, v in errs.items()})
    torch.cuda.empty_cache()
    return out


def countsketch_sp_svd(torch, ops, dev, g, peaks) -> tuple:
    """Kernel 1 at (h)'s per-panel shapes, one OSNAP part each: Ψ's (1292
    buckets) on a 32768 × 512 panel window of a wider A (the gather kernel),
    and the Ω window's (1292 buckets over the panel's 512 columns) on the
    panel's transpose into the (32768, 1292) transpose (the view kernel, on
    chunk orders sliced from a parent indexed once), each against the plain
    version, in device time beside ``index_add_`` and the bound. Returns the
    largest (abs, rel) error."""
    from repro_torch.core.sketching import CountSketch, index_windows

    m, L, s = M_ROWS, SVD_PANEL, 1292
    A_wide = torch.randn((m, 4 * L), generator=g, device=dev)
    A_L = A_wide[:, L : 2 * L]
    psi = CountSketch.draw(g, s, m)
    omega = CountSketch.draw(g, s, 4 * L)
    index_windows(omega, L, chunks=True)
    W = omega.cols(L, L)
    check(ops.VIEW_CHUNK in W._windows and ops.reads_columns(A_L.T, transpose_out=True),
          "countsketch: (h)'s Omega window does not take the view kernel on its chunk orders")
    out, errs = {}, []
    for name, fn, h, sg, x in (("psi_part", lambda: psi.apply(A_L), psi.hashes, psi.signs, A_L),
                               ("omega_window_part_view", lambda: W.apply_t(A_L), W.hashes,
                                W.signs, A_L.T)):
        got = fn()
        with ops.force_plain():
            want = fn()
        e = err(got, want)
        check(e[1] <= TOL, f"countsketch {name}: rel err {e[1]} > {TOL}")
        errs.append(e)
        k_ms = device_ms(torch, fn)[0]
        with ops.force_plain():
            p_ms = device_ms(torch, fn)[0]
        signed = x * sg[:, None]
        acc = torch.zeros((s, x.shape[1]), device=dev)
        lib_ms = device_ms(torch, lambda: acc.index_add_(0, h.long(), signed))[0]
        b = bound_ms(4 * (x.numel() + s * x.shape[1] + 2 * x.shape[0]), x.numel(), peaks)
        out[name] = dict(shape=[s, x.shape[0], x.shape[1]], rel_err=e[1], ms=k_ms, plain_ms=p_ms,
                         library_ms=lib_ms, bound_ms=b[0], bound_by=b[1])
        del got, want, signed, acc
    emit("kernel/countsketch_sp_svd", timing="device ms per call (torch.profiler)",
         library="index_add_ of pre-signed rows", **out)
    del A_wide
    torch.cuda.empty_cache()
    return max(errs, key=lambda e: e[1])


def panel_update_spsd(torch, ops, dev, g, peaks) -> tuple:
    """Kernel 3 at (j)'s shape: S_1 (1280 × 32768), a 256-column panel of the
    kernel stream, the S_2 window as a transposed view, C (32768 × 128) and
    M (1280 × 1280), against the plain version (slots and C equal, the rest
    within TOL), timed beside the plain version and ``torch.matmul(S_1,
    K_L)``. Returns the largest (abs, rel) error."""
    s, m, L, c = SPSD_S, SPSD_N, PANEL, SPSD_C
    sc = torch.randn((s, m), generator=g, device=dev) / math.sqrt(s)
    srt = (torch.randn((s, 4 * L), generator=g, device=dev) / math.sqrt(s))[:, L : 2 * L].T
    a_l = torch.randn((m, 4 * L), generator=g, device=dev)[:, 2 * L : 3 * L]
    Q, _ = torch.linalg.qr(torch.randn((s, c), generator=g, device=dev))
    q = (Q * (torch.arange(c, device=dev) < c // 2)).contiguous()
    C0 = torch.randn((m, c), generator=g, device=dev) * (torch.arange(c, device=dev) < c // 2)
    M0 = torch.randn((s, s), generator=g, device=dev)
    kw = dict(min_gain=0.5, run_mean=0.0, true_cols=float(L), n_filled=c // 2, free=c - c // 2,
              panel_cap=c // 8)
    got = ops.panel_update(sc, a_l, srt, q, C0.clone(), M0.clone(), **kw)
    with ops.force_plain():
        want = ops.panel_update(sc, a_l, srt, q, C0.clone(), M0.clone(), **kw)
    check(bool(torch.equal(got[5], want[5])) and bool(torch.equal(got[0], want[0])),
          "panel_update at (j)'s shape: slots or C differ")
    e = max((err(x, y) for x, y in zip(got[1:5], want[1:5])), key=lambda e: e[1])
    check(e[1] <= TOL, f"panel_update at (j)'s shape: rel err {e[1]} > {TOL}")
    Ct, Mt = C0.clone(), M0.clone()
    k_ms = timed(torch, lambda: ops.panel_update(sc, a_l, srt, q, Ct, Mt, **kw))
    with ops.force_plain():
        p_ms = timed(torch, lambda: ops.panel_update(sc, a_l, srt, q, Ct, Mt, **kw))
    lib_ms = timed(torch, lambda: torch.matmul(sc, a_l))
    admitted = int((got[5] < c).sum())
    flops = 2 * s * m * L + 2 * c * s * L + 2 * s * L * s
    b = bound_ms(4 * (s * m + m * L + L * s + s * c + 2 * s * s + admitted * m + s * L + 3 * L),
                 flops, peaks)
    emit("kernel/panel_update_spsd", shape=[s, m, L, c, s], rel_err=e[1], admitted=admitted,
         ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, library="torch.matmul(S_1, K_L), fp32 highest",
         bound_ms=b[0], bound_by=b[1], tflops=flops / k_ms / 1e9)
    del sc, srt, a_l, C0, M0, got, want, Ct, Mt
    torch.cuda.empty_cache()
    return e


def launch_plan(torch, ops, dev, s: int, m: int, L: int) -> None:
    """The stream-K grids of kernels 2 and 3 at the path's shape against the
    card's resident slots (occupancy of the built kernels); the sketch
    product's grid must be a whole number of full waves."""
    # the module, not the function the package exports under its name
    ps = importlib.import_module("repro_torch.kernels.panel_score")
    n_sm = ps.sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    out = {}
    for name, lib, args, rows, cols, k, bn in (
            ("panel_score product", "panel_score", (0, 0), s, L, m, ps.PANEL_BN),
            ("panel_update product", "panel_update", (0, 0, 0, 0, 1), s, L, m, ps.PANEL_BN),
            ("panel_update fold", "panel_update", (1, 0, 0, 0, 1), s, s, L, ps.FOLD_BN)):
        bps = ps.blocks_per_sm(lib, *args)
        plan = ps.split_plan(rows, cols, k, n_sm, bps, bn=bn)
        slots = n_sm * bps
        out[name] = dict(blocks=plan.nblocks, resident_slots=slots, waves=plan.nblocks / slots,
                         blocks_per_sm=bps, tiles=plan.tiles, k_slabs_per_tile=plan.slabs,
                         k_slabs_per_block=plan.units / plan.nblocks)
        if "product" in name:
            check(plan.nblocks % slots == 0, f"{name}: {plan.nblocks} blocks on {slots} slots")
    # kernel 4 at (f)'s shape: whole tiles for every full wave, the rest split
    tw = importlib.import_module("repro_torch.kernels.twoside_sketch")
    bps = [ps.blocks_per_sm("twoside_sketch", stage, 0) for stage in (0, 1)]
    plans = tw.twoside_plans(BATCH, B_SKETCH, B_ROWS, B_COLS, B_SKETCH, n_sm, bps)
    for name, plan, bp in zip(("twoside_sketch S_C A_b", "twoside_sketch T_b S_R^T"), plans, bps):
        slots = n_sm * bp
        out[name] = dict(blocks=plan.nblocks, resident_slots=slots, blocks_per_sm=bp,
                         tiles=plan.tiles, whole_tiles=plan.whole,
                         whole_waves=plan.whole / slots, split_tiles=plan.tiles - plan.whole,
                         k_slabs_per_tile=plan.slabs, partial_slots=plan.partial_slots)
        check(plan.nblocks == slots, f"{name}: {plan.nblocks} blocks on {slots} slots")
    emit("kernel/launch_plan", sms=n_sm, plans=out)


def ptxas_usage(build) -> dict:
    """Registers and spill bytes of each kernel, from ``nvcc -Xptxas -v``."""
    usage, fn = {}, None
    for lib, log in build.build_log.items():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                fn = f"{lib}:{mangled.replace('13__nv_bfloat16', 'bf16')}"
                usage[fn] = {}
            elif fn and "spill stores" in line:
                nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
                usage[fn].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
            elif fn and "Used" in line and "registers" in line:
                words = line.replace(",", " ").split()
                usage[fn]["registers"] = int(words[words.index("registers") - 1])
    return usage


def countsketch_fold_case(torch, ops, dev, g, sca, peaks) -> dict:
    """Kernel 1's per-panel M fold at the path's shape: ``sca`` (s × L) into
    M (s × s) through window 100 of an S_R over n = 65536 columns whose
    256-wide windows were indexed once (as the engine does per stream). The
    fold equals ``M.add_(apply_t(sca).to(M.dtype))`` through the gather
    kernel bit for bit, for fp32 and bf16 M, and the plain fold within TOL
    (2^-7 of M's largest entry for bf16, one rounding step). Times: the
    fold with the window's precomputed order; the PR 13 path, ``apply_t``
    with its per-window sort and then the add; and the one-off indexing."""
    from repro_torch.core.sketching import CountSketch

    s, L = sca.shape
    CountSketch.draw(g, s, 4 * L).index_windows(L)  # the sort's first launches load its code
    S_R = CountSketch.draw(g, s, N_COLS)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    S_R.index_windows(L)
    t1.record()
    torch.cuda.synchronize()
    index_ms = t0.elapsed_time(t1)
    W = S_R.cols(100 * L, L)
    check(bool(W._order), "fold: the indexed window carries no order")
    h, sg, order = W.hashes, W.signs, W.order()
    bitwise, errs = {}, []
    for dt in (torch.float32, torch.bfloat16):
        M0 = torch.randn((s, s), generator=g, device=dev).to(dt)
        got = ops.countsketch_fold(h, sg, sca, M0.clone(), order=order)
        want = M0.clone().add_(ops.countsketch_apply(h, sg, sca.T, s, order=order,
                                                     transpose_out=True).to(dt))
        with ops.force_plain():
            plain = ops.countsketch_fold(h, sg, sca, M0.clone())
        name = str(dt).split(".")[-1]
        bitwise[name] = bool(torch.equal(got, want))
        check(bitwise[name], f"countsketch fold: {name} M differs from M.add_(apply_t(...))")
        e = err(got, plain)
        check(e[1] <= (TOL if dt == torch.float32 else 2.0 ** -7),
              f"countsketch fold {name}: rel err {e[1]} against the plain fold")
        if dt == torch.float32:
            errs.append(e)
    Mt = torch.zeros((s, s), device=dev)
    new_fold = lambda: ops.countsketch_fold(h, sg, sca, Mt, order=order)  # noqa: E731
    old_fold = lambda: Mt.add_(ops.countsketch_apply(h, sg, sca.T, s,  # noqa: E731
                                                     transpose_out=True))
    ms, old_ms = timed(torch, new_fold), timed(torch, old_fold)
    dev_ms, dev_ops = device_ms(torch, new_fold)
    old_dev_ms, old_dev_ops = device_ms(torch, old_fold)
    touched = int((torch.bincount(h.long(), minlength=s) > 0).sum())
    # sca read; the touched columns of M read and written; the window's order,
    # hashes and signs read
    b = bound_ms(4 * (s * L + 2 * s * touched + 3 * L + s + 1), s * L, peaks)
    return dict(err=errs[0], fold_ms=ms, fold_device_ms=dev_ms, fold_device_ops=dev_ops,
                fold_bitwise_vs_add_apply_t=bitwise, fold_old_apply_t_sort_add_ms=old_ms,
                fold_old_device_ms=old_dev_ms, fold_old_device_ops=old_dev_ops,
                fold_bound_ms=b[0], fold_bound_by=b[1], fold_touched_buckets=touched,
                index_windows_ms=index_ms)


def countsketch_selection(torch, ops, dev, g, peaks) -> dict:
    """Kernel 1 at the approx-leverage selection sketches of (e) and (g):
    ``S·A`` and ``S·Aᵀ`` (``select_rows`` hands the kernel the strided view
    ``Aᵀ`` and a row-major output) for a 32768 × 65536 matrix at s = 512, and
    for one 4096 × 4096 item of a stack at s = 256 (s = max(4k, k + 8) for
    k = c = 128 and 64), each against the plain version, beside its bound and
    one sparse product (``torch.sparse.mm`` of the sketch as a COO matrix with
    the same operand, view included)."""
    errs, ms, lib_ms, bounds, bits = {}, {}, {}, {}, {}

    def case(name, a, s):
        h = torch.randint(0, s, (a.shape[0],), generator=g, device=dev, dtype=torch.int32)
        sg = (torch.randint(0, 2, (a.shape[0],), generator=g, device=dev) * 2 - 1).float()
        kw = dict(order=ops.bucket_order(h, s), chunks=ops.window_orders(h, s, ops.VIEW_CHUNK))
        got = ops.countsketch_apply(h, sg, a, s, **kw)
        with ops.force_plain():
            want = ops.countsketch_apply(h, sg, a, s)
        errs[name] = err(got, want)
        check(errs[name][1] <= TOL, f"countsketch {name}: rel err {errs[name][1]} > {TOL}")
        if ops.reads_columns(a) and a.numel() <= 2**24:  # the view kernel: a copy's bits
            bits[name] = bool(torch.equal(got, ops.countsketch_apply(h, sg, a.contiguous(), s,
                                                                     **kw)))
            check(bits[name], f"countsketch {name}: the view differs from a contiguous copy")
        ms[name] = timed(torch, lambda: ops.countsketch_apply(h, sg, a, s, **kw),
                         iters=3, warmup=1)
        rows, cols = a.shape
        bounds[name] = bound_ms(4 * (a.numel() + s * cols) + 8 * rows, a.numel(), peaks)
        S = torch.sparse_coo_tensor(torch.stack([h.long(), torch.arange(rows, device=dev)]), sg,
                                    (s, rows)).coalesce()
        try:  # a yardstick only: the port never calls it
            lib_ms[name] = timed(torch, lambda: torch.sparse.mm(S, a), iters=3, warmup=1)
        except RuntimeError as e:  # an unsupported layout or out of memory
            lib_ms[name] = None
            emit("kernel/countsketch_selection_library", case=name, error=str(e)[:200])
        del got, want, S
        torch.cuda.empty_cache()

    A = torch.randn((M_ROWS, N_COLS), generator=g, device=dev)
    case("e_columns_A", A, 4 * C_BUDGET)
    case("e_rows_At_view", A.T, 4 * R_BUDGET)
    del A
    stack = torch.randn((2, B_ROWS, B_COLS), generator=g, device=dev)
    case("g_columns_item", stack[1], 4 * B_BUDGET)
    case("g_rows_item_t_view", stack[1].T, 4 * B_BUDGET)
    del stack
    torch.cuda.empty_cache()
    check(bits.get("g_rows_item_t_view") is True, "countsketch: (g)'s view took no view kernel")
    emit("kernel/countsketch_selection", rel_err={k: v[1] for k, v in errs.items()},
         abs_err={k: v[0] for k, v in errs.items()}, ms=ms, library_ms=lib_ms,
         library="torch.sparse.mm(S as COO, A or the view A^T)",
         bound_ms={k: v[0] for k, v in bounds.items()}, bound_by={k: v[1] for k, v in bounds.items()},
         view_bitwise_vs_contiguous_copy=bits,
         shapes={"e": [4 * C_BUDGET, M_ROWS, N_COLS], "g": [4 * B_BUDGET, B_ROWS, B_COLS]})
    errs["transposed_views"] = countsketch_transposed_views(torch, ops, dev, g, peaks)
    return errs


def countsketch_transposed_views(torch, ops, dev, g, peaks) -> tuple:
    """Kernel 1 on the transposed view of an (s × n) = 1920 × 65536 product
    into the (s, s) transpose: (e)'s core fold ``S_R.apply_t(S_C·A)``; and
    on the view of (a)'s and (e)'s 128 × 65536 R into (128, s): the
    finalize's ``S_R.apply_t(R)``. Each by both mappings (the gather kernel,
    the view kernel; the same bits), beside the plain version and
    ``index_add_``; the wrapper takes the view kernel for the first only."""
    cs = importlib.import_module("repro_torch.kernels.countsketch")
    s, errs, out = 1920, [], {}
    h = torch.randint(0, s, (N_COLS,), generator=g, device=dev, dtype=torch.int32)
    sg = (torch.randint(0, 2, (N_COLS,), generator=g, device=dev) * 2 - 1).float()
    order, chunks = ops.bucket_order(h, s), ops.window_orders(h, s, ops.VIEW_CHUNK)
    for name, rows in (("e_core_fold", s), ("finalize_R", R_BUDGET)):
        X = torch.randn((rows, N_COLS), generator=g, device=dev)
        gather, view = (torch.empty((rows, s), device=dev) for _ in range(2))
        fns = {"gather": lambda: cs.countsketch_kernel(*order, sg, X.T, gather,
                                                       out_strides=(1, s), s=s),
               "view": lambda: cs.countsketch_view_kernel(*chunks, h, sg, X.T, view,
                                                          out_strides=(1, s), s=s)}
        for fn in fns.values():
            fn()
        with ops.force_plain():
            want = ops.countsketch_apply(h, sg, X.T, s, transpose_out=True)
        e = err(view, want)
        check(e[1] <= TOL, f"countsketch {name}: rel err {e[1]} > {TOL}")
        errs.append(e)
        check(bool(torch.equal(gather, view)), f"countsketch {name}: the mappings differ")
        signed = X.T * sg[:, None]
        acc = torch.zeros((s, rows), device=dev)
        out[name] = dict(
            **{f"ms_{k}": timed(torch, fn, iters=5, warmup=1) for k, fn in fns.items()},
            library_ms=timed(torch, lambda: acc.index_add_(0, h.long(), signed), iters=5,
                             warmup=1),
            wrapper_takes_view=ops.reads_columns(X.T, transpose_out=True), rel_err=e[1],
            bound_ms=bound_ms(4 * (X.numel() + s * rows + 2 * N_COLS), X.numel(), peaks)[0])
        del X, signed, acc, gather, view, want
        torch.cuda.empty_cache()
    emit("kernel/countsketch_transposed_views", shapes={"e_core_fold": [s, N_COLS, s],
                                                        "finalize_R": [R_BUDGET, N_COLS, s]},
         library="index_add_ of pre-signed rows", bound_by="bytes", bitwise_gather_view=True,
         **out)
    return max(errs, key=lambda e: e[1])


def kernel_twoside(torch, ops, peaks, dev, g) -> dict:
    """Kernel 4 at run (f)'s shape (B = 32, 960×4096·4096×4096·4096×960),
    the example's (B = 32, 96×256·256×192·192×96), a ragged 2-D shape, bf16
    inputs, and a second launch of the first case compared bitwise."""
    def inputs(B, s_c, m, n, s_r, dtype=torch.float32):
        sc = torch.randn((s_c, m), generator=g, device=dev) / math.sqrt(s_c)
        a = torch.randn((B, m, n), generator=g, device=dev) if B else \
            torch.randn((m, n), generator=g, device=dev)
        sr = torch.randn((s_r, n), generator=g, device=dev) / math.sqrt(s_r)
        return sc.to(dtype), a.to(dtype), sr.to(dtype).T  # S_R^T as a transposed view

    def case(args):
        got = ops.twoside_sketch(*args)
        with ops.force_plain():
            want = ops.twoside_sketch(*args)
        return got, err(got, want)

    full = (BATCH, B_SKETCH, B_ROWS, B_COLS, B_SKETCH)
    errs = {}
    args = inputs(*full)
    first, errs["full"] = case(args)
    second = ops.twoside_sketch(*args)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(first, second))
    check(bitwise, "twoside_sketch: two launches differ")
    del first, second
    _, errs["example"] = case(inputs(BATCH, 96, 256, 192, 96))
    _, errs["ragged"] = case(inputs(0, 72, 300, 200, 48))
    _, errs["bf16"] = case(inputs(*full, torch.bfloat16))
    for name, (_, rel) in errs.items():
        check(rel <= TOL, f"twoside_sketch {name}: rel err {rel} > {TOL}")
    sc, a, srt = args
    k_ms = timed(torch, lambda: ops.twoside_sketch(sc, a, srt))
    with ops.force_plain():
        p_ms = timed(torch, lambda: ops.twoside_sketch(sc, a, srt))
    lib_ms = timed(torch, lambda: torch.matmul(torch.matmul(sc, a), srt))
    B, s_c, m, n, s_r = full
    flops = 2 * B * s_c * m * n + 2 * B * s_c * n * s_r
    b, by = bound_ms(4 * (B * m * n + s_c * m + n * s_r + B * s_c * s_r), flops, peaks)
    emit("kernel/twoside_sketch", shape=list(full), rel_err={k: v[1] for k, v in errs.items()},
         bitwise_relaunch=bitwise, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
         library="torch.matmul(torch.matmul(S_C, A), S_R^T) batched, fp32 highest",
         bound_ms=b, bound_by=by, tflops=flops / k_ms / 1e9)
    del args, sc, a, srt
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(e[0] for e in errs.values()),
                max_rel_err=max(e[1] for e in errs.values()),
                ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b, bound_by=by)


# kernel 4's launches in the compressed train step: (y)'s two largest leaves,
# and under (tp)'s model axis 2 each rank's block (the sketches drawn for the
# whole leaf, their columns sliced as views): leaf, B, the block's m and n,
# the whole leaf's m and n
TWOSIDE_TRAIN_SHAPES = (("embed.tok", 1, 128256, 2048, 128256, 2048),
                        ("ffn.w_up", 16, 2048, 8192, 2048, 8192),
                        ("tp embed.tok vocab block", 1, 64128, 2048, 128256, 2048),
                        ("tp ffn.w_up column block", 16, 2048, 4096, 2048, 8192),
                        ("tp ffn.w_down row block", 16, 4096, 2048, 8192, 2048),
                        ("ep mixer.w_q column block", 2, 2048, 1536, 2048, 3072),
                        ("ep mixer.w_uk column block", 2, 512, 1024, 512, 2048),
                        ("ep ffn.shared.w_up column block", 2, 2048, 1408, 2048, 2816),
                        ("ep ffn.shared.w_down row block", 2, 1408, 2048, 2816, 2048),
                        ("hy mixer.w_z column block", 2, 2048, 2048, 2048, 4096),
                        ("hy mixer.w_out whole", 2, 4096, 2048, 4096, 2048),
                        ("hy embed.lm_head vocab block", 1, 2048, 16000, 2048, 32000))


def kernel_twoside_compress(torch, ops, peaks, dev, g) -> dict:
    """Kernel 4 at the compressed train step's launches (fp32, s = 128,
    ``TWOSIDE_TRAIN_SHAPES``): (y)'s embedding gradient, one item of 128256
    x 2048, and w_up's stack, 16 items of 2048 x 8192; and (tp)'s blocks at
    model axis 2, where S_C or S_R^T is a column slice of the whole leaf's
    sketch, and (ep)'s: deepseek's MLA and shared-FFN stacks (its 2 MoE
    layers at (ep)'s training depth) at model axis 2, and (hy)'s: zamba2's
    Mamba-2 w_z column block and whole w_out (a segment's stack of 2) and
    its lm_head's vocab block at model axis 2; its stream-K plans
    there (few output tiles, deep k) against the card's slots and their
    scratch. Returns the (tp), (ep) and (hy) shapes' numbers."""
    ps = importlib.import_module("repro_torch.kernels.panel_score")
    tw = importlib.import_module("repro_torch.kernels.twoside_sketch")
    n_sm = ps.sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    bps = [ps.blocks_per_sm("twoside_sketch", stage, 0) for stage in (0, 1)]
    s = TRAIN_CCFG["rank"] * TRAIN_CCFG["sketch_factor"]
    out = {}
    for name, B, m, n, m_all, n_all in TWOSIDE_TRAIN_SHAPES:
        sc = (torch.randn((s, m_all), generator=g, device=dev) / math.sqrt(s))[:, :m]
        a = torch.randn((B, m, n), generator=g, device=dev).squeeze(0)  # 2-D when B = 1
        srt = (torch.randn((s, n_all), generator=g, device=dev) / math.sqrt(s))[:, :n].T
        got = ops.twoside_sketch(sc, a, srt)
        with ops.force_plain():
            want = ops.twoside_sketch(sc, a, srt)
        e_abs, e_rel = err(got, want)
        check(e_rel <= TOL, f"twoside_sketch at {name}: rel err {e_rel} > {TOL}")
        k_ms = timed(torch, lambda: ops.twoside_sketch(sc, a, srt))
        with ops.force_plain():
            p_ms = timed(torch, lambda: ops.twoside_sketch(sc, a, srt))
        lib_ms = timed(torch, lambda: torch.matmul(torch.matmul(sc, a), srt))
        flops = 2 * B * s * m * n + 2 * B * s * n * s
        b, by = bound_ms(4 * (B * m * n + s * m + n * s + B * s * s), flops, peaks)
        plans = {}
        for stage, plan in zip(("S_C A", "T S_R^T"), tw.twoside_plans(B, s, m, n, s, n_sm, bps)):
            plans[stage] = dict(blocks=plan.nblocks, tiles=plan.tiles, whole_tiles=plan.whole,
                                k_slabs_per_tile=plan.slabs, units=plan.units,
                                partial_slots=plan.partial_slots,
                                scratch_mib=plan.partial_slots * ps.BM * ps.PANEL_BN * 4 / 2**20)
            check(plan.nblocks <= n_sm * bps[0 if stage == "S_C A" else 1],
                  f"twoside_sketch at {name}: {plan.nblocks} blocks over the slots")
        emit("kernel/twoside_sketch_compress", leaf=name, shape=[B, s, m, n, s],
             whole_leaf=[m_all, n_all], max_abs_err=e_abs, rel_err=e_rel, ms=k_ms,
             plain_ms=p_ms, library_ms=lib_ms,
             library="torch.matmul(torch.matmul(S_C, G), S_R^T), fp32 highest", bound_ms=b,
             bound_by=by, tflops=flops / k_ms / 1e9, sms=n_sm, plans=plans)
        if name.startswith(("tp ", "ep ", "hy ")):
            out[name] = dict(max_abs_err=e_abs, rel_err=e_rel, ms=k_ms, plain_ms=p_ms,
                             library_ms=lib_ms, bound_ms=b, bound_by=by)
        del sc, a, srt, got, want
    torch.cuda.empty_cache()
    return out


def check_indices(torch, idx, hi: int, name: str) -> int:
    filled = idx[idx >= 0]
    check(int(filled.numel()) > 0, f"{name}: nothing admitted")
    check(int(filled.max()) < hi, f"{name}: index out of range")
    check(int(torch.unique(filled).numel()) == int(filled.numel()), f"{name}: duplicate indices")
    return int(filled.numel())


# (a)-(d): each run's generator seed offset (one seeded generator per run, so a
# run can be rebuilt exactly, also in another process)
PATH_RUNS = {"a_fixed_countsketch": 1, "b_adaptive_countsketch_chunk": 2,
             "c_adaptive_gaussian_route_b": 3, "d_adaptive_gaussian_evict_rows": 4}


def path_state(name: str, m: int, n: int, ci, ri, dev, tel: bool = False):
    """A fresh state of run ``name`` of (a)-(d) over an m x n stream; ``tel``:
    the same run with a telemetry frame (its Ω_test drawn after the sketches)."""
    import torch

    from repro_torch.cur import streaming_cur_init
    from repro_torch.stream.adaptive import adaptive_cur_init

    g = gen(torch, dev, SEED + 10 + PATH_RUNS[name])
    if name.startswith("a_"):
        return streaming_cur_init(g, m, n, ci, ri, sketch="countsketch", panel=PANEL,
                                  telemetry=tel, device=dev)
    if name.startswith("d_"):
        return adaptive_cur_init(g, m, n, C_BUDGET, None, r=R_BUDGET, sketch="gaussian",
                                 panel=PANEL, swap_gain=2.0, telemetry=tel, device=dev)
    return adaptive_cur_init(g, m, n, C_BUDGET, ri, panel=PANEL, telemetry=tel, device=dev,
                             sketch="countsketch" if name.startswith("b_") else "gaussian")


def phase_paths(torch, A, dev) -> tuple:
    """The four runs of the main path at full width: summed launches, the
    runs' state makers (``make(tel)``) and their relative errors."""
    from repro_torch.cur import (cur_error_ratio, cur_relative_error, select_columns,
                                 select_rows, streaming_cur_finalize)
    from repro_torch.kernels import ops
    from repro_torch.stream.adaptive import adaptive_cur_finalize
    from repro_torch.stream.engine import stream_panels

    m, n = A.shape
    g = gen(torch, dev, SEED + 10)
    ci = select_columns(g, A, C_BUDGET).idx
    ri = select_rows(g, A, R_BUDGET).idx
    runs = {name: functools.partial(path_state, name, m, n, ci, ri, dev) for name in PATH_RUNS}
    num_panels = n // PANEL  # 256 at full size
    need = {  # the kernel each run must go through, and its least launch count
        "a_fixed_countsketch": ("countsketch", num_panels),
        "b_adaptive_countsketch_chunk": ("countsketch", num_panels),
        "c_adaptive_gaussian_route_b": ("panel_update", num_panels),
        "d_adaptive_gaussian_evict_rows": ("panel_score", num_panels),
    }
    totals = {k: 0 for k in ops.LAUNCHES}
    errors = {}
    for name, make in runs.items():
        state = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        state = stream_panels(state, A, PANEL)
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        fin = streaming_cur_finalize if name.startswith("a_") else adaptive_cur_finalize
        res = fin(state)
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        for k, v in launches.items():
            totals[k] += v
        kname, count = need[name]
        if name.startswith("c_"):
            check(launches[kname] == count, f"{name}: {kname} launched {launches[kname]}, want {count}")
        else:
            check(launches[kname] >= count, f"{name}: {kname} launched {launches[kname]}, want >= {count}")
        check(all(bool(torch.isfinite(t).all()) for t in (res.C, res.U, res.R, state.M)),
              f"{name}: non-finite factors")
        n_cols = check_indices(torch, res.col_idx, n, f"{name} col_idx")
        n_rows = check_indices(torch, res.row_idx, m, f"{name} row_idx")
        rel_err = float(cur_relative_error(A, res))
        ratio = float(cur_error_ratio(A, res))
        check(math.isfinite(rel_err) and math.isfinite(ratio), f"{name}: non-finite error")
        check(rel_err < 1.0, f"{name}: relative error {rel_err} >= 1")
        errors[name] = rel_err
        emit(f"path/{name}", m=m, n=n, panel=PANEL, panels=num_panels, c=C_BUDGET, r=R_BUDGET,
             s_c=int(state.M.shape[0]), s_r=int(state.M.shape[1]), stream_s=t_stream,
             wall_s=t_total, ms_per_panel=1e3 * t_stream / num_panels, launches=launches,
             cols_admitted=n_cols, rows_filled=n_rows,
             n_evicted=int(getattr(state.ctx, "n_evicted", torch.zeros(())).item()),
             cur_relative_error=rel_err, cur_error_ratio=ratio,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        del state, res
        torch.cuda.empty_cache()
    return totals, runs, errors


def item_errors(A_b, res_b) -> tuple:
    """``(cur_relative_error, cur_error_ratio)`` of one item; the ratio is
    against ``exact_cur`` on the same indices."""
    from repro_torch.cur import cur_error_ratio, cur_relative_error

    return float(cur_relative_error(A_b, res_b)), float(cur_error_ratio(A_b, res_b))


def run_oneshot(torch, A, dev) -> tuple:
    """(e): one-shot ``fast_cur`` on the streaming runs' matrix; its launches
    and result (whose C and R run (l) reuses)."""
    from repro_torch.cur import cur_sketch_sizes, fast_cur
    from repro_torch.kernels import ops

    m, n = A.shape
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = fast_cur(g, A, C_BUDGET, R_BUDGET, policy="approx_leverage", sketch="countsketch")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # selection sketches A and A^T (2), core sketches C, R^T, A, (S_C A)^T (4)
    check(launches["countsketch"] >= 6, f"e: countsketch launched {launches['countsketch']}")
    check(bool(torch.isfinite(res.U).all()), "e: non-finite core")
    check_indices(torch, res.col_idx, n, "e col_idx")
    check_indices(torch, res.row_idx, m, "e row_idx")
    rel_err, ratio = item_errors(A, res)
    check(math.isfinite(rel_err) and math.isfinite(ratio), "e: non-finite error")
    emit("path/e_oneshot_fast_cur", m=m, n=n, c=C_BUDGET, r=R_BUDGET, policy="approx_leverage",
         sketch="countsketch", **cur_sketch_sizes(C_BUDGET, R_BUDGET), wall_s=wall,
         launches=launches,
         cur_relative_error=rel_err, cur_error_ratio=ratio, peak_mem_gib=peak,
         a_gib=A.numel() * 4 / 2**30,
         select_rows_input="A.T as a strided view read by kernel 1 (no copy of A)")
    return launches, res, ratio


def run_batched(torch, Ab, dev, name: str, selection: str) -> tuple:
    """(f)/(g): ``batched_fast_cur`` on the stack ``Ab``; per-item errors."""
    from repro_torch.cur import CURResult, batched_fast_cur
    from repro_torch.kernels import ops

    B, m, n = Ab.shape
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 30)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = batched_fast_cur(g, Ab, B_BUDGET, B_BUDGET, selection=selection)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(launches["twoside_sketch"] >= 1, f"{name}: twoside_sketch never launched")
    check(bool(torch.isfinite(res.U).all()), f"{name}: non-finite cores")
    rel, ratio = [], []
    for b in range(B):
        check_indices(torch, res.col_idx[b], n, f"{name}[{b}] col_idx")
        check_indices(torch, res.row_idx[b], m, f"{name}[{b}] row_idx")
        item = CURResult(C=res.C[b], U=res.U[b], R=res.R[b], col_idx=res.col_idx[b],
                         row_idx=res.row_idx[b])
        e = item_errors(Ab[b], item)
        check(math.isfinite(e[0]) and math.isfinite(e[1]), f"{name}[{b}]: non-finite error")
        rel.append(e[0])
        ratio.append(e[1])
    q = lambda xs: dict(p50=sorted(xs)[len(xs) // 2], max=max(xs))  # noqa: E731
    emit(f"path/{name}", B=B, m=m, n=n, c=B_BUDGET, r=B_BUDGET, s_c=B_SKETCH, s_r=B_SKETCH,
         selection=selection, wall_s=wall, launches=launches, cur_relative_error=q(rel),
         cur_error_ratio=q(ratio), peak_mem_gib=peak)
    return launches, res


def phase_batched_parity(torch, Ab, res, dev) -> None:
    """First 4 items of (f) with kernel 4 and under ``force_plain()``, on
    the same sketches and indices."""
    from repro_torch.cur import batched_fast_cur, draw_shared_sketches
    from repro_torch.kernels import ops

    B, m, n = 4, Ab.shape[1], Ab.shape[2]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 31)
    sk = draw_shared_sketches(g, m, n, B_SKETCH, B_SKETCH)
    kw = dict(sketches=sk, col_idx=res.col_idx[:B], row_idx=res.row_idx[:B])
    kern = batched_fast_cur(None, Ab[:B], B_BUDGET, B_BUDGET, **kw)
    M_k = ops.twoside_sketch(sk[0].mat, Ab[:B], sk[1].mat.T)
    with ops.force_plain():
        plain = batched_fast_cur(None, Ab[:B], B_BUDGET, B_BUDGET, **kw)
        M_p = ops.twoside_sketch(sk[0].mat, Ab[:B], sk[1].mat.T)
    torch.cuda.synchronize()
    for field in ("col_idx", "row_idx", "C", "R"):
        check(bool(torch.equal(getattr(kern, field), getattr(plain, field))),
              f"batched parity: {field} differs")
    m_rel = err(M_k, M_p)[1]
    check(m_rel <= TOL, f"batched parity: M rel err {m_rel} > {TOL}")
    u_rel = float(torch.linalg.norm(kern.U - plain.U) / torch.linalg.norm(plain.U))
    check(u_rel <= 1e-3, f"batched parity: U rel err {u_rel} > 1e-3")
    emit("parity/f_batched_uniform", items=B, indices_equal=True, C_R_bitwise=True,
         M_rel_err=m_rel, U_rel_err=u_rel, M_bitwise=bool(torch.equal(M_k, M_p)))


def phase_route_parity(torch, A, runs) -> None:
    """First 8 panels of (b), (c), (d): kernels vs ``force_plain()``."""
    from repro_torch.kernels import ops
    from repro_torch.stream.engine import stream_panels

    stop = 8 * PANEL
    for name in ("b_adaptive_countsketch_chunk", "c_adaptive_gaussian_route_b",
                 "d_adaptive_gaussian_evict_rows"):
        kern = stream_panels(runs[name](), A, PANEL, stop=stop)
        plain_state = runs[name]()
        with ops.force_plain():
            plain = stream_panels(plain_state, A, PANEL, stop=stop)
        torch.cuda.synchronize()
        for field in ("col_idx", "row_idx"):
            check(bool(torch.equal(getattr(kern.ctx, field), getattr(plain.ctx, field))),
                  f"route parity {name}: {field} differs")
        check(bool(torch.equal(kern.C, plain.C)), f"route parity {name}: C differs")
        check(bool(torch.equal(kern.R, plain.R)), f"route parity {name}: R differs")
        d = float(torch.linalg.norm(kern.M - plain.M) / torch.linalg.norm(plain.M))
        check(d <= TOL, f"route parity {name}: M rel err {d} > {TOL}")
        emit(f"parity/{name}", panels=8, cols_admitted=int((kern.ctx.col_idx >= 0).sum()),
             M_rel_err=d, C_bitwise=True, indices_equal=True)
        del kern, plain, plain_state
        torch.cuda.empty_cache()


def phase_profile(torch, A, runs) -> None:
    """``torch.profiler`` over a whole run of (a) and over panels 2–9 of (b),
    (c) and (d): device time by kernel, the device's busy share of the wall
    time, launches per panel. In (a) the sorts, bincounts and scans are
    counted: the M fold walks orders built once per stream, so there is no
    such launch per panel."""
    from repro_torch.stream.engine import stream_panels

    num_panels = N_COLS // PANEL
    state = runs["a_fixed_countsketch"]()
    torch.cuda.synchronize()
    wall_ms, busy_ms, n_ops, top, names = device_profile(
        torch, lambda: stream_panels(state, A, PANEL), names=True)
    order_ops = {k: sum(n for key, n in names.items() if k in key.lower())
                 for k in ("sort", "bincount", "scan", "searchsorted")}
    emit("profile/a_fixed_countsketch", panels=num_panels, wall_ms=wall_ms,
         device_busy_ms=busy_ms, device_idle_share=(1 - busy_ms / wall_ms) if wall_ms > 0 else None,
         device_ops_per_panel=n_ops / num_panels, order_launches=order_ops, top_device_ms=top)
    check(all(n < num_panels for n in order_ops.values()),
          f"(a) launches an order per panel: {order_ops}")
    del state
    torch.cuda.empty_cache()
    for name in ("b_adaptive_countsketch_chunk", "c_adaptive_gaussian_route_b",
                 "d_adaptive_gaussian_evict_rows"):
        state = stream_panels(runs[name](), A, PANEL, stop=2 * PANEL)
        torch.cuda.synchronize()
        # the engine's record_function span shows on the device timeline as
        # an annotation covering the kernels: device_profile leaves it out
        wall_ms, busy_ms, n_ops, top = device_profile(
            torch, lambda: stream_panels(state, A, PANEL, stop=10 * PANEL))
        emit(f"profile/{name}", panels=8, wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_idle_share=(1 - busy_ms / wall_ms) if wall_ms > 0 else None,
             device_ops_per_panel=n_ops / 8, top_device_ms=top)
        del state
        torch.cuda.empty_cache()


def device_profile(torch, fn, names: bool = False) -> tuple:
    """``(wall ms, device busy ms, device ops, top 10 [name, ms, count])`` of
    one synchronised call of ``fn`` under ``torch.profiler``: device-side
    entries only (the host ops that launch them report the same time again);
    with ``names``, also every device entry's launch count by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_us = [(e.key, getattr(e, "self_device_time_total", 0.0), e.count)
              for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not e.key.startswith("stream/")]
    dev_us = [x for x in dev_us if x[1] > 0]
    top = sorted(dev_us, key=lambda x: -x[1])[:10]
    out = (wall_ms, sum(x[1] for x in dev_us) / 1e3, sum(x[2] for x in dev_us),
           [[k[:60], us / 1e3, n] for k, us, n in top])
    return out + ({k: n for k, _, n in dev_us},) if names else out


def phase_profile_batched(torch, Ab, dev) -> None:
    """``torch.profiler`` over one run of (f): where its time goes."""
    from repro_torch.cur import batched_fast_cur

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 30)
    wall_ms, busy_ms, n_ops, top = device_profile(
        torch, lambda: batched_fast_cur(g, Ab, B_BUDGET, B_BUDGET))
    emit("profile/f_batched_uniform", wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=(1 - busy_ms / wall_ms) if wall_ms > 0 else None,
         device_ops=n_ops, top_device_ms=top)


def gen(torch, dev, seed: int):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def orth_err(torch, U) -> float:
    """``‖UᵀU − I‖₂`` in fp64."""
    G = U.double().T @ U.double()
    return float(torch.linalg.matrix_norm(G - torch.eye(G.shape[0], dtype=G.dtype,
                                                        device=G.device), ord=2))


def order_launches(names: dict) -> dict:
    """Device launches of the order-building ops (sorts, bincounts, scans,
    searchsorted), by kind, from a profile's launch counts by name."""
    return {k: sum(n for key, n in names.items() if k in key.lower())
            for k in ("sort", "bincount", "scan", "searchsorted")}


def run_sp_svd(torch, A, dev) -> dict:
    """(h): Algorithm 3 over the streaming runs' matrix, beside Algorithm 4;
    errors in column blocks, orthonormality, kernels vs ``force_plain()`` on
    the first 8 panels, and a profile of the whole stream."""
    from repro_torch.core.gmr import residual_norm
    from repro_torch.core.svd import practical_sp_svd, sp_svd_finalize, sp_svd_init, sp_svd_sizes
    from repro_torch.kernels import ops
    from repro_torch.stream.engine import stream_panels

    m, n = A.shape
    sizes = sp_svd_sizes(SVD_K, SVD_EPS)
    num_panels = n // SVD_PANEL
    init = lambda: sp_svd_init(gen(torch, dev, SEED + 40), m, n, sizes=sizes,  # noqa: E731
                               panel=SVD_PANEL, device=dev)
    state = init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state = stream_panels(state, A, SVD_PANEL)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    U, S, V = sp_svd_finalize(state)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # Ψ, S_C and the Ω window on the panel, the S_R window fold: 2 parts each
    check(launches["countsketch"] >= 6 * num_panels,
          f"h: countsketch launched {launches['countsketch']}, want >= {6 * num_panels}")
    check(all(bool(torch.isfinite(t).all()) for t in (state.C, state.R, state.M, U, S, V)),
          "h: non-finite factors")
    a_norm = torch.linalg.norm(A)
    rel = float(residual_norm(A, U, torch.diag(S), V.T) / a_norm)
    orth = (orth_err(torch, U), orth_err(torch, V))
    check(max(orth) < 1e-3, f"h: U, V not orthonormal: {orth}")
    check(math.isfinite(rel) and rel < 1.0, f"h: relative error {rel}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Up, Sp, Vp = practical_sp_svd(gen(torch, dev, SEED + 41), A, c=sizes["c"], r=sizes["r"])
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    rel_p = float(residual_norm(A, Up, torch.diag(Sp), Vp.T) / a_norm)
    orth_p = (orth_err(torch, Up), orth_err(torch, Vp))
    check(math.isfinite(rel_p) and max(orth_p) < 1e-3, f"h: practical SP-SVD {rel_p}, {orth_p}")
    emit("path/h_fast_sp_svd", m=m, n=n, panel=SVD_PANEL, panels=num_panels, osnap_p=2,
         **sizes, stream_s=t_stream, wall_s=t_total, ms_per_panel=1e3 * t_stream / num_panels,
         launches=launches, relative_error=rel, orthonormality_U_V=orth, sigma_1=float(S[0]),
         practical_sp_svd=dict(c=sizes["c"], r=sizes["r"], sketch="gaussian", wall_s=wall_p,
                               relative_error=rel_p, orthonormality_U_V=orth_p),
         error="||A - U diag(S) V^T||_F / ||A||_F in 4096-column blocks", peak_mem_gib=peak)
    del U, S, V, Up, Sp, Vp, state
    torch.cuda.empty_cache()

    stop = 8 * SVD_PANEL
    kern = stream_panels(init(), A, SVD_PANEL, stop=stop)
    with ops.force_plain():
        plain = stream_panels(init(), A, SVD_PANEL, stop=stop)
    torch.cuda.synchronize()
    errs = {k: err(getattr(kern, k), getattr(plain, k))[1] for k in ("C", "R", "M")}
    check(all(e <= TOL for e in errs.values()), f"parity h: {errs} > {TOL}")
    emit("parity/h_fast_sp_svd", panels=8, rel_err=errs)
    del kern, plain

    state = init()
    torch.cuda.synchronize()
    wall_ms, busy_ms, n_ops, top, names = device_profile(
        torch, lambda: stream_panels(state, A, SVD_PANEL), names=True)
    orders = order_launches(names)
    emit("profile/h_fast_sp_svd", panels=num_panels, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=(1 - busy_ms / wall_ms) if wall_ms > 0 else None,
         device_ops_per_panel=n_ops / num_panels, device_ms_per_panel=busy_ms / num_panels,
         order_launches=orders, top_device_ms=top)
    check(all(k < num_panels for k in orders.values()),
          f"(h) launches an order per panel: {orders}")
    del state
    torch.cuda.empty_cache()
    return launches


def run_sp_svd_item(torch, A_b, dev) -> dict:
    """(h), second part: ``svd_error_ratio`` at rank 10 of Algorithm 3 (at
    ``sp_svd_sizes(10, 0.5)``) and of Algorithm 4 (same c = r) on one
    4096 × 4096 power-law item, where the exact SVD is affordable."""
    from repro_torch.core.svd import fast_sp_svd, practical_sp_svd, sp_svd_sizes, svd_error_ratio
    from repro_torch.kernels import ops

    sizes = sp_svd_sizes(SVD_RATIO_K, SVD_EPS)
    ops.reset_launches()
    fast = fast_sp_svd(gen(torch, dev, SEED + 42), A_b, sizes=sizes, panel=SVD_PANEL)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    prac = practical_sp_svd(gen(torch, dev, SEED + 43), A_b, c=sizes["c"], r=sizes["r"])
    ratios = [float(svd_error_ratio(A_b, *out, SVD_RATIO_K)) for out in (fast, prac)]
    check(all(math.isfinite(r) for r in ratios), f"h item: non-finite error ratios {ratios}")
    emit("path/h_svd_error_ratio_item", shape=list(A_b.shape), k=SVD_RATIO_K, **sizes,
         launches=launches, fast_sp_svd=ratios[0], practical_sp_svd=ratios[1],
         metric="||A - U S V^T||_F / ||A - A_k||_F - 1")
    return launches


def spsd_points(torch, dev):
    """32768 points in 64 dimensions around 16 seeded Gaussian centres (3× the
    spread between centres as within), and σ = 1 / (median squared distance
    of 4096 seeded pairs)."""
    g = gen(torch, dev, SEED + 50)
    centers = 3.0 * torch.randn((SPSD_CLUSTERS, SPSD_D), generator=g, device=dev)
    assign = torch.randint(0, SPSD_CLUSTERS, (SPSD_N,), generator=g, device=dev)
    X = centers[assign] + torch.randn((SPSD_N, SPSD_D), generator=g, device=dev)
    i, j = (torch.randint(0, SPSD_N, (4096,), generator=g, device=dev) for _ in range(2))
    sigma = 1.0 / float(torch.median(((X[i] - X[j]) ** 2).sum(1)))
    return X, sigma


def spsd_data(torch, dev) -> tuple:
    """(i)-(k)'s RBF kernel: its points, σ, the kernel K on the card and
    (i)'s columns."""
    from repro_torch.spsd import rbf_kernel_oracle

    t0 = time.perf_counter()
    X, sigma = spsd_points(torch, dev)
    K = rbf_kernel_oracle(X, sigma)(None, None)
    torch.cuda.synchronize()
    emit("data", generator="rbf_kernel_oracle over clustered points", shape=[SPSD_N, SPSD_N],
         d=SPSD_D, clusters=SPSD_CLUSTERS, sigma=sigma, dtype="float32",
         gib=K.numel() * 4 / 2**30, seconds=time.perf_counter() - t0)
    ci = torch.randperm(SPSD_N, generator=gen(torch, dev, SEED + 51), device=dev)[:SPSD_C]
    return X, sigma, K, ci


def spsd_state(ci, dev, tel: bool = False):
    """A fresh state of (i): fixed streaming SPSD over the kernel's columns
    ``ci``, CountSketch pair (``tel``: with a telemetry frame)."""
    import torch

    from repro_torch.spsd import streaming_spsd_init

    return streaming_spsd_init(gen(torch, dev, SEED + 52), SPSD_N, ci, s=SPSD_S, panel=PANEL,
                               telemetry=tel, device=dev)


def spsd_checks(torch, name: str, K, res) -> dict:
    """Finite factors, a PSD X (smallest eigenvalue above −1e-5 of the
    largest) and the §6.2 error, for one SPSD result."""
    from repro_torch.spsd import spsd_error_ratio

    check(bool(torch.isfinite(res.C).all()) and bool(torch.isfinite(res.X).all()),
          f"{name}: non-finite factors")
    ev = torch.linalg.eigvalsh(0.5 * (res.X + res.X.T).double())
    lo, hi = float(ev.min()), float(ev.max())
    e = float(spsd_error_ratio(K, res))
    check(math.isfinite(e), f"{name}: non-finite error")
    return dict(spsd_error_ratio=e, x_eig_min=lo, x_eig_max=hi, psd=lo >= -1e-5 * max(hi, 0.0))


def run_spsd(torch, dev) -> list:
    """(i)-(k) on one RBF kernel, with (i)'s and (j)'s parity and profiles
    and (i)'s stream against batch Algorithm 2."""
    from repro_torch.kernels import ops
    from repro_torch.spsd import (adaptive_spsd_finalize, adaptive_spsd_init, fast_spsd_wang,
                                  faster_spsd, leverage_sampling_sketches, matrix_oracle, nystrom,
                                  optimal_core, rbf_kernel_oracle, streaming_spsd_finalize,
                                  streaming_spsd_init)
    from repro_torch.stream.engine import stream_panels

    n, c, s = SPSD_N, SPSD_C, SPSD_S
    num_panels = n // PANEL
    X, sigma, K, ci = spsd_data(torch, dev)
    runs = {
        "i_streaming_spsd": (functools.partial(spsd_state, ci, dev), streaming_spsd_finalize,
                             ("countsketch", num_panels)),
        # an RBF kernel's columns share most of their energy, so residuals
        # are small against the mean column energy: the default min_gain = 2
        # admits nothing here and 0.5 stops at the first panel's 16 columns
        "j_adaptive_spsd_route_b": (lambda tel=False: adaptive_spsd_init(
            gen(torch, dev, SEED + 53), n, c, s=s, sketch="gaussian", min_gain=SPSD_MIN_GAIN,
            panel=PANEL, telemetry=tel, device=dev), adaptive_spsd_finalize,
            ("panel_update", num_panels)),
    }
    all_launches, results = [], {}
    for name, (make, fin, (kname, count)) in runs.items():
        state = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        state = stream_panels(state, K, PANEL)
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        res = fin(state)
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        all_launches.append(launches)
        want = f"{count}" if name.startswith("j_") else f">= {count}"
        check(launches[kname] == count if name.startswith("j_") else launches[kname] >= count,
              f"{name}: {kname} launched {launches[kname]}, want {want}")
        check(state.R.shape == (0, n) and bool(torch.isfinite(state.M).all()),
              f"{name}: R placeholder or M")
        q = spsd_checks(torch, name, K, res)
        check(q["psd"], f"{name}: X not PSD ({q['x_eig_min']} against {q['x_eig_max']})")
        n_cols = check_indices(torch, res.col_idx, n, f"{name} col_idx")
        emit(f"path/{name}", n=n, panel=PANEL, panels=num_panels, c=c, s=s,
             sketch="countsketch" if name.startswith("i_") else "gaussian",
             min_gain=None if name.startswith("i_") else SPSD_MIN_GAIN,
             stream_s=t_stream, wall_s=t_total, ms_per_panel=1e3 * t_stream / num_panels,
             launches=launches, cols_filled=n_cols, M_shape=list(state.M.shape), **q,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        results[name] = res
        del state
        torch.cuda.empty_cache()

    # (i): the chunk route against the per-panel route, whole stream
    make = runs["i_streaming_spsd"][0]
    chunk, per_panel = stream_panels(make(), K, PANEL), stream_panels(make(), K, PANEL,
                                                                      route="per-panel")
    torch.cuda.synchronize()
    check(bool(torch.equal(chunk.C, per_panel.C)), "parity i: C differs between routes")
    m_rel = err(chunk.M, per_panel.M)[1]
    check(m_rel <= TOL, f"parity i: M rel err {m_rel} > {TOL} between routes")
    emit("parity/i_streaming_spsd_routes", panels=num_panels, C_bitwise=True, M_rel_err=m_rel,
         M_bitwise=bool(torch.equal(chunk.M, per_panel.M)))
    del chunk, per_panel
    # (i), (j): kernels against force_plain() on the first 8 panels
    for name, (make, _, _) in runs.items():
        kern = stream_panels(make(), K, PANEL, stop=8 * PANEL)
        with ops.force_plain():
            plain = stream_panels(make(), K, PANEL, stop=8 * PANEL)
        torch.cuda.synchronize()
        idx = getattr(kern.ctx, "col_idx")
        check(bool(torch.equal(idx, plain.ctx.col_idx)), f"parity {name}: col_idx differs")
        check(bool(torch.equal(kern.C, plain.C)), f"parity {name}: C differs")
        m_rel = err(kern.M, plain.M)[1]
        check(m_rel <= TOL, f"parity {name}: M rel err {m_rel} > {TOL}")
        emit(f"parity/{name}", panels=8, cols_filled=int((idx >= 0).sum()), C_bitwise=True,
             indices_equal=True, M_rel_err=m_rel)
        del kern, plain
    torch.cuda.empty_cache()

    # profiles: the whole of (i); panels 2-9 of (j)
    state = runs["i_streaming_spsd"][0]()
    torch.cuda.synchronize()
    wall_ms, busy_ms, n_ops, top, names = device_profile(
        torch, lambda: stream_panels(state, K, PANEL), names=True)
    emit("profile/i_streaming_spsd", panels=num_panels, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=(1 - busy_ms / wall_ms) if wall_ms > 0 else None,
         device_ops_per_panel=n_ops / num_panels, order_launches=order_launches(names),
         top_device_ms=top)
    state = stream_panels(runs["j_adaptive_spsd_route_b"][0](), K, PANEL, stop=2 * PANEL)
    torch.cuda.synchronize()
    wall_ms, busy_ms, n_ops, top = device_profile(
        torch, lambda: stream_panels(state, K, PANEL, stop=10 * PANEL))
    emit("profile/j_adaptive_spsd_route_b", panels=8, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=(1 - busy_ms / wall_ms) if wall_ms > 0 else None,
         device_ops_per_panel=n_ops / 8, top_device_ms=top)
    del state
    torch.cuda.empty_cache()

    # (m): (i) and (j) with telemetry on and off; (n): (i) sharded
    from repro_torch.core.gmr import residual_norm

    k_norm = float(torch.linalg.norm(K))
    for name in runs:
        make, fin, _ = runs[name]
        all_launches.append(telemetry_run(
            torch, ops, name, make, K, PANEL, fin, ("C", "M", "col_idx"),
            lambda res: float(residual_norm(K, res.C, res.X, res.C.T)) / k_norm,
            window=name.startswith("j_")))
    all_launches.append(shard_spsd(torch, ops, runs["i_streaming_spsd"], K))

    # (k): batch Algorithm 2 through the oracle, beside the baselines
    oracle = rbf_kernel_oracle(X, sigma)
    batch = {}
    for name, fn in (("faster_spsd", lambda g: faster_spsd(g, oracle, n, c, s)),
                     ("nystrom", lambda g: nystrom(g, oracle, n, c)),
                     ("fast_spsd_wang", lambda g: fast_spsd_wang(g, oracle, n, c, s)),
                     ("optimal_core", lambda g: optimal_core(g, oracle, n, c))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = fn(gen(torch, dev, SEED + 60))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)  # the oracle-bound paths sample rows: no kernel
        all_launches.append(launches)
        q = spsd_checks(torch, f"k {name}", K, res)
        check(q["psd"] or name == "nystrom",
              f"k {name}: X not PSD ({q['x_eig_min']} against {q['x_eig_max']})")
        check_indices(torch, res.col_idx, n, f"k {name} col_idx")
        batch[name] = dict(wall_s=wall, launches=launches, entries_observed=res.entries_observed,
                           **q, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        del res
        torch.cuda.empty_cache()
    check(batch["faster_spsd"]["entries_observed"] == n * c + s * s,
          "k: faster_spsd must observe n*c + s^2 entries")
    emit("path/k_batch_spsd", n=n, c=c, s=s, oracle="rbf_kernel_oracle", **batch)
    g = gen(torch, dev, SEED + 61)
    wall_ms, busy_ms, n_ops, top = device_profile(torch, lambda: faster_spsd(g, oracle, n, c, s))
    emit("profile/k_faster_spsd", wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=(1 - busy_ms / wall_ms) if wall_ms > 0 else None, device_ops=n_ops,
         top_device_ms=top)

    # streaming <-> batch: (i)'s columns and one leverage sampling pair, the
    # reference's contract (entries read from the same K)
    pair = leverage_sampling_sketches(gen(torch, dev, SEED + 62), K[:, ci.long()], s)
    res_b = faster_spsd(None, matrix_oracle(K), n, c, s, col_idx=ci, sketches=pair)
    st = streaming_spsd_init(None, n, ci, sketches=pair, panel=PANEL, device=dev)
    res_s = streaming_spsd_finalize(stream_panels(st, K, PANEL))
    torch.cuda.synchronize()
    check(bool(torch.equal(res_s.C, res_b.C)), "parity i/k: C differs")
    x_err = err(res_s.X, res_b.X)
    check(x_err[1] <= 1e-4, f"parity i/k: streamed X off batch X by {x_err[1]} of its largest")
    emit("parity/i_stream_vs_k_batch", c=c, s=s, sketches="leverage sampling pair",
         X_max_abs_err=x_err[0], X_rel_err=x_err[1],
         spsd_error_ratio=[spsd_checks(torch, "i/k", K, r)["spsd_error_ratio"]
                           for r in (res_s, res_b)])
    del K, X, res_b, res_s, st, results
    torch.cuda.empty_cache()
    return all_launches


def run_gmr(torch, A, res_e, ratio_e, dev) -> dict:
    """(l): Algorithm 1 on (e)'s matrix with (e)'s C and R: ``fast_gmr`` with
    CountSketch (kernel 1's chunk sketch of A and view kernel) and with
    Gaussian sketches at s_c = s_r = 1920, each one's ``error_ratio``
    against ``exact_gmr`` (at most (e)'s core ratio plus ``GMR_MARGIN``),
    ρ, and the §6.1 norm estimator against ``torch.linalg.norm(A)``."""
    from repro_torch.core import error_ratio, fast_gmr, rho, sketched_fro_norm
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    C, R = res_e.C, res_e.R
    out, launches = {}, {k: 0 for k in ops.LAUNCHES}
    for kind in ("countsketch", "gaussian"):
        g = gen(torch, dev, SEED + 70)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        X = fast_gmr(g, A, C, R, GMR_SKETCH, GMR_SKETCH, sketch_c=kind)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        check(bool(torch.isfinite(X).all()), f"l {kind}: non-finite X")
        ratio = float(error_ratio(A, C, X, R))
        check(math.isfinite(ratio) and ratio <= ratio_e + GMR_MARGIN,
              f"l {kind}: error ratio {ratio} above (e)'s {ratio_e} + {GMR_MARGIN}")
        out[kind] = dict(wall_s=wall, launches=dict(ops.LAUNCHES), error_ratio=ratio)
    check(out["countsketch"]["launches"]["countsketch"] >= 4,
          "l: fast_gmr with CountSketch did not launch kernel 1")
    t0 = time.perf_counter()
    r = float(rho(A, C, R))
    torch.cuda.synchronize()
    rho_s = time.perf_counter() - t0
    check(math.isfinite(r) and r > 0, f"l: rho {r}")
    ops.reset_launches()
    est = float(sketched_fro_norm(gen(torch, dev, SEED + 71), A, GMR_SKETCH, GMR_SKETCH))
    for k, v in ops.LAUNCHES.items():
        launches[k] += v
    true = float(torch.linalg.norm(A))
    check(abs(est - true) <= 0.15 * true, f"l: sketched norm {est} against {true}")
    emit("path/l_fast_gmr", m=A.shape[0], n=A.shape[1], c=C.shape[1], r=R.shape[0],
         s_c=GMR_SKETCH, s_r=GMR_SKETCH, **out, fast_cur_core_error_ratio=ratio_e,
         margin=GMR_MARGIN, rho=r, rho_s=rho_s, sketched_fro_norm=est, fro_norm=true,
         sketched_fro_norm_rel_err=abs(est - true) / true,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, seconds=time.perf_counter() - t_phase)
    return launches


def _stream(torch, ops, make, data, panel, **kw):
    """One stream of a fresh state: (state, launches, host seconds)."""
    from repro_torch.stream.engine import stream_panels

    state = make()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    state = stream_panels(state, data, panel, **kw)
    torch.cuda.synchronize()
    return state, dict(ops.LAUNCHES), time.perf_counter() - t0


class _Factors:
    """The named accumulators and index sets of a state (its ``ctx`` for the
    ``*_idx`` ones), without the rest of it."""

    def __init__(self, state, fields):
        self.ctx = self
        for f in fields:
            setattr(self, f, getattr(state.ctx, f) if f.endswith("_idx") else getattr(state, f))


def _same_bits(torch, a, b, fields, name: str) -> None:
    for f in fields:
        x = getattr(a.ctx, f) if f.endswith("_idx") else getattr(a, f)
        y = getattr(b.ctx, f) if f.endswith("_idx") else getattr(b, f)
        check(bool(torch.equal(x, y)), f"{name}: {f} differs")


def _tel_digest(tel) -> dict:
    """Totals of a telemetry summary (the per-panel arrays stay on the card)."""
    from repro_torch.obs import telemetry_summary

    s = telemetry_summary(tel)
    kinds = {}
    for ev in s["events"]:
        for e in ev:
            kinds[e] = kinds.get(e, 0) + 1
    return dict(panels_seen=s["panels_seen"], total_admitted=s["total_admitted"],
                total_evicted=s["total_evicted"], total_rows_admitted=s["total_rows_admitted"],
                energy_mass=s["energy_mass"], final_occupancy=int(s["occupancy"][-1]),
                panels_with_event=kinds,
                score_p50_median=float(sorted(s["score_q"][:, 2])[len(s["score_q"]) // 2]))


def telemetry_run(torch, ops, name, make, data, panel, fin, fields, true_error,
                  window: bool) -> dict:
    """A run with telemetry off and on, from the same generator seeds:
    the factors and index sets bitwise equal, the same launches, Ψ within
    1e-5 (relative) of a float64 ``data[:1024]·Ω_test``, the estimate within
    ``EST_BAND``× of ``true_error(result)``; host ms per panel on and off
    over the whole stream (the median of five runs each, taken in turns:
    off, on, on, off, off, on, ...), device ms per panel from ``torch.profiler`` over
    the whole stream or, with ``window`` (the adaptive runs, 84-200 device
    ops per panel), over panels 2-9 with Ψ folded over those 8. Returns the
    two runs' summed launches."""
    from repro_torch.obs import estimate_rel_error
    from repro_torch.obs.telemetry import fold_psi_chunk
    from repro_torch.stream.engine import stream_panels

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    off, l_off, t_off = _stream(torch, ops, lambda: make(False), data, panel)
    # keep the factors and index sets only, so one stream's state is alive at a time
    off = _Factors(off, fields)
    on, l_on, t_on = _stream(torch, ops, lambda: make(True), data, panel)
    _same_bits(torch, off, on, fields, f"obs {name}")
    del off
    check(l_off == l_on, f"obs {name}: launches differ with telemetry: {l_off} / {l_on}")
    num_panels = on.n // panel
    check(int(on.tel.panels_seen) == num_panels, f"obs {name}: {int(on.tel.panels_seen)} panels")
    omega = on.tel.omega[: on.n].double()
    num = den = 0.0
    for r in range(0, 1024, 256):  # float64 rows of A·Ω_test, 256 at a time
        want = data[r : r + 256].double() @ omega
        num += float(torch.sum((on.tel.psi[r : r + 256].double() - want) ** 2))
        den += float(torch.sum(want ** 2))
    psi_rel = math.sqrt(num / den)
    check(psi_rel <= 1e-5, f"obs {name}: Psi off A*Omega by {psi_rel}")
    est = float(estimate_rel_error(on))
    true = true_error(fin(on))
    check(true / EST_BAND <= est <= EST_BAND * true, f"obs {name}: estimate {est}, true {true}")
    digest = _tel_digest(on)
    # the Ψ fold alone over the whole window (the frame is thrown away after)
    psi_ms = timed(torch, lambda: fold_psi_chunk(on.tel, data[:, : on.n], 0), iters=5, warmup=1)
    psi_bound = bound_ms(4 * (data.shape[0] * on.n + on.n * on.tel.psi.shape[1]),
                         2 * data.shape[0] * on.n * on.tel.psi.shape[1], card_peaks(torch))
    del on
    torch.cuda.empty_cache()
    times = {False: [t_off], True: [t_on]}
    for tel in OBS_TIMED:
        times[tel].append(_stream(torch, ops, lambda: make(tel), data, panel)[2])
        torch.cuda.empty_cache()
    t_off, t_on = (sorted(times[tel])[len(times[tel]) // 2] for tel in (False, True))
    dev_ms = {}
    prof_panels = 8 if window else num_panels
    for tel in (False, True):
        state = make(tel)
        if window:
            state = stream_panels(state, data, panel, stop=2 * panel)
        torch.cuda.synchronize()
        stop = (2 + prof_panels) * panel if window else None
        wall_ms, busy_ms, n_ops, _ = device_profile(
            torch, lambda: stream_panels(state, data, panel, stop=stop))
        dev_ms[tel] = (busy_ms / prof_panels, n_ops / prof_panels)
        del state
        torch.cuda.empty_cache()
    emit(f"obs/{name}", panels=num_panels, factors_bitwise=True, launches=l_on,
         psi_rel_err_rows_1024=psi_rel, estimate_rel_error=est, true_rel_error=true,
         estimate_over_true=est / true,
         host_ms_per_panel={"off": 1e3 * t_off / num_panels, "on": 1e3 * t_on / num_panels},
         host_ratio=t_on / t_off, host_ms_per_panel_runs={
             k: [round(1e3 * t / num_panels, 4) for t in times[tel]]
             for k, tel in (("off", False), ("on", True))},
         device_ms_per_panel={"off": dev_ms[False][0], "on": dev_ms[True][0]},
         device_ratio=dev_ms[True][0] / dev_ms[False][0],
         device_ops_per_panel={"off": dev_ms[False][1], "on": dev_ms[True][1]},
         profiled_panels="2-9" if window else "all", psi_fold_ms=psi_ms,
         psi_fold_bound_ms=psi_bound[0], psi_fold_library="torch.matmul, fp32",
         telemetry_summary=digest,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         seconds=time.perf_counter() - t_phase)
    return {k: l_off[k] + l_on[k] for k in l_on}


def phase_obs(torch, A, runs) -> list:
    """(m): (a)-(d) with telemetry on and off (``telemetry_run``)."""
    from repro_torch.cur import cur_relative_error, streaming_cur_finalize
    from repro_torch.kernels import ops
    from repro_torch.stream.adaptive import adaptive_cur_finalize

    out = []
    for name, make in runs.items():
        fin = streaming_cur_finalize if name.startswith("a_") else adaptive_cur_finalize
        out.append(telemetry_run(torch, ops, name, make, A, PANEL, fin,
                                 ("C", "R", "M", "col_idx", "row_idx"),
                                 lambda res: float(cur_relative_error(A, res)),
                                 window=not name.startswith("a_")))
    return out


def _sharded(torch, ops, make, data, panel):
    """``simulate_sharded_stream`` at ``WORKERS`` of a fresh state: (merged,
    launches, host seconds)."""
    from repro_torch.stream import simulate_sharded_stream

    state = make()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    merged = simulate_sharded_stream(state, data, panel, WORKERS)
    torch.cuda.synchronize()
    return merged, dict(ops.LAUNCHES), time.perf_counter() - t0


def _recon_rel_diff(torch, f1, f2, cols: int) -> float:
    """``‖U₁Σ₁V₁ᵀ − U₂Σ₂V₂ᵀ‖_F / ‖U₁Σ₁V₁ᵀ‖_F`` in column blocks of 1024."""
    (U1, S1, V1), (U2, S2, V2) = f1, f2
    US1, US2 = U1 * S1[None], U2 * S2[None]
    num = den = 0.0
    for j in range(0, cols, 1024):
        a = US1 @ V1[j : j + 1024].T
        den += float(torch.linalg.vector_norm(a)) ** 2
        num += float(torch.linalg.vector_norm(a.sub_(US2 @ V2[j : j + 1024].T))) ** 2
    return math.sqrt(num / den)


def phase_shard(torch, A, runs, errors, dev) -> list:
    """(n): ``simulate_sharded_stream`` at W = 4 on (a), (c), (d) and (h)
    against their single-host runs, and a telemetered (a) whose merged frame
    must equal the single stream's."""
    from repro_torch.core.svd import sp_svd_finalize, sp_svd_init, sp_svd_sizes
    from repro_torch.cur import cur_relative_error, streaming_cur_finalize
    from repro_torch.kernels import ops
    from repro_torch.stream import shard_panel_ranges
    from repro_torch.stream.adaptive import adaptive_cur_finalize

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    m, n = A.shape
    num_panels = n // PANEL
    launched = []
    # (a): C and R bitwise, kernel 1 once per worker (chunk sketch) and per panel (fold)
    make = runs["a_fixed_countsketch"]
    single, _, t_single = _stream(torch, ops, make, A, PANEL)
    merged, lw, t_shard = _sharded(torch, ops, make, A, PANEL)
    launched.append(lw)
    _same_bits(torch, single, merged, ("C", "R"), "shard a")
    check(lw["countsketch"] == WORKERS + num_panels,
          f"shard a: countsketch launched {lw['countsketch']}, want {WORKERS + num_panels}")
    m_err = err(merged.M, single.M)
    check(m_err[1] <= TOL, f"shard a: M rel err {m_err[1]} > {TOL}")
    errs = [float(cur_relative_error(A, streaming_cur_finalize(st))) for st in (single, merged)]
    emit("shard/a_fixed_countsketch", workers=WORKERS, launches=lw, C_R_bitwise=True,
         M_max_abs_err=m_err[0], M_rel_err=m_err[1], cur_relative_error_single=errs[0],
         cur_relative_error_sharded=errs[1], stream_s_single=t_single, stream_s_sharded=t_shard)
    del single, merged

    # the merged telemetry frame of (a) against the single stream's
    single, _, _ = _stream(torch, ops, lambda: make(True), A, PANEL)
    merged, lw, _ = _sharded(torch, ops, lambda: make(True), A, PANEL)
    launched.append(lw)
    for f in ("admitted", "evicted", "rows_admitted", "occupancy", "events", "panels_seen"):
        check(bool(torch.equal(getattr(merged.tel, f), getattr(single.tel, f))),
              f"shard a telemetry: {f} differs")
    frame_err = {f: err(getattr(merged.tel, f), getattr(single.tel, f))[1]
                 for f in ("panel_scores", "panel_energy", "energy_mass")}
    frame_err["psi"] = float(torch.linalg.norm(merged.tel.psi - single.tel.psi)
                             / torch.linalg.norm(single.tel.psi))
    check(all(e <= 1e-5 for e in frame_err.values()), f"shard a telemetry: {frame_err}")
    emit("shard/a_telemetry_merge", workers=WORKERS, counters_bitwise=True, rel_err=frame_err)
    del single, merged
    torch.cuda.empty_cache()

    # (c): Route B in each worker's slot range; (d): kernel 2 every panel, row dedup
    ranges = shard_panel_ranges(n, PANEL, WORKERS)
    per = C_BUDGET // WORKERS
    for name, kname in (("c_adaptive_gaussian_route_b", "panel_update"),
                        ("d_adaptive_gaussian_evict_rows", "panel_score")):
        merged, lw, t_shard = _sharded(torch, ops, runs[name], A, PANEL)
        launched.append(lw)
        if name.startswith("c_"):
            check(lw[kname] == num_panels, f"shard {name}: {kname} launched {lw[kname]}")
        else:
            check(lw[kname] >= num_panels, f"shard {name}: {kname} launched {lw[kname]}")
        idx = merged.ctx.col_idx.tolist()
        for slot, col in enumerate(idx):
            lo, hi = ranges[slot // per]
            check(col < 0 or lo <= col < hi, f"shard {name}: slot {slot} holds column {col}")
        res = adaptive_cur_finalize(merged)
        n_cols = check_indices(torch, res.col_idx, n, f"shard {name} col_idx")
        n_rows = check_indices(torch, res.row_idx, m, f"shard {name} row_idx")
        check(all(bool(torch.isfinite(t).all()) for t in (res.C, res.U, res.R)),
              f"shard {name}: non-finite factors")
        rel = float(cur_relative_error(A, res))
        check(math.isfinite(rel) and rel < 1.0, f"shard {name}: relative error {rel}")
        emit(f"shard/{name}", workers=WORKERS, launches=lw, stream_s=t_shard,
             slots_per_worker=per, admitted_per_worker=[
                 sum(c >= 0 for c in idx[w * per:(w + 1) * per]) for w in range(WORKERS)],
             slots_in_worker_ranges=True, cols_admitted=n_cols, rows_filled=n_rows,
             rows_unique=True, cur_relative_error_sharded=rel,
             cur_relative_error_single=errors[name])
        del merged, res
        torch.cuda.empty_cache()

    # (h): Algorithm 3, the view kernel at the workers' panel offsets
    sizes = sp_svd_sizes(SVD_K, SVD_EPS)
    make_h = lambda: sp_svd_init(gen(torch, dev, SEED + 40), m, n, sizes=sizes,  # noqa: E731
                                 panel=SVD_PANEL, device=dev)
    single, l1, _ = _stream(torch, ops, make_h, A, SVD_PANEL)
    merged, lw, t_shard = _sharded(torch, ops, make_h, A, SVD_PANEL)
    launched.append(lw)
    check(lw == l1, f"shard h: launches {lw} against single-host {l1}")
    check(bool(torch.equal(merged.R, single.R)), "shard h: R differs")
    c_err, m_err = err(merged.C, single.C)[1], err(merged.M, single.M)[1]
    check(max(c_err, m_err) <= TOL, f"shard h: C, M rel err {c_err}, {m_err}")
    f1, f2 = sp_svd_finalize(single), sp_svd_finalize(merged)
    diff = _recon_rel_diff(torch, f1, f2, n)
    check(diff <= 1e-3, f"shard h: reconstructions differ by {diff}")
    emit("shard/h_fast_sp_svd", workers=WORKERS, launches=lw, stream_s=t_shard, R_bitwise=True,
         C_rel_err=c_err, M_rel_err=m_err, reconstruction_rel_diff=diff,
         phase_peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         phase_seconds=time.perf_counter() - t_phase)
    del single, merged, f1, f2
    torch.cuda.empty_cache()
    return launched


def shard_spsd(torch, ops, run, K) -> dict:
    """(n), (i): the fixed SPSD stream at W = 4 against single-host: C
    bitwise, X within 1e-4 of its largest entry, ``spsd_error_ratio``."""
    from repro_torch.spsd import spsd_error_ratio

    make, fin, _ = run
    single, _, _ = _stream(torch, ops, make, K, PANEL)
    merged, lw, t_shard = _sharded(torch, ops, make, K, PANEL)
    _same_bits(torch, single, merged, ("C", "col_idx"), "shard i")
    r1, r2 = fin(single), fin(merged)
    x_err = err(r2.X, r1.X)
    check(x_err[1] <= 1e-4, f"shard i: X off single-host by {x_err[1]} of its largest")
    ratios = [float(spsd_error_ratio(K, r)) for r in (r1, r2)]
    check(all(math.isfinite(x) for x in ratios), f"shard i: error ratios {ratios}")
    emit("shard/i_streaming_spsd", workers=WORKERS, launches=lw, stream_s=t_shard,
         C_bitwise=True, X_max_abs_err=x_err[0], X_rel_err=x_err[1],
         spsd_error_ratio_single=ratios[0], spsd_error_ratio_sharded=ratios[1])
    del single, merged, r1, r2
    torch.cuda.empty_cache()
    return lw


def panel_update_slot_offset(torch, ops, dev, g, sc, a_l, srt, C0, M0) -> tuple:
    """Kernel 3 for worker 2 of 4 at the main path's shape: its slot range
    starts at ``slot_lo = 64`` with 5 slots filled (``n_filled = 69``,
    ``free = slot_lo + 32 − n_filled``), the other workers' slots hold
    columns; slots and C equal the plain version's, every admitted slot
    lies in ``[69, 96)`` and C outside it is untouched. Returns the largest
    (abs, rel) error of the fp32 outputs."""
    c, c_local, slot_lo, filled = C_BUDGET, C_BUDGET // WORKERS, 2 * (C_BUDGET // WORKERS), 5
    n_filled, hi = slot_lo + filled, slot_lo + C_BUDGET // WORKERS
    C = C0.clone()
    C[:, : c // 2] = torch.randn((C.shape[0], c // 2), generator=g, device=dev)
    C[:, hi:] = torch.randn((C.shape[0], c - hi), generator=g, device=dev)
    C[:, n_filled:hi] = 0.0
    Q, _ = torch.linalg.qr(torch.randn((sc.shape[0], c_local), generator=g, device=dev))
    q = (Q * (torch.arange(c_local, device=dev) < filled)).contiguous()
    kw = dict(min_gain=0.5, run_mean=0.0, true_cols=float(a_l.shape[1]), n_filled=n_filled,
              free=hi - n_filled, panel_cap=16)
    got = ops.panel_update(sc, a_l, srt, q, C.clone(), M0.clone(), **kw)
    with ops.force_plain():
        want = ops.panel_update(sc, a_l, srt, q, C.clone(), M0.clone(), **kw)
    slots = got[5]
    check(bool(torch.equal(slots, want[5])) and bool(torch.equal(got[0], want[0])),
          "panel_update at a slot offset: slots or C differ")
    admitted = slots[slots < c]
    check(admitted.numel() > 0 and bool(((admitted >= n_filled) & (admitted < hi)).all()),
          f"panel_update at a slot offset: slots {admitted.tolist()} outside [{n_filled}, {hi})")
    outside = torch.ones(c, dtype=torch.bool, device=dev)
    outside[n_filled:hi] = False
    check(bool(torch.equal(got[0][:, outside], C[:, outside])),
          "panel_update at a slot offset: C changed outside the worker's free slots")
    e = max((err(x, y) for x, y in zip(got[1:5], want[1:5])), key=lambda e: e[1])
    check(e[1] <= TOL, f"panel_update at a slot offset: rel err {e[1]} > {TOL}")
    emit("kernel/panel_update_slot_offset", slot_lo=slot_lo, c_local=c_local, n_filled=n_filled,
         free=hi - n_filled, admitted=admitted.tolist(), rel_err=e[1])
    return e


# (o)-(q): checkpoints go to the gitignored build directory and are removed after each run
CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"
# (o): crash panels of the 256-panel streams and of (i)'s 128; per run the
# resilient cadence (chunk panels, checkpoint every so many chunks): the
# reference's defaults, but (c), whose Gaussian sketches make a save ~0.8 GB
CRASH_A, CRASH_I = 150, 70
RESUME_CADENCE = {"a_fixed_countsketch": (4, 2), "b_adaptive_countsketch_chunk": (4, 2),
                  "c_adaptive_gaussian_route_b": (16, 4), "i_streaming_spsd": (4, 2)}
# timed drives per side (cut from 3 to 1 for the script's time limit); saves
# and restores timed as often
RESUME_TIMED = 1
# (o), (a): run_resilient_loop over 64 one-chunk steps fails at step 37 and
# restores the checkpoint of step 32
LOOP_FAIL_AT, LOOP_CKPT_EVERY = 37, 8
# (o), (a) and (c): the NaN panels of the armed drive against the unarmed one
QUARANTINE_PANELS = (40, 200)
# (p): the chaos lane's seed; (q): the gloo ranks sharing the card
CHAOS_SEED, MESH_WORKERS = 0, (2, 4)
# the frame's float fields of a sharded run reduced per chunk against per range
# (the reference's multi-device tolerance), and M summed over four ranks in
# gloo's order against the in-process order
FRAME_TOL, MESH_M_TOL = 1e-5, 1e-6
_READ_ONLY = re.compile(r"\.(S_C|S_R|S1|S2)\.|\.omega$|\.sr_dense$")
_FRAME_FLOATS = (".tel.panel_scores", ".tel.panel_energy", ".tel.energy_mass", ".tel.psi")


def state_tensors(state) -> dict:
    """The tensors a stream writes — accumulators, ctx, frame — by their
    checkpoint keys; the read-only sketches, Ω_test and dense S_R left out."""
    from repro_torch.checkpoint.checkpoint import _leaves

    return {k: v for k, v, scalar in _leaves(state) if scalar is None and not _READ_ONLY.search(k)}


def same_state(torch, a, b, name: str, tol: dict = None) -> dict:
    """Every written tensor of ``a`` equals ``b``'s bit for bit, but the keys
    of ``tol`` (within their relative tolerance); the host offsets equal.
    Returns the relative errors of the toleranced keys."""
    ta, tb = state_tensors(a), state_tensors(b)
    check(ta.keys() == tb.keys(), f"{name}: leaves {sorted(ta.keys() ^ tb.keys())} differ")
    check(a.offset == b.offset, f"{name}: offset {a.offset} against {b.offset}")
    errs = {}
    for k, x in ta.items():
        if tol and k in tol:
            errs[k] = err(x, tb[k])[1] if x.numel() else 0.0
            check(errs[k] <= tol[k], f"{name}: {k} rel err {errs[k]} > {tol[k]}")
        else:
            check(bool(torch.equal(x, tb[k])), f"{name}: {k} differs")
    return errs


def host_s(torch, fn):
    """``(fn(), host seconds)`` around a synchronised call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def median(xs) -> float:
    return float(sorted(xs)[len(xs) // 2])


def resilient_cases(A, K, runs, make_i, names) -> list:
    """``(name, make, data, crash panel)`` of the runs ``names``."""
    cases = [(n, runs[n], A, CRASH_A) for n in names if n in runs]
    if "i_streaming_spsd" in names:
        cases.append(("i_streaming_spsd", make_i, K, CRASH_I))
    return cases


def phase_resume(torch, A, K, runs, make_i) -> list:
    """(o): ``run_resilient_stream`` with telemetry on (a), (b), (c), (i):
    killed at a panel, resumed from its checkpoints in a second invocation,
    and held bitwise against an uninterrupted drive at the same cadence
    (C, R, M, the ctx, the frame's counters and Ψ); bytes per checkpoint,
    save and restore ms, panels replayed, host ms per panel of the chunked
    drive beside the whole-stream ``stream_panels`` and with a checkpoint
    every 8 chunks; (a) and (c) a quarantined kill-and-resume against an
    unarmed drive of zeroed panels. (a) also crashes at its last panel,
    kills one worker of
    ``run_resilient_sharded_stream`` at W = 4 and runs ``run_resilient_loop``
    with ``fail_at_step`` one chunk per step. Returns the drives' launches."""
    from repro_torch.checkpoint.checkpoint import _host_snapshot, _leaves
    from repro_torch.kernels import ops
    from repro_torch.stream import (ArrayPanelSource, FaultInjector, FaultPlan, InjectedCrash,
                                    restore_stream_state, run_resilient_stream, save_stream_state,
                                    stream_panels)

    launched = []
    for name, make, data, crash in resilient_cases(
            A, K, runs, make_i, ("a_fixed_countsketch", "b_adaptive_countsketch_chunk",
                                 "c_adaptive_gaussian_route_b", "i_streaming_spsd")):
        t_case = time.perf_counter()
        cp, every = RESUME_CADENCE[name]
        num_panels = data.shape[1] // PANEL
        src = ArrayPanelSource(data, PANEL)
        d = CKPT_ROOT / name
        shutil.rmtree(d, ignore_errors=True)
        # host ms per panel, in turns: the chunked drive without checkpoints
        # (the last one is the reference), the whole stream, and the chunked
        # drive with a checkpoint every 8 chunks (the reference's +ckpt8)
        chunked_s, whole_s, ck8_s = [], [], []
        for _ in range(RESUME_TIMED):
            st = make(True)
            ops.reset_launches()
            (ref, rep0), t = host_s(torch, lambda: run_resilient_stream(st, src, chunk_panels=cp))
            chunked_s.append(t)
            l_clean = dict(ops.LAUNCHES)
            st = make(True)
            _, t = host_s(torch, lambda: stream_panels(st, data, PANEL))
            whole_s.append(t)
            st = make(True)
            _, t = host_s(torch, lambda: run_resilient_stream(
                st, src, chunk_panels=cp, ckpt_dir=str(d / "ck8"), ckpt_every=8, resume=False))
            ck8_s.append(t)
        check(rep0.panels_consumed == num_panels, f"resume {name}: clean drive stopped early")
        shutil.rmtree(d, ignore_errors=True)
        del st
        # killed before the chunk holding panel `crash`, resumed in a second invocation
        inj = FaultInjector(src, FaultPlan(crash_at_panel=crash))
        ops.reset_launches()
        try:
            run_resilient_stream(make(True), inj, chunk_panels=cp, ckpt_dir=str(d),
                                 ckpt_every=every)
            fail(f"resume {name}: the injected crash did not fire")
        except InjectedCrash:
            pass
        st, rep = run_resilient_stream(make(True), inj, chunk_panels=cp, ckpt_dir=str(d),
                                       ckpt_every=every)
        torch.cuda.synchronize()
        l_kill = dict(ops.LAUNCHES)
        launched += [l_clean, l_kill]
        consumed = crash // cp * cp  # the panels the killed drive had consumed
        check(rep.resumed_from is not None and rep.resumed_from <= consumed,
              f"resume {name}: resumed from {rep.resumed_from}")
        same_state(torch, ref, st, f"resume {name}")
        ckpt_bytes = os.path.getsize(d / f"step_{rep.panels_consumed:08d}.ckpt")
        # save and restore times of the final state (durable=False, as the driver saves)
        tdir, template = CKPT_ROOT / "timing", make(True)
        saves, restores, snaps = [], [], []
        for _ in range(RESUME_TIMED):
            _, t = host_s(torch, lambda: _host_snapshot(_leaves(st), copy_cpu=False))
            snaps.append(t)
            _, t = host_s(torch, lambda: save_stream_state(str(tdir), st, num_panels, keep_last=1,
                                                           durable=False))
            saves.append(t)
            (back, _, _), t = host_s(torch, lambda: restore_stream_state(str(tdir), template))
            restores.append(t)
        same_state(torch, st, back, f"resume {name}: restore")
        check(back.C.device == st.C.device and back.M.data_ptr() != st.M.data_ptr(),
              f"resume {name}: restore placement")
        del back, template
        shutil.rmtree(tdir, ignore_errors=True)
        out = dict(chunk_panels=cp, ckpt_every=every, crash_at_panel=crash,
                   resumed_from=rep.resumed_from, panels_replayed=consumed - rep.resumed_from,
                   checkpoints_after_resume=rep.checkpoints, bitwise=True,
                   ckpt_bytes=ckpt_bytes, save_ms=1e3 * median(saves),
                   save_ms_all=[1e3 * x for x in saves], snapshot_ms=1e3 * median(snaps),
                   restore_ms=1e3 * median(restores),
                   restore_ms_all=[1e3 * x for x in restores],
                   chunked_ms_per_panel=1e3 * median(chunked_s) / num_panels,
                   whole_stream_ms_per_panel=1e3 * median(whole_s) / num_panels,
                   ckpt8_over_none=median(ck8_s) / median(chunked_s),
                   ckpt8_s_all=ck8_s, none_s_all=chunked_s,
                   launches_clean_drive=l_clean, launches_kill_resume=l_kill)
        out["chunked_over_whole"] = out["chunked_ms_per_panel"] / out["whole_stream_ms_per_panel"]
        del st, ref
        shutil.rmtree(d, ignore_errors=True)
        if name.startswith(("a_", "i_")):  # the cheap streams: where the chunked drive's time goes
            st = make(True)
            wall_ms, busy_ms, n_ops, top = device_profile(
                torch, lambda: run_resilient_stream(st, src, chunk_panels=cp))
            out["chunked_profile"] = dict(
                wall_ms=wall_ms, device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
                device_ops_per_chunk=n_ops / (num_panels // cp), top_device_ms=top)
            del st
        if name.startswith(("a_", "c_")):
            out["quarantine_drill"] = quarantine_drill(torch, name, make, src, cp, every, crash,
                                                       launched)
        if name.startswith("a_"):
            out.update(resume_drills_a(torch, make, data, src, cp, every, launched))
        out["seconds"] = time.perf_counter() - t_case
        emit(f"resume/{name}", **out)
        torch.cuda.empty_cache()
    return launched


def quarantine_drill(torch, name, make, src, cp, every, crash, launched) -> dict:
    """(o), (a) and (c): two NaN panels, an armed drive killed and resumed,
    against an unarmed drive of the source with those panels zeroed: an
    armed state leaves Route A for the per-panel body ((c) stays on Route
    B), and the result must not change, bit for bit, through a restore."""
    from repro_torch.kernels import ops
    from repro_torch.obs import EVENT_QUARANTINED
    from repro_torch.stream import FaultInjector, FaultPlan, InjectedCrash, run_resilient_stream

    bad = QUARANTINE_PANELS
    ref, _ = run_resilient_stream(make(True), ZeroedSource(src, bad), chunk_panels=cp)
    d = CKPT_ROOT / f"quarantine_{name}"
    shutil.rmtree(d, ignore_errors=True)
    inj = FaultInjector(src, FaultPlan(crash_at_panel=crash, corrupt_panels=bad))
    ops.reset_launches()
    try:
        run_resilient_stream(make(True), inj, chunk_panels=cp, ckpt_dir=str(d), ckpt_every=every,
                             quarantine=True)
        fail(f"quarantine {name}: the injected crash did not fire")
    except InjectedCrash:
        pass
    st, rep = run_resilient_stream(make(True), inj, chunk_panels=cp, ckpt_dir=str(d),
                                   ckpt_every=every, quarantine=True)
    torch.cuda.synchronize()
    launched.append(dict(ops.LAUNCHES))
    check(rep.quarantined == len(bad), f"quarantine {name}: quarantined {rep.quarantined}")
    st.quarantined = None  # the unarmed drive has neither the count nor the event bit
    st.tel.events &= ~EVENT_QUARANTINED
    # the frame's float fields are reduced per chunk on Route A, per panel off it
    frame = same_state(torch, ref, st, f"quarantine {name}", {k: FRAME_TOL for k in _FRAME_FLOATS})
    shutil.rmtree(d, ignore_errors=True)
    return dict(corrupt_panels=list(bad), resumed_from=rep.resumed_from, quarantined=len(bad),
                factors_bitwise_vs_unarmed_zeroed=True, frame_rel_err=frame,
                launches=launched[-1])


def resume_drills_a(torch, make, data, src, cp, every, launched) -> dict:
    """(o), (a) only: the crash at the last panel, one killed worker of
    four, and ``run_resilient_loop``."""
    from repro_torch.checkpoint import run_resilient_loop
    from repro_torch.kernels import ops
    from repro_torch.stream import (FaultInjector, FaultPlan, InjectedCrash,
                                    run_resilient_sharded_stream, run_resilient_stream,
                                    stream_panels)

    num_panels = data.shape[1] // PANEL
    ref, _ = run_resilient_stream(make(True), src, chunk_panels=cp)
    d = CKPT_ROOT / "a_drills"
    shutil.rmtree(d, ignore_errors=True)
    inj = FaultInjector(src, FaultPlan(crash_at_panel=num_panels - 1))
    try:
        run_resilient_stream(make(True), inj, chunk_panels=cp, ckpt_dir=str(d / "last"),
                             ckpt_every=every)
        fail("resume a: the crash at the last panel did not fire")
    except InjectedCrash:
        pass
    st, rep = run_resilient_stream(make(True), inj, chunk_panels=cp, ckpt_dir=str(d / "last"),
                                   ckpt_every=every)
    same_state(torch, ref, st, "resume a, last panel")
    last_resumed = rep.resumed_from
    del st
    # one of four workers killed, resumed from its own directory, against the healthy run
    healthy, _ = run_resilient_sharded_stream(make(True), src, WORKERS, chunk_panels=cp)
    state0 = make(True)
    inj = FaultInjector(src, FaultPlan(crash_at_panel=CRASH_A))
    ops.reset_launches()
    try:
        run_resilient_sharded_stream(state0, inj, WORKERS, ckpt_dir=str(d / "shard"),
                                     chunk_panels=cp, ckpt_every=every)
        fail("resume a sharded: the injected crash did not fire")
    except InjectedCrash:
        pass
    st, reps = run_resilient_sharded_stream(state0, inj, WORKERS, ckpt_dir=str(d / "shard"),
                                            chunk_panels=cp, ckpt_every=every)
    torch.cuda.synchronize()
    launched.append(dict(ops.LAUNCHES))
    crashed = CRASH_A // (num_panels // WORKERS)  # the workers before it had finished
    check(all(r.resumed_from is not None for r in reps[:crashed])
          and all(r.resumed_from is None for r in reps[crashed + 1:]),
          f"resume a sharded: resumed {[r.resumed_from for r in reps]}")
    same_state(torch, healthy, st, "resume a sharded")
    del healthy, st, state0

    # run_resilient_loop: one chunk per step; the failure restores the checkpoint before it
    def loop(ckpt_dir: Path, fail_at):
        held = {}

        def step_fn(state, batch, step):
            held["state"] = stream_panels(state, batch, PANEL, col0=step * cp * PANEL)
            return held["state"], {"offset": held["state"].offset}

        report = run_resilient_loop(
            state=make(True), step_fn=step_fn, n_steps=num_panels // cp, ckpt_dir=str(ckpt_dir),
            batch_fn=lambda step: data[:, step * cp * PANEL:(step + 1) * cp * PANEL],
            ckpt_every=LOOP_CKPT_EVERY, fail_at_step=fail_at)
        return held["state"], report

    whole, _ = loop(d / "loop_clean", None)
    ops.reset_launches()
    failed, report = loop(d / "loop_fail", LOOP_FAIL_AT)
    launched.append(dict(ops.LAUNCHES))
    check(report.restarts == 1 and failed.C.device == data.device,
          "resume a loop: no restart onto the card")
    same_state(torch, whole, failed, "resume a loop")
    restored_onto = str(failed.C.device)
    del whole, failed
    shutil.rmtree(d, ignore_errors=True)
    return dict(last_panel_crash=dict(resumed_from=last_resumed, bitwise=True),
                sharded_w4_worker_killed=dict(workers=WORKERS, crash_at_panel=CRASH_A,
                                              resumed=[r.resumed_from for r in reps],
                                              bitwise=True),
                resilient_loop=dict(steps=num_panels // cp, fail_at_step=LOOP_FAIL_AT,
                                    restarts=report.restarts,
                                    restored_onto=restored_onto,
                                    bitwise=True))


class ZeroedSource:
    """A panel source whose reads of ``panels`` come back zero there, in a
    clone of the chunk (the source's data is left as it is)."""

    def __init__(self, source, panels):
        self.source, self.panels = source, tuple(panels)
        self.panel, self.n, self.num_panels = source.panel, source.n, source.num_panels

    def read_chunk(self, lo: int, num: int):
        tag, chunk = self.source.read_chunk(lo, num)
        bad = [t for t in self.panels if lo <= t < lo + num]
        if bad:
            chunk = chunk.clone()
            for t in bad:
                chunk[:, (t - lo) * self.panel:(t - lo + 1) * self.panel] = 0
        return tag, chunk


def phase_chaos(torch, A, K, runs, make_i) -> list:
    """(p): the chaos lane's schedule from ``CHAOS_SEED`` over (a), (b), (i)
    — a crash, two NaN panels, a drop, a duplicate, a straggler — through
    retry, dedup, checkpoint-resume and quarantine, held bitwise against a
    clean quarantined drive with the corrupted panels zeroed (in a clone);
    quarantined 2, the registry's counts those of the faults that fired."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.obs import EVENT_QUARANTINED, MetricsRegistry, set_registry
    from repro_torch.stream import (ArrayPanelSource, FaultInjector, FaultPlan, InjectedCrash,
                                    run_resilient_stream)

    rng = np.random.RandomState(CHAOS_SEED)  # one draw per run, in order, as the lane draws
    launched = []
    for name, make, data, _ in resilient_cases(
            A, K, runs, make_i, ("a_fixed_countsketch", "b_adaptive_countsketch_chunk",
                                 "i_streaming_spsd")):
        t_case = time.perf_counter()
        num_panels = data.shape[1] // PANEL
        sched = fault_schedule(rng, num_panels)
        plan = FaultPlan(straggler_delay_s=0.002, **sched)
        src = ArrayPanelSource(data, PANEL)
        ref, _ = run_resilient_stream(make(True), ZeroedSource(src, plan.corrupt_panels),
                                      quarantine=True)
        d = CKPT_ROOT / f"chaos_{name}"
        shutil.rmtree(d, ignore_errors=True)
        reg = MetricsRegistry(enabled=True)
        prev = set_registry(reg)
        inj = FaultInjector(src, plan)
        ops.reset_launches()
        try:
            try:
                run_resilient_stream(make(True), inj, ckpt_dir=str(d), quarantine=True)
                fail(f"chaos {name}: the injected crash did not fire")
            except InjectedCrash:
                pass
            st, rep = run_resilient_stream(make(True), inj, ckpt_dir=str(d), quarantine=True)
            torch.cuda.synchronize()
        finally:
            set_registry(prev)
        launched.append(dict(ops.LAUNCHES))
        counters = dict(reg.counters)
        flagged = torch.nonzero(st.tel.events & EVENT_QUARANTINED).flatten().tolist()
        check(rep.quarantined == 2 and int(st.quarantined) == 2, f"chaos {name}: quarantined")
        check(flagged == list(plan.corrupt_panels), f"chaos {name}: flagged panels {flagged}")
        check(counters.get("stream/resilient/quarantined") == 2, f"chaos {name}: {counters}")
        check(inj._dropped == set(plan.drop_panels), f"chaos {name}: the drop did not fire")
        check(counters.get("stream/resilient/retries") == len(inj._dropped) + len(inj._duplicated),
              f"chaos {name}: retries {counters}")
        # the only differences from the clean drive: the count and the event bit
        st.quarantined.zero_()
        st.tel.events &= ~EVENT_QUARANTINED
        same_state(torch, ref, st, f"chaos {name}")
        check(bool(torch.isfinite(data).all()), f"chaos {name}: the source's data was written")
        emit(f"chaos/{name}", seed=CHAOS_SEED, schedule=sched, resumed_from=rep.resumed_from,
             retries=rep.retries, quarantined=rep.quarantined,
             duplicate_fired=bool(inj._duplicated), registry=counters, bitwise=True,
             launches=launched[-1], seconds=time.perf_counter() - t_case)
        del ref, st
        shutil.rmtree(d, ignore_errors=True)
    return launched


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_rank(rank: int, world: int, jobs: dict) -> dict:
    """One pool rank's (q) job on the card: each job's column block (a view
    of the parent's tensor, shared through CUDA IPC) through
    ``mesh_sharded_stream``, launches and ``all_reduce`` calls counted over
    that call alone; then rank 0's merged state is broadcast and every rank
    compares it with its own, and rank 0 holds its state against
    ``simulate_sharded_stream`` at the same W (C, R, indices and counters
    bitwise; M bitwise at W = 2, within ``MESH_M_TOL`` beyond) and, for (a)
    at W = 2, against ``run_resilient_sharded_stream``."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.stream import (ArrayPanelSource, mesh_sharded_stream, padded_n,
                                    run_resilient_sharded_stream, simulate_sharded_stream)

    real, calls, coll_ms = dist.all_reduce, [0], []
    real(torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu"))  # connects

    def counted(t, *args, **kwargs):  # counts, and times each collective alone
        calls[0] += 1
        out, s = host_s(torch, lambda: real(t, *args, **kwargs))
        coll_ms.append(1e3 * s)
        return out

    dist.all_reduce = counted
    try:
        results = {}
        for name, (make, data) in jobs.items():
            n_pad = padded_n(data.shape[1], PANEL)
            block = data[:, rank * n_pad // world:(rank + 1) * n_pad // world]
            state0 = make()
            torch.cuda.synchronize()
            dist.barrier()  # rank 0's checks of the job before do not count as waiting here
            ops.reset_launches()
            calls[0] = 0
            coll_ms.clear()
            merged, t = host_s(torch, lambda: mesh_sharded_stream(state0, block, PANEL))
            res = dict(launches=dict(ops.LAUNCHES), all_reduce_calls=calls[0], host_s=t,
                       all_reduce_ms=sum(coll_ms), largest_all_reduce_ms=sorted(coll_ms)[-3:],
                       block_cols=block.shape[1])
            same = True
            for x in state_tensors(merged).values():
                if x.numel():
                    r0 = x.clone()
                    dist.broadcast(r0, src=0)
                    same &= bool(torch.equal(r0, x))
            res["same_as_rank0"] = same
            if rank == 0:
                tol = {".M": MESH_M_TOL} if world > 2 else {}
                if world > 2:
                    tol.update({k: MESH_M_TOL for k in (".tel.psi", ".tel.energy_mass",
                                                        ".ctx.energy", ".ctx.rows.row_sketch")})
                sim = simulate_sharded_stream(make(), data, PANEL, world)
                res["vs_simulate_rel_err"] = same_state(torch, sim, merged, f"mesh {name}", tol)
                del sim
                if name.startswith("a_") and world == 2:
                    rs, _ = run_resilient_sharded_stream(make(), ArrayPanelSource(data, PANEL),
                                                         world)
                    res["vs_resilient_rel_err"] = same_state(
                        torch, rs, merged, f"mesh {name} resilient",
                        {k: FRAME_TOL for k in _FRAME_FLOATS})
                    del rs
            results[name] = res
            del merged, state0
            torch.cuda.empty_cache()
        return results
    finally:
        # drop the parent's tensors at once: while this rank holds them (CUDA
        # IPC), the parent cannot free A and K for the later phases
        jobs.clear()
        torch.cuda.synchronize()


def pool_sync(rank: int, world: int, job: dict) -> dict:
    """An empty pool job: once it returns, every rank has finished freeing
    its previous job's tensors (a rank frees a job before it takes the next)."""
    return {}


def on_host(torch, obj):
    """``obj`` with every tensor in it as a numpy array: a rank's results
    pickled by value, which reach the parent after the rank has exited (a
    tensor would go by a file descriptor of the rank's, gone with it)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: on_host(torch, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(on_host(torch, v) for v in obj)
    return obj


def from_host(torch, obj):
    """:func:`on_host` undone: every numpy array in ``obj`` a tensor again."""
    if type(obj).__name__ == "ndarray":
        return torch.from_numpy(obj)
    if isinstance(obj, dict):
        return {k: from_host(torch, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_host(torch, v) for v in obj)
    return obj


def pool_rank(rank: int, world: int, init: str, queues: list, out_q) -> None:
    """One gloo rank of a :class:`RankPool` on the card, kept for every mesh
    phase from (q) on: the kernels loaded and the group made once, then each
    job ``(target, job)`` of its queue in turn, ``target(rank, world, job)``
    returning the results it sends back (as numpy, ``on_host``); ``None``
    ends it. ``dist.all_reduce`` is restored after each job (the phases
    count collectives by wrapping it), and the job's memory is freed."""
    import datetime
    import gc

    # ranks share the card: growable segments leave no reserved but unused
    # blocks behind (1.7 GiB a rank with fixed ones, which 2x2 lacks)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    build.build_all()  # loads the libraries the parent built
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=900))
    real = dist.all_reduce
    try:
        out_q.put((rank, "ready"))
        while (item := queues[rank].get()) is not None:
            target, job = item
            try:
                out = target(rank, world, job)
            finally:
                dist.all_reduce = real
            out_q.put((rank, on_host(torch, out)))
            del out, item
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks spawned once on this card (:func:`pool_rank`) and
    shared by the mesh phases (q), (ts), (ep), (hy) and (tp), which hand them
    jobs through :meth:`run` in place of a spawn each: a spawn's start (the
    interpreter, torch, a CUDA context, the kernels' libraries, the group)
    is paid once a world, and overlaps the phases the parent runs before
    the first job. The ranks meet at a file of their own (a ``file://``
    store in a fresh temporary directory), not a TCP port: ranks another
    process spawns at the same time can neither take it nor join their
    group."""

    def __init__(self, torch, world: int):
        import tempfile

        mp = torch.multiprocessing
        ctx = mp.get_context("spawn")
        self.torch, self.world = torch, world
        self.queues = [ctx.Queue() for _ in range(world)]
        self.out_q = ctx.Queue()
        self.store = tempfile.mkdtemp()
        self.t0 = time.perf_counter()
        self.ready_s = None
        self.procs = mp.start_processes(pool_rank, args=(world, f"file://{self.store}/store",
                                                         self.queues, self.out_q),
                                        nprocs=world, join=False, start_method="spawn")

    def _collect(self, timeout: float, what: str) -> dict:
        import queue

        results, deadline = {}, time.monotonic() + timeout
        while len(results) < self.world:
            try:
                rank, out = self.out_q.get(timeout=1.0)
                results[rank] = out
            except queue.Empty:
                self.procs.join(timeout=0)  # raises if a rank failed
                check(time.monotonic() < deadline, f"pool W={self.world}: {what} did not report")
        return results

    def run(self, target, job: dict, timeout: float = 900.0) -> dict:
        """``target(rank, world, job)`` on every rank; their results by rank.
        A failed rank fails the phase."""
        if self.ready_s is None:
            self._collect(300.0, "the ranks' start")
            self.ready_s = time.perf_counter() - self.t0
            emit(f"mesh/pool_w{self.world}", spawn_to_ready_s=self.ready_s)
        for q in self.queues:
            q.put((target, job))
        out = self._collect(timeout, target.__name__)
        return {r: from_host(self.torch, v) for r, v in out.items()}

    def close(self, timeout: float = 120.0) -> None:
        try:
            for q in self.queues:
                q.put(None)
            deadline = time.monotonic() + timeout
            while not self.procs.join(timeout=1.0):
                if time.monotonic() > deadline:
                    break
        finally:
            for p in self.procs.processes:
                if p.is_alive():
                    p.terminate()
            shutil.rmtree(self.store, ignore_errors=True)


POOLS: dict = {}  # world -> RankPool, open from (q) to (tp)


def pool_run(torch, world: int, target, job: dict, timeout: float = 900.0) -> dict:
    """``target`` on the open pool of ``world`` ranks (one is started if none is)."""
    if world not in POOLS:
        POOLS[world] = RankPool(torch, world)
    return POOLS[world].run(target, job, timeout)


def close_pool(world: int) -> None:
    pool = POOLS.pop(world, None)
    if pool is not None:
        pool.close()


def phase_mesh(torch, A, K, ci_ri, ci_i, dev) -> list:
    """(q): ``mesh_sharded_stream`` in W = 2 and 4 gloo ranks on this one card
    (the rank pools; (a) telemetered, (c), (d), (i); ``mesh_rank``) — the ranks share the
    parent's A and K through CUDA IPC, never a copy — with the kernel build
    reused by the ranks; then an NCCL group of one rank in this process runs
    (a) against the single-host stream, bitwise. Two ranks sharing one card
    say nothing about scaling across cards. Returns the ranks' launches."""
    import torch.distributed as dist

    from repro_torch.kernels import build, ops
    from repro_torch.stream import mesh_sharded_stream, stream_panels

    m, n = A.shape
    ci, ri = (x.cpu() for x in ci_ri)
    jobs = {name: (functools.partial(path_state, name, m, n, ci, ri, dev, name.startswith("a_")),
                   A) for name in ("a_fixed_countsketch", "c_adaptive_gaussian_route_b",
                                   "d_adaptive_gaussian_evict_rows")}
    jobs["i_streaming_spsd"] = (functools.partial(spsd_state, ci_i.cpu(), dev), K)
    need = {"a_fixed_countsketch": ("countsketch", n // PANEL),
            "c_adaptive_gaussian_route_b": ("panel_update", n // PANEL),
            "d_adaptive_gaussian_evict_rows": ("panel_score", n // PANEL),
            "i_streaming_spsd": ("countsketch", SPSD_N // PANEL)}
    libs = sorted((build.BUILD_ROOT / build.source_hash()).glob("lib*.so"))
    mtimes = [p.stat().st_mtime_ns for p in libs]
    launched = []
    for world in MESH_WORKERS:
        results, wall = host_s(torch, lambda: pool_run(torch, world, mesh_rank, jobs))  # noqa: B023
        for name in jobs:
            per_rank = [results[r][name] for r in range(world)]
            check(all(r["same_as_rank0"] for r in per_rank), f"mesh {name} W={world}: ranks differ")
            calls = {r["all_reduce_calls"] for r in per_rank}
            check(len(calls) == 1, f"mesh {name} W={world}: all_reduce calls {calls}")
            total = {k: sum(r["launches"][k] for r in per_rank) for k in ops.LAUNCHES}
            launched.append(total)
            kname, count = need[name]
            check(total[kname] >= count, f"mesh {name} W={world}: {kname} launched {total[kname]}")
            emit(f"mesh/{name}_w{world}", backend="gloo", workers=world,
                 all_reduce_calls_per_call=calls.pop(),
                 launches_per_rank=[r["launches"] for r in per_rank],
                 host_s_per_rank=[r["host_s"] for r in per_rank],
                 all_reduce_ms_per_rank=[r["all_reduce_ms"] for r in per_rank],
                 largest_all_reduce_ms_rank0=per_rank[0]["largest_all_reduce_ms"],
                 block_cols=per_rank[0]["block_cols"], ranks_equal=True,
                 vs_simulate=dict(bitwise_but=per_rank[0]["vs_simulate_rel_err"]),
                 vs_resilient=per_rank[0].get("vs_resilient_rel_err"))
        pool_run(torch, world, pool_sync, {})  # the ranks have let go of A and K
        emit(f"mesh/w{world}", pool_job_s=wall, shared_operands="CUDA IPC views, no copies")
    check(libs and [p.stat().st_mtime_ns for p in libs] == mtimes,
          "mesh: the ranks rebuilt kernels")

    # an NCCL group of one rank in this process: (a) against the single-host stream
    make = functools.partial(path_state, "a_fixed_countsketch", m, n, ci, ri, dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0)
    try:
        dist.all_reduce(torch.zeros(1, device=dev))  # creates the communicator
        single = stream_panels(make(), A, PANEL)
        state0 = make()
        torch.cuda.synchronize()
        ops.reset_launches()
        merged, t = host_s(torch, lambda: mesh_sharded_stream(state0, A, PANEL))
        launched.append(dict(ops.LAUNCHES))
        same_state(torch, single, merged, "mesh nccl")
    finally:
        dist.destroy_process_group()
    emit("mesh/a_fixed_countsketch_nccl_w1", backend="nccl", workers=1, host_s=t,
         launches=launched[-1], bitwise_vs_single_host=True, build_reused_by_ranks=True,
         note="gloo ranks share one card: parity and collective counts, not scaling across cards")
    del single, merged, state0
    torch.cuda.empty_cache()
    return launched


def serve_errors(torch, cfg, dense: dict, comp: dict) -> tuple:
    """Every converted head's relative error against its own prompt history,
    and the optimal error at the head's rank (``torch.linalg.svdvals``):
    ``(errors, optima)``, each (converted layers · 2 · B · KV,); layers that
    pass through (cross, Mamba-2) are skipped."""
    from repro_torch.serve import CompressedKV, LowRankKV, compression_error

    errs, opts = [], []
    for layer, cache in zip(dense["layers"], comp["layers"]):
        if not isinstance(cache, CompressedKV):
            continue
        for name, fac in (("k", cache.k_fac), ("v", cache.v_fac)):
            check(all(bool(torch.isfinite(t).all()) for t in (fac.v_s, fac.sigma, fac.u)),
                  f"non-finite {name} factors")
            hist = layer[name][:, :SERVE_S].permute(0, 2, 1, 3).float()  # (B, KV, S, hd)
            errs.append(compression_error(hist, LowRankKV(fac.v_s[:, :, :SERVE_S], fac.sigma,
                                                          fac.u)).reshape(-1))
            sv2 = torch.linalg.svdvals(hist) ** 2  # (B, KV, hd), descending
            rank = (fac.sigma > 0).sum(-1, keepdim=True)
            tail = torch.where(torch.arange(sv2.shape[-1], device=sv2.device) >= rank, sv2, 0)
            opts.append(torch.sqrt(tail.sum(-1) / sv2.sum(-1)).reshape(-1))
    return torch.cat(errs), torch.cat(opts)


def serve_profile(torch, model, cfg, cache, toks, kc=None) -> dict:
    """``torch.profiler`` over 8 eager decode steps from ``cache`` (fed
    ``toks``; with a compressed cache's ``kc``, at its schedule's phases):
    wall and device-busy ms per step, the idle share, the top kernels."""
    from repro_torch.models import decode_step
    from repro_torch.serve import decode_schedule

    def steps():
        for t, (phase, _) in enumerate(decode_schedule(kc, 8)):
            decode_step(model, cfg, cache, toks[:, t : t + 1], phase=phase)

    wall, busy, n_ops, top = device_profile(torch, steps)
    return dict(wall_ms_per_step=wall / 8, device_busy_ms_per_step=busy / 8,
                device_idle_share=1 - busy / wall, device_ops_per_step=n_ops / 8,
                top_device_ms=top)


def decode_rate(t: dict, st: dict, batch: int) -> dict:
    """ms a token and tokens/s of one ``generate``'s decode loop, from its
    CUDA-event ``timings`` and its ``stats``: the steps timed under
    ``decode`` and ``refresh`` (on the graph route each graph's warm-up
    step counts under ``capture``, with the capture itself), and apart the
    plain and fold steps and the compressed cache's eager refresh steps."""
    steps, refresh = st["replays"] + st["eager_steps"], st["refresh_steps"]
    total = t["decode"] + t["refresh"]
    return dict(decode_ms_per_token=total / steps, tokens_per_s=batch * steps / total * 1e3,
                decode_steps=steps, plain_fold_ms_per_token=t["decode"] / (steps - refresh),
                refresh_ms_per_step=t["refresh"] / refresh if refresh else None,
                capture_ms=t["capture"], route=st["route"], graphs=st["graphs"],
                replays=st["replays"], eager_refresh_steps=refresh, pool_bytes=st["pool_bytes"])


def step_profile(torch, run, step: int) -> dict:
    """``torch.profiler`` over decode step ``step`` of ``run(on_step)`` alone:
    started by ``on_step`` after step ``step − 1`` and stopped after
    ``step``, each after a synchronize. Wall and device-busy ms, the idle
    share, device ops and the host's launch calls (kernels and graphs)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    box = {}

    def hook(i, _logits):
        if i == step - 1:
            torch.cuda.synchronize()
            prof.start()
            box["t0"] = time.perf_counter()
        elif i == step:
            torch.cuda.synchronize()
            box["wall_ms"] = 1e3 * (time.perf_counter() - box["t0"])
            prof.stop()

    run(hook)
    events = prof.key_averages()
    on_dev = lambda e: str(getattr(e, "device_type", "")).endswith("CUDA")  # noqa: E731
    dev = [e for e in events if on_dev(e) and not e.key.startswith("stream/")
           and getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    calls = {e.key: e.count for e in events if not on_dev(e) and "Launch" in e.key}
    wall = box["wall_ms"]
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    return dict(step=step, wall_ms=wall, device_busy_ms=busy if busy else "not measured",
                device_idle_share=1 - busy / wall if busy else "not measured",
                device_ops=sum(e.count for e in dev), host_launches=sum(calls.values()),
                host_launch_calls=calls,
                top_device_ms=[[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top])


def graph_gate(torch, ops, model, cfg, prompt, n_tokens: int, run: str, control: bool = False,
               **kw) -> dict:
    """(z) on one served run: ``generate`` replaying its CUDA graphs against
    ``eager_route()`` on the same inputs and seed. Gates: greedy tokens
    equal; every decode step's logits equal, or within (r)'s bf16 bound
    ``SERVE_LOGIT_TOL`` (the difference recorded); the kernel launches
    equal (kernel 1's counted through the replays); at temperature 0.8 two
    graph runs draw the same tokens (equality with the eager route
    recorded). Each route's decode ms a token, the capture ms, one profiled
    step of each. With ``control``, a graph whose replays leave the cache's
    length where it was must fail the token gate."""
    import contextlib

    import repro_torch.serve.decode as decode_mod
    from repro_torch.serve import generate

    dev, B = prompt.device, prompt.shape[0]

    def go(eager=False, temperature=0.0, on_step=None, n=n_tokens):
        logits, t, st = [], {}, {}
        torch.cuda.synchronize()
        ops.reset_launches()
        with ops.eager_route() if eager else contextlib.nullcontext():
            toks = generate(model, cfg, prompt, n, gen=gen(torch, dev, SEED + 110),
                            temperature=temperature, timings=t, stats=st,
                            on_step=on_step or (lambda i, lg: logits.append(lg.clone())), **kw)
        return dict(tokens=toks, logits=logits, timings=t, stats=st, launches=dict(ops.LAUNCHES))

    g, e = go(), go(eager=True)
    check(g["stats"]["route"] == "graph" and e["stats"]["route"] == "eager"
          and g["stats"]["eager_steps"] == g["stats"]["refresh_steps"],
          f"(z) {run}: routes {g['stats']}, {e['stats']}")
    check(torch.equal(g["tokens"], e["tokens"]), f"(z) {run}: graph tokens differ from eager")
    bitwise = all(torch.equal(a, b) for a, b in zip(g["logits"], e["logits"]))
    diffs = [err(a, b) for a, b in zip(g["logits"], e["logits"])]
    worst_abs, worst_rel = max(d[0] for d in diffs), max(d[1] for d in diffs)
    check(bitwise or worst_rel <= SERVE_LOGIT_TOL,
          f"(z) {run}: graph logits rel err {worst_rel} > {SERVE_LOGIT_TOL}")
    check(g["launches"] == e["launches"],
          f"(z) {run}: launches {g['launches']} on the graphs, {e['launches']} eager")
    del g["logits"], e["logits"]
    s1, s2 = go(temperature=Z_TEMPERATURE), go(temperature=Z_TEMPERATURE)
    se = go(eager=True, temperature=Z_TEMPERATURE)
    check(torch.equal(s1["tokens"], s2["tokens"]),
          f"(z) {run}: two graph runs at temperature {Z_TEMPERATURE} differ")
    profiles = {name: step_profile(torch, lambda hook, eager=eager: go(
        eager=eager, on_step=hook, n=Z_PROFILE_STEP + 2), Z_PROFILE_STEP)
        for name, eager in (("graph", False), ("eager", True))}
    # the replayed step's idle share against the CUDA-event ms a plain or
    # fold step (the profiled step's own wall holds the profiler's start and
    # stop)
    busy = profiles["graph"]["device_busy_ms"]
    g_ms = decode_rate(g["timings"], g["stats"], B)["plain_fold_ms_per_token"]
    profiles["graph"]["idle_share_of_event_ms"] = (1 - busy / g_ms if isinstance(busy, float)
                                                   else "not measured")
    out = dict(run=run, arch=cfg.name, batch=B, prompt_len=prompt.shape[1], new_tokens=n_tokens,
               kv_compress=kw.get("kv_compress") is not None, timing="CUDA events",
               graph=decode_rate(g["timings"], g["stats"], B),
               eager=decode_rate(e["timings"], e["stats"], B),
               warmup_sync_debug_mode="error", tokens_equal=True,
               logits=dict(steps=len(diffs), bitwise_equal=bitwise, max_abs_err=worst_abs,
                           max_rel_err=worst_rel, tol=SERVE_LOGIT_TOL),
               launches_equal=True, launches=g["launches"],
               sampled=dict(temperature=Z_TEMPERATURE, graph_runs_equal=True,
                            equal_to_eager=torch.equal(s1["tokens"], se["tokens"]),
                            share_equal_to_eager=float((s1["tokens"] == se["tokens"])
                                                       .float().mean())),
               step_profile=profiles)
    if control:  # the graphs' replays of a step that undoes its length's advance
        real = decode_mod.decode_step

        def frozen(params, cfg_, cache, token, **kw_):
            res = real(params, cfg_, cache, token, **kw_)
            cache["length"].sub_(1)
            return res

        decode_mod.decode_step = frozen
        try:
            c = go()
        finally:
            decode_mod.decode_step = real
        same = torch.equal(c["tokens"], e["tokens"])
        check(not same, f"(z) {run}: a replay that never advances the length passes the gate")
        out["control_length_not_advanced"] = dict(
            tokens_equal=same, share_equal=float((c["tokens"] == e["tokens"]).float().mean()))
    emit("serve/z_decode_graph", **out)
    return out


def prefill_profile(torch, model, cfg, prompt, n_max: int, **kw) -> dict:
    """``torch.profiler`` over one ``prefill`` of ``prompt``: wall and
    device-busy ms, the idle share, device ops, the top kernels."""
    from repro_torch.models import prefill

    wall, busy, n_ops, top = device_profile(torch, lambda: prefill(model, cfg, prompt, n_max, **kw))
    return dict(wall_ms=wall, device_busy_ms=busy, device_idle_share=1 - busy / wall,
                device_ops=n_ops, top_device_ms=top)


def serve_convert_parts(torch, dense: dict, kc) -> dict:
    """The K half of a conversion in its parts, CUDA events around each
    (the profiler's post-processing of the ~10^5 launches of a whole
    conversion takes minutes): the stacked engine's init, its 64 panels,
    and finalize (batched QR, core solve and SVD) over all 1024 heads."""
    from repro_torch.core.svd import spsvd_stacked_finalize
    from repro_torch.serve.kv_compress import _fac_width, _stacked_init, _stream_stack

    hist = torch.stack([layer["k"] for layer in dense["layers"]])  # (L, B, n_max, KV, hd)
    Lr, B, n_max, KV, hd = hist.shape
    hist_T = hist.permute(0, 1, 3, 4, 2).reshape(Lr * B * KV, hd, n_max).float()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    state = _stacked_init(gen(torch, hist.device, SEED + 64), Lr * B * KV, hd, n_max, kc,
                          device=hist.device)
    ev[1].record()
    _stream_stack(state, hist_T, SERVE_S, kc)
    ev[2].record()
    spsvd_stacked_finalize(state, k=_fac_width(hd, kc))
    ev[3].record()
    torch.cuda.synchronize()
    return dict(heads=Lr * B * KV, init_ms=ev[0].elapsed_time(ev[1]),
                panels_ms=ev[1].elapsed_time(ev[2]), panels=SERVE_S // kc.panel,
                finalize_ms=ev[2].elapsed_time(ev[3]))


def serve_synthetic(torch, ops, dev, hd: int = 64) -> dict:
    """The reference's own bound on a rank-8 head batch (head_dim ``hd``, S
    2048, rank 16, oversample 4: every head's error < 0.05), and the stacked
    engine against a per-head loop on 4 of its heads: the stacked state with
    kernel 1, the per-head engines with the plain versions (``force_plain``)."""
    from repro_torch.core.svd import spsvd_stacked_finalize, spsvd_engine_finalize
    from repro_torch.serve import KVCompressionConfig, compress_head_batch, compression_error
    from repro_torch.serve.kv_compress import (_engine_init, _fac_width, _stacked_init,
                                               _stream_stack)
    from repro_torch.stream.engine import panel_update

    g = gen(torch, dev, SEED + 70)
    B, KV = SERVE_B, 8
    coef = torch.randn((B, KV, SERVE_S, 8), generator=g, device=dev)
    hist = coef @ torch.randn((B, KV, 8, hd), generator=g, device=dev)
    kc = KVCompressionConfig(rank=16, oversample=4, panel=128)
    errs = compression_error(hist, compress_head_batch(g, hist, kc))
    check(bool((errs < 0.05).all()), f"rank-8 heads: largest error {float(errs.max())} >= 0.05")
    kc = KVCompressionConfig(**SERVE_KC)
    hist_T = hist[0, :4].transpose(1, 2).contiguous()  # (4, hd, S)
    stacked = _stacked_init(g, 4, hd, SERVE_S, kc, device=dev)
    _stream_stack(stacked, hist_T, SERVE_S, kc)
    U, S, V = spsvd_stacked_finalize(stacked)
    worst = {"C": 0.0, "R": 0.0, "M": 0.0, "sigma": 0.0, "reconstruction": 0.0}
    with ops.force_plain():
        for i in range(4):
            h = _engine_init(None, hd, SERVE_S, kc, sketches=stacked.sk.head(i), device=dev)
            for off in range(0, SERVE_S, kc.panel):
                panel_update(h, hist_T[i, :, off : off + kc.panel])
            u, sig, v = spsvd_engine_finalize(h)
            for key, got, want in (("C", stacked.C[i], h.C), ("R", stacked.R[i], h.R),
                                   ("M", stacked.M[i], h.M), ("sigma", S[i], sig),
                                   ("reconstruction", (U[i] * S[i]) @ V[i].T, (u * sig) @ v.T)):
                worst[key] = max(worst[key], err(got, want)[1])
    check(max(worst.values()) <= 1e-5, f"stacked engine against the per-head loop: {worst}")
    return dict(rank8_max_error=float(errs.max()), rank8_heads=int(errs.numel()),
                stacked_vs_per_head_rel_err=worst, fac_width=_fac_width(hd, kc), head_dim=hd)


def phase_serve(torch, ops, dev) -> list:
    """(r) dense and (s) compressed serving of llama3.2-1b at full width:
    ``generate`` over 8 requests of 2048 seeded tokens, 64 greedy tokens.
    Launch counts are reset just before and read just after each
    ``generate``; its timings are CUDA events."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_cache, init_params, param_count, prefill
    from repro_torch.models.attention import plain_attention
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import KVCompressionConfig, cache_nbytes, compress_prefill_cache, generate

    cfg = get_arch(SERVE_ARCH).full_config()
    t0 = time.perf_counter()
    model = init_params(gen(torch, dev, SEED + 60), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)
    check(1.2e9 < n_params < 1.3e9, f"llama3.2-1b has {n_params} parameters")
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S), generator=gen(torch, dev, SEED + 61),
                           device=dev)
    n_max = SERVE_S + SERVE_T
    # a short run of each path first (module loads, cuBLAS/cuSOLVER handles),
    # and one full-size prefill (the allocator's pool, the products' plans)
    generate(model, cfg, prompt[:2, :256], 9, kv_compress=KVCompressionConfig(**SERVE_KC))
    generate(model, cfg, prompt[:2, :256], 2)
    prefill(model, cfg, prompt, n_max)
    launched = []

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # the weights and what earlier phases hold
    ops.reset_launches()
    t_r, st_r = {}, {}
    toks_r = generate(model, cfg, prompt, SERVE_T, timings=t_r, stats=st_r)
    launched.append(dict(ops.LAUNCHES))
    peak_r = (torch.cuda.max_memory_allocated() - resident) / 2**30
    check(toks_r.shape == (SERVE_B, SERVE_T) and int(toks_r.min()) >= 0
          and int(toks_r.max()) < cfg.vocab_size, "(r): tokens out of range")
    dense_bytes = cache_nbytes(init_cache(cfg, SERVE_B, n_max, device=dev))
    lg_sdpa, _ = prefill(model, cfg, prompt[:1], n_max)
    with plain_attention():
        lg_plain, _ = prefill(model, cfg, prompt[:1], n_max)
    check(bool(torch.isfinite(lg_sdpa).all()), "(r): non-finite logits")
    e_abs, e_rel = err(lg_sdpa, lg_plain)
    check(e_rel <= SERVE_LOGIT_TOL, f"(r): SDPA prefill logits rel err {e_rel} > {SERVE_LOGIT_TOL}")
    rate_r = decode_rate(t_r, st_r, SERVE_B)
    decode_ms = rate_r["decode_ms_per_token"]
    emit("serve/r_dense", arch=cfg.name, params=n_params, dtype=cfg.dtype, init_s=init_s,
         batch=SERVE_B, prompt_len=SERVE_S, new_tokens=SERVE_T, prefill_ms=t_r["prefill"],
         **rate_r, timing="CUDA events around prefill and the decode loop",
         peak_mem_over_resident_gib=peak_r, resident_gib=resident / 2**30,
         cache_nbytes=dense_bytes, launches=launched[-1],
         prefill_logits_vs_plain_attention=dict(max_abs_err=e_abs, rel_err=e_rel,
                                                tol=SERVE_LOGIT_TOL, request=0))
    del lg_sdpa, lg_plain
    _, cache = prefill(model, cfg, prompt, n_max)
    emit("profile/r_decode_8_steps", **serve_profile(torch, model, cfg, cache, toks_r))
    del cache
    graph_gate(torch, ops, model, cfg, prompt, SERVE_T, "r", control=True)
    check(torch.equal(generate(model, cfg, prompt, SERVE_T), toks_r),
          "(r): a second run's tokens differ")

    dp, every = SERVE_KC["decode_panel"], SERVE_KC["refresh_every"]
    n_folds = (SERVE_T - 1) // dp  # per layer, over the decode steps
    n_refresh = n_folds * dp // every
    per_conv = 2 * (SERVE_S // SERVE_KC["panel"] * 4 + 2)  # K and V: 4 per panel, 2 at finalize
    per_fold, per_refresh = 2 * 4, 2 * 2
    for adaptive in (False, True):
        mode = "adaptive" if adaptive else "uniform"
        kc = KVCompressionConfig(**SERVE_KC, adaptive=adaptive)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ops.reset_launches()
        t_s, st_s = {}, {}
        toks = generate(model, cfg, prompt, SERVE_T, gen=gen(torch, dev, SEED + 62),
                        kv_compress=kc, timings=t_s, stats=st_s)
        launched.append(dict(ops.LAUNCHES))
        peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        total = launched[-1]["countsketch_batched"]
        want = per_conv + cfg.n_layers * (n_folds * per_fold + n_refresh * per_refresh)
        check(total == want, f"(s) {mode}: kernel 1 launched {total} times, want {want}")
        # the conversion again, alone: its launches at N = 1024 heads and at
        # N = 128 (one request), the factors against the histories
        _, dense = prefill(model, cfg, prompt, n_max)
        _, dense1 = prefill(model, cfg, prompt[:1], n_max)
        ops.reset_launches()
        comp1 = compress_prefill_cache(gen(torch, dev, SEED + 63), cfg, dense1, kc)
        conv_1 = ops.LAUNCHES["countsketch_batched"]
        del comp1, dense1
        ops.reset_launches()
        comp = compress_prefill_cache(gen(torch, dev, SEED + 63), cfg, dense, kc)
        conv_n = ops.LAUNCHES["countsketch_batched"]
        check(conv_n == conv_1 == per_conv,
              f"(s) {mode}: conversion launches {conv_n} (N = 1024), {conv_1} (N = 128)")
        errs, opts = serve_errors(torch, cfg, dense, comp)
        check(bool((errs >= opts * (1 - OPT_SLACK)).all()),
              f"(s) {mode}: a head beats its optimal error")
        ratio = errs / opts
        reg = MetricsRegistry()
        reg.record_kv_compression(errs)
        comp_bytes = cache_nbytes(comp)
        if not adaptive:  # where the time goes: the conversion, and 8 steps with one fold
            emit("profile/s_convert", **serve_convert_parts(torch, dense, kc))
            emit("profile/s_decode_8_steps", **serve_profile(torch, model, cfg, comp, toks, kc))
        emit(f"serve/s_compressed_{mode}", kc=dict(SERVE_KC, adaptive=adaptive),
             heads=int(errs.numel()), convert_ms=t_s["convert"], prefill_ms=t_s["prefill"],
             **decode_rate(t_s, st_s, SERVE_B), dense_decode_ms_per_token=decode_ms,
             folds_per_layer=n_folds, refreshes_per_layer=n_refresh,
             kernel1_launches=dict(generate=total, per_conversion=conv_n,
                                   per_conversion_one_request=conv_1,
                                   per_layer_fold=per_fold, per_layer_refresh=per_refresh),
             cache_nbytes=comp_bytes, dense_cache_nbytes=dense_bytes,
             compressed_over_dense=comp_bytes / dense_bytes,
             kv_rel_err=reg.histogram_summary("serve/kv_rel_err"),
             error_over_optimal=dict(min=float(ratio.min()), median=float(ratio.median()),
                                     max=float(ratio.max())),
             tokens_agree_with_dense=float((toks == toks_r).float().mean()),
             first_token_agrees=float((toks[:, 0] == toks_r[:, 0]).float().mean()),
             peak_mem_over_resident_gib=peak, launches=launched[-1])
        del comp, dense, errs, opts
        torch.cuda.empty_cache()
        check(torch.equal(generate(model, cfg, prompt, SERVE_T, gen=gen(torch, dev, SEED + 62),
                                   kv_compress=kc), toks),
              f"(s) {mode}: a second run's tokens differ")
        if not adaptive:
            graph_gate(torch, ops, model, cfg, prompt, SERVE_T, "s", kv_compress=kc)
    emit("serve/s_synthetic", **serve_synthetic(torch, ops, dev))
    del model
    torch.cuda.empty_cache()
    ts_ref = ts_references(torch, dev)
    TS_REF.parent.mkdir(parents=True, exist_ok=True)
    torch.save(ts_ref, TS_REF)
    return launched


def ts_references(torch, dev) -> dict:
    """What (ts)'s ranks are held to: one rank's runs of (r)'s model cut to
    its first ``TS_DEPTH`` layers (drawn from (r)'s seed: the embedding and
    those layers are (r)'s) on (r)'s requests — dense (tokens, margins,
    prefill's and each step's logits; run twice, the same tokens), sampled
    at (z)'s temperature, (s)'s compression uniform and adaptive (tokens,
    margins, the conversion's cache bytes), the dense cache's bytes and a
    replayed decode graph step's profile."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.serve import KVCompressionConfig, cache_nbytes, compress_prefill_cache, generate

    full = get_arch(SERVE_ARCH).full_config()
    cfg = dataclasses.replace(full, n_layers=TS_DEPTH, pattern=full.pattern[:TS_DEPTH])
    model = init_params(gen(torch, dev, SEED + 60), cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S), generator=gen(torch, dev,
                                                                               SEED + 61),
                           device=dev)
    n_max = SERVE_S + SERVE_T
    ref = dict(prompt=prompt.cpu(), depth=TS_DEPTH,
               r=ts_reference(torch, model, cfg, prompt, True),
               r_cache_nbytes=cache_nbytes(init_cache(cfg, SERVE_B, n_max, device=dev)),
               sampled_tokens=generate(model, cfg, prompt, SERVE_T,
                                       gen=gen(torch, dev, SEED + 110),
                                       temperature=Z_TEMPERATURE).cpu(),
               z_r=step_profile(torch, lambda hook: generate(
                   model, cfg, prompt, Z_PROFILE_STEP + 2, on_step=hook), Z_PROFILE_STEP))
    check(torch.equal(generate(model, cfg, prompt, SERVE_T).cpu(), ref["r"]["tokens"]),
          "(ts) one rank: a second run's tokens differ")
    for adaptive in (False, True):
        kc = KVCompressionConfig(**SERVE_KC, adaptive=adaptive)
        _, dense = prefill(model, cfg, prompt, n_max)
        comp = compress_prefill_cache(gen(torch, dev, SEED + 62), cfg, dense, kc)
        ref[f"s_{'adaptive' if adaptive else 'uniform'}"] = dict(
            ts_reference(torch, model, cfg, prompt, False, gen=gen(torch, dev, SEED + 62),
                         kv_compress=kc), cache_nbytes=cache_nbytes(comp))
        del dense, comp
    del model
    torch.cuda.empty_cache()
    return ref


def ts_margin(logits):
    """Each row's top-2 margin of ``logits`` (B, 1, V) over its largest |logit|, on the host."""
    lg = logits[:, 0].float()
    top = lg.topk(2, dim=-1).values
    return ((top[:, 0] - top[:, 1]) / lg.abs().amax(-1)).cpu()


def ts_reference(torch, model, cfg, prompt, keep_logits: bool, n_tokens: int = SERVE_T,
                 vision=None, **kw) -> dict:
    """A one-rank ``generate`` of (r) or (s) for (ts)'s gates (or of (hy)'s
    models, ``n_tokens`` and ``vision`` given): its tokens, prefill's last
    logits, and for each token the top-2 margin of the logits it was drawn
    from (prefill's, then each decode step's; (B, T)); with ``keep_logits``
    each decode step's logits, on the host."""
    from repro_torch.models import prefill
    from repro_torch.serve import generate

    lg0, _ = prefill(model, cfg, prompt, prompt.shape[1] + n_tokens, vision)
    margins, steps = [ts_margin(lg0)], []

    def hook(i, lg):
        margins.append(ts_margin(lg))
        if keep_logits:
            steps.append(lg.float().cpu())

    toks = generate(model, cfg, prompt, n_tokens, on_step=hook, vision=vision, **kw)
    out = dict(tokens=toks.cpu(), margins=torch.stack(margins, 1),
               prefill_logits=lg0.float().cpu())
    if keep_logits:
        out["logits"] = torch.stack(steps)
    return out


# position buckets of a request for the router inputs' spread (prefill)
COS_BUCKETS = ((0, 16), (16, 256), (256, 1024), (1024, SERVE_S))


def walk_stack(torch, blocks, specs, cfg, x, mix) -> tuple:
    """``x`` through the blocks as ``prefill`` and ``decode_step`` run them:
    ``mix(i, spec, block, x)`` runs block i's mixer half (its spec with no
    FFN) and returns the residual, then ``apply_ffn`` its FFN half. At each
    MoE layer ``route`` and ``dispatch_slots`` are called on the FFN's input
    itself: ``(x, [record per MoE layer])``, a record holding the experts,
    the kept mask, P, the capacity and, over a prompt, how close each
    token's input lies to its request's mean (cosine, by position bucket)."""
    from repro_torch.models.blocks import apply_ffn
    from repro_torch.models.config import MOE, NONE, BlockSpec
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.moe import dispatch_groups, dispatch_slots, route

    recs = []
    for i, (spec, block) in enumerate(zip(specs, blocks)):
        x = mix(i, BlockSpec(spec.mixer, NONE), block, x)
        if spec.ffn == MOE:
            u = rmsnorm(block.norm2, x, cfg.norm_eps)
            B, S, D = u.shape
            r = route(block.ffn, u.reshape(B * S, D), cfg)
            P, cap = dispatch_groups(B * S, cfg)
            _, keep = dispatch_slots(r.experts, P, cap, cfg.n_experts)
            rec = dict(layer=i, experts=r.experts, keep=keep, P=P, cap=cap, E=cfg.n_experts)
            if S > 1:
                cos = torch.nn.functional.cosine_similarity(
                    u.float(), u.float().mean(1, keepdim=True), dim=-1)
                rec["cos_to_request_mean"] = {f"[{a}, {b})": float(cos[:, a:b].mean())
                                              for a, b in COS_BUCKETS if b <= S}
            recs.append(rec)
        x, _ = apply_ffn(block, spec, cfg, x)
    return x, recs


def walk_generate(torch, model, cfg, prompt, toks, n_max: int, convert=None, kc=None,
                  logits_out=None) -> tuple:
    """``generate``'s greedy run again, block by block through
    :func:`walk_stack`, eagerly: the prompt, then a decode step on each of
    ``toks`` but the last (``convert`` turns the prefilled cache into the
    decode cache, as ``kv_compress=kc`` does; its steps take ``kc``'s
    phases). Returns the routing records of the prefill and of the decode
    steps, and the share of steps whose argmax is ``generate``'s next token
    (1 when the walk is the same computation). ``logits_out``, a list,
    receives the logits of prefill's last position and of each step (fp32,
    on the host)."""
    from repro_torch.models import layer_specs
    from repro_torch.models import blocks as blk
    from repro_torch.models.layers import embed_tokens, lm_logits, rmsnorm
    from repro_torch.serve import decode_schedule

    S, specs = prompt.shape[1], layer_specs(cfg)
    caches = [None] * len(specs)

    def pre(i, spec, block, x):
        x, caches[i] = blk.block_prefill(block, spec, cfg, x, n_max)
        return x

    def next_token(x):
        h = rmsnorm(model.final_norm, x[:, -1:], cfg.norm_eps)
        logits = lm_logits(model.embed, h, cfg)
        if logits_out is not None:
            logits_out.append(logits.float().cpu())
        return torch.argmax(logits, dim=-1).to(torch.int32)

    x, pre_recs = walk_stack(torch, model.blocks, specs, cfg,
                             embed_tokens(model.embed.tok, prompt), pre)
    agree = [torch.equal(next_token(x), toks[:, :1])]
    length = torch.full((), S, dtype=torch.int32, device=prompt.device)
    if convert is not None:
        caches[:] = convert({"layers": caches, "length": length})["layers"]
    dec_recs = []
    phases = decode_schedule(kc if convert is not None else None, toks.shape[1] - 1)
    for j, (phase, _) in enumerate(phases):
        def dec(i, spec, block, x, phase=phase):
            return blk.block_decode(block, spec, cfg, x, caches[i], length, phase=phase)

        x, recs = walk_stack(torch, model.blocks, specs, cfg,
                             embed_tokens(model.embed.tok, toks[:, j : j + 1]), dec)
        length.add_(1)
        dec_recs += recs
        agree.append(torch.equal(next_token(x), toks[:, j + 1 : j + 2]))
    return pre_recs, dec_recs, sum(agree) / len(agree)


def route_stats(torch, recs) -> dict:
    """Over routing records (one per MoE layer and pass): groups and
    capacity, the dropped share of assignments (all and per layer), and the
    largest expert load over the mean, over the whole batch and per group."""
    dropped = sum(int((~r["keep"]).sum()) for r in recs)
    total = sum(r["keep"].numel() for r in recs)
    load, group_load, per_layer = [], [], {}
    for r in recs:
        experts, P, E = r["experts"], r["P"], r["E"]
        counts = torch.bincount(experts.reshape(-1), minlength=E).float()
        load.append(float(counts.max() / counts.mean()))
        grp = torch.arange(P, device=experts.device).repeat_interleave(experts.numel() // P)
        gc = torch.bincount(grp * E + experts.reshape(-1), minlength=P * E).float()
        group_load.append(float(gc.max() / gc.mean()))
        d = per_layer.setdefault(r["layer"], [0, 0])
        d[0] += int((~r["keep"]).sum())
        d[1] += r["keep"].numel()
    return dict(layers=len(per_layer), passes=len(recs), groups=sorted({r["P"] for r in recs}),
                capacity=sorted({r["cap"] for r in recs}), assignments=total, dropped=dropped,
                dropped_share=dropped / total if total else 0.0,
                dropped_share_by_layer={i: d / n for i, (d, n) in per_layer.items()},
                load_max_over_mean=dict(max=max(load), mean=sum(load) / len(load)),
                group_load_max_over_mean=dict(max=max(group_load),
                                              mean=sum(group_load) / len(group_load)))


def routing_witness(torch, model, cfg, prompt, recs, n_max: int, dev) -> dict:
    """Why (t)'s prefill drops: at the first MoE layer, the bf16 run's
    dropped share and router-input spread beside (a) the same two layers
    in fp32 (the bf16 weights widened; TF32 off) and (b) i.i.d. Gaussian
    router inputs of the same shape. The CPU test
    ``test_full_width_router_input_and_drops_match_reference`` holds the
    fp32 router input and drops against the reference's."""
    import copy

    from repro_torch.models import blocks as blk
    from repro_torch.models import layer_specs
    from repro_torch.models.layers import embed_tokens
    from repro_torch.models.moe import dispatch_groups, dispatch_slots, route

    first = recs[0]
    i1 = first["layer"]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    blocks32 = [copy.deepcopy(b).float() for b in model.blocks[: i1 + 1]]
    x32 = embed_tokens(model.embed.tok, prompt).float()
    _, recs32 = walk_stack(torch, blocks32, layer_specs(cfg)[: i1 + 1], cfg32, x32,
                           lambda i, spec, b, x: blk.block_prefill(b, spec, cfg32, x, n_max)[0])
    del blocks32, x32
    torch.cuda.empty_cache()
    T, D = prompt.numel(), cfg.d_model
    u = torch.randn((T, D), generator=gen(torch, dev, SEED + 88), device=dev,
                    dtype=cfg.param_dtype)
    r = route(model.blocks[i1].ffn, u, cfg)
    P, cap = dispatch_groups(T, cfg)
    _, keep = dispatch_slots(r.experts, P, cap, cfg.n_experts)
    gauss = dict(layer=i1, experts=r.experts, keep=keep, P=P, cap=cap, E=cfg.n_experts)
    out = {}
    for name, rec in (("bf16", first), ("fp32", recs32[0]), ("gaussian_input", gauss)):
        st = route_stats(torch, [rec])
        out[name] = dict(dropped_share=st["dropped_share"],
                         group_load_max_over_mean=st["group_load_max_over_mean"]["max"],
                         cos_to_request_mean=rec.get("cos_to_request_mean"))
    out["fp32_experts_equal_bf16"] = float((recs32[0]["experts"] == first["experts"])
                                           .float().mean())
    out["layer"] = i1
    return out


def sdpa_backends(torch, cfg, dev) -> dict:
    """Which SDPA backends take MLA's prefill shapes (one request: Q, K of
    nope + rope = 192, V of 128), the one its dispatcher picks, and the
    device kernels three default calls run (``torch.profiler``)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    H, S = cfg.n_heads, SERVE_S
    g = gen(torch, dev, SEED + 90)
    qk = cfg.nope_head_dim + cfg.rope_head_dim
    q, k = (torch.randn((1, H, S, qk), generator=g, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    v = torch.randn((1, H, S, cfg.v_head_dim), generator=g, device=dev, dtype=torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    accepts = {}
    names = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")
    for b in (getattr(SDPBackend, n) for n in names if hasattr(SDPBackend, n)):
        try:
            with sdpa_kernel(b):
                sdpa(q, k, v, is_causal=True)
            accepts[b.name] = True
        except RuntimeError as e:
            accepts[b.name] = str(e).splitlines()[0][:120]
    torch.cuda.synchronize()
    def three():
        for _ in range(3):
            sdpa(q, k, v, is_causal=True)

    *_, top, _names = device_profile(torch, three, names=True)
    # the backend SDPA's dispatcher picks for these inputs, as it reports it
    chosen = SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True)).name
    check(accepts.get(chosen) is True, f"(t): SDPA picks {chosen}, which refused the shapes")
    return dict(shape=dict(q=list(q.shape), v=list(v.shape)), accepts=accepts,
                default=chosen, default_kernels=top)


def phase_deepseek(torch, ops, dev) -> list:
    """(t) deepseek-v2-lite at its full config, nothing cut: MLA with its
    latent cache, the capacity dispatch (``generate``'s default) over 8
    requests of 2048 seeded tokens, 64 greedy tokens; gates (1)-(4)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, param_count, prefill
    from repro_torch.models.attention import plain_attention
    from repro_torch.models.moe import dispatch_groups, dispatch_slots, moe_ffn, moe_ffn_dense
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import KVCompressionConfig, cache_nbytes, compress_prefill_cache, generate

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident_before = torch.cuda.memory_allocated()  # what earlier phases still hold
    cfg = get_arch(DEEPSEEK_ARCH).full_config()
    t0 = time.perf_counter()
    model = init_params(gen(torch, dev, SEED + 80), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)
    check(n_params == DEEPSEEK_PARAMS, f"(t): {n_params} parameters, want {DEEPSEEK_PARAMS}")
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                           generator=gen(torch, dev, SEED + 81), device=dev)
    n_max = SERVE_S + SERVE_T
    generate(model, cfg, prompt[:2, :256], 9)  # module loads, handles, plans
    _, cache = prefill(model, cfg, prompt, n_max)  # the allocator's pool at full size
    del cache

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ops.reset_launches()
    t_t, st_t = {}, {}
    toks = generate(model, cfg, prompt, SERVE_T, timings=t_t, stats=st_t)
    launched = dict(ops.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
    check(toks.shape == (SERVE_B, SERVE_T) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size, "(t): tokens out of range")
    # the dispatch statistics: generate's run again, block by block, each MoE
    # layer's routing taken on its input; the walk must give generate's tokens
    walk_logits = []
    pre_recs, dec_recs, walk_agree = walk_generate(torch, model, cfg, prompt, toks, n_max,
                                                   logits_out=walk_logits)
    check(walk_agree == 1.0, f"(t): the layer walk agrees with generate on {walk_agree} of steps")
    EP_SAVE["t"] = ep_one_rank(torch, prompt, toks, walk_logits, pre_recs, dec_recs,
                               layer=ep_layer_record(torch, model, cfg, prompt, n_max))
    del walk_logits
    pre, dec = route_stats(torch, pre_recs), route_stats(torch, dec_recs)
    n_moe = sum(spec.ffn == "moe" for spec in cfg.pattern)
    check(pre["layers"] == n_moe and pre["groups"] == [16] and pre["capacity"] == [120],
          f"(t): prefill dispatch {pre}")
    # gate (3): at T = 8 the dispatch takes one group of capacity 8, and an
    # expert gets at most one assignment per token, so nothing may drop
    check(dec["passes"] == n_moe * (SERVE_T - 1) and dec["groups"] == [1]
          and dec["capacity"] == [8] and dec["dropped"] == 0, f"(t): decode dispatch {dec}")
    witness = routing_witness(torch, model, cfg, prompt, pre_recs, n_max, dev)
    pre["cos_to_request_mean_by_layer"] = {r["layer"]: r["cos_to_request_mean"] for r in pre_recs}
    del pre_recs, dec_recs

    # gate (1): SDPA's prefill logits against the plain attention path's
    lg_sdpa, cache1 = prefill(model, cfg, prompt[:1], n_max)
    with plain_attention():
        lg_plain, _ = prefill(model, cfg, prompt[:1], n_max)
    check(bool(torch.isfinite(lg_sdpa).all()), "(t): non-finite logits")
    e_abs, e_rel = err(lg_sdpa, lg_plain)
    check(e_rel <= DEEPSEEK_LOGIT_TOL,
          f"(t): SDPA prefill logits rel err {e_rel} > {DEEPSEEK_LOGIT_TOL}")
    # the gate's power: the plain path with a wrong softmax scale, 1/sqrt(128)
    # (V's width) for 1/sqrt(192) -- q scaled by sqrt(192/128) in every layer,
    # RoPE being linear -- must fail it
    qk = cfg.nope_head_dim + cfg.rope_head_dim
    saved = [b.mixer.w_q.clone() for b in model.blocks]
    for b in model.blocks:
        b.mixer.w_q.mul_(math.sqrt(qk / cfg.v_head_dim))
    with plain_attention():
        lg_ctl, _ = prefill(model, cfg, prompt[:1], n_max)
    for b, w in zip(model.blocks, saved):
        b.mixer.w_q.copy_(w)
    c_abs, c_rel = err(lg_ctl, lg_sdpa)
    check(c_rel > DEEPSEEK_LOGIT_TOL,
          f"(t): a wrong MLA softmax scale passes gate (1): rel err {c_rel}")
    del lg_sdpa, lg_plain, lg_ctl, cache1, saved
    backends = sdpa_backends(torch, cfg, dev)

    # gate (2): at capacity_factor E/k a group's capacity is its token count,
    # so the dispatch is the dropless function; one MoE layer, 2 x 2048 tokens.
    # Each side rounds the k weighted expert outputs and their sum to bf16 at
    # other places: at most (k + 1) x 2^-8 of the largest entry
    moe_tol = (cfg.moe_top_k + 1) * 2.0 ** -8
    x = torch.randn((2, SERVE_S, cfg.d_model), generator=gen(torch, dev, SEED + 82), device=dev,
                    dtype=cfg.param_dtype)
    full = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    block = model.blocks[1].ffn
    got, r = moe_ffn(block, x, full)
    P, cap = dispatch_groups(2 * SERVE_S, full)
    _, keep = dispatch_slots(r.experts, P, cap, cfg.n_experts)
    check(cap == 2 * SERVE_S // P and bool(keep.all()), "(t): capacity E/k dropped an assignment")
    want, r_d = moe_ffn_dense(block, x, cfg)
    m_abs, m_rel = err(got, want)
    check(m_rel <= moe_tol, f"(t): moe_ffn at E/k against moe_ffn_dense: rel err {m_rel}")
    check(float(r.aux_loss()) == float(r_d.aux_loss()),
          "(t): aux loss differs between the MoE paths")
    del x, got, want, r, r_d, keep

    # gate (4): the compressed-cache conversion leaves MLA latents as they are
    _, cache = prefill(model, cfg, prompt, n_max)
    latent_bytes = cache_nbytes(cache["layers"])  # the latents, not the length counter
    check(latent_bytes == DEEPSEEK_LATENT_BYTES,
          f"(t): latent cache {latent_bytes} B, want {DEEPSEEK_LATENT_BYTES}")
    reg = MetricsRegistry()
    ops.reset_launches()
    comp = compress_prefill_cache(gen(torch, dev, SEED + 83), cfg, cache,
                                  KVCompressionConfig(**SERVE_KC), registry=reg)
    check(reg.counters.get("serve/kv_layers_converted", 0) == 0
          and ops.LAUNCHES["countsketch_batched"] == 0, "(t): an MLA layer was converted")
    check(all(c["latent"] is d["latent"] and torch.equal(c["latent"], d["latent"])
              for c, d in zip(comp["layers"], cache["layers"])), "(t): latents changed")
    del comp, cache
    emit("serve/t_deepseek", arch=cfg.name, params=n_params, dtype=cfg.dtype, init_s=init_s,
         batch=SERVE_B, prompt_len=SERVE_S, new_tokens=SERVE_T, dense_moe=False,
         prefill_ms=t_t["prefill"], **decode_rate(t_t, st_t, SERVE_B),
         timing="CUDA events around prefill and the decode loop",
         latent_cache_nbytes=latent_bytes, peak_mem_over_resident_gib=peak,
         resident_gib=resident / 2**30, resident_from_earlier_phases_gib=resident_before / 2**30,
         prefill_dispatch=pre, decode_dispatch=dec, launches=launched,
         prefill_logits_vs_plain_attention=dict(max_abs_err=e_abs, rel_err=e_rel,
                                                tol=DEEPSEEK_LOGIT_TOL, request=0,
                                                wrong_scale_control_rel_err=c_rel),
         routing_witness=witness, walk_agrees_with_generate=walk_agree,
         moe_capacity_ek_vs_dropless=dict(max_abs_err=m_abs, rel_err=m_rel, tol=moe_tol,
                                          tokens=2 * SERVE_S, layer=1),
         mla_sdpa=backends, latents_pass_through=True)
    _, cache = prefill(model, cfg, prompt, n_max)
    emit("profile/t_decode_8_steps", **serve_profile(torch, model, cfg, cache, toks))
    del cache
    graph_gate(torch, ops, model, cfg, prompt, SERVE_T, "t")
    del model
    torch.cuda.empty_cache()
    return [launched]


def phase_kimi(torch, ops, dev) -> list:
    """(u) kimi-k2 at full width, depth cut to its first two layers (one
    dense, one MoE): ``generate`` over 8 requests of 2048 seeded tokens, 32
    greedy tokens, with the dense KV cache and with the compressed one at
    (s)'s settings; kernel 1's stacked launch at head_dim 128."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_cache, init_params, param_count, prefill
    from repro_torch.serve import KVCompressionConfig, cache_nbytes, compress_prefill_cache, generate

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident_before = torch.cuda.memory_allocated()
    full = get_arch(KIMI_ARCH).full_config()
    cfg = dataclasses.replace(full, n_layers=KIMI_DEPTH, pattern=full.pattern[:KIMI_DEPTH])
    t0 = time.perf_counter()
    model = init_params(gen(torch, dev, SEED + 84), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)
    check(n_params == KIMI_PARAMS, f"(u): {n_params} parameters, want {KIMI_PARAMS}")
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                           generator=gen(torch, dev, SEED + 85), device=dev)
    n_max = SERVE_S + KIMI_T
    kc = KVCompressionConfig(**SERVE_KC)
    generate(model, cfg, prompt[:2, :256], 9, kv_compress=kc)
    _, cache = prefill(model, cfg, prompt, n_max)
    del cache

    runs, launched = {}, []
    for mode in ("dense", "compressed"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ops.reset_launches()
        t_u, st_u = {}, {}
        toks = generate(model, cfg, prompt, KIMI_T, gen=gen(torch, dev, SEED + 86),
                        kv_compress=kc if mode == "compressed" else None, timings=t_u,
                        stats=st_u)
        launched.append(dict(ops.LAUNCHES))
        check(toks.shape == (SERVE_B, KIMI_T) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size, f"(u) {mode}: tokens out of range")
        conv = None if mode == "dense" else (  # generate's conversion, from the same seed
            lambda c: compress_prefill_cache(gen(torch, dev, SEED + 86), cfg, c, kc))
        walk_logits = []
        pre_recs, dec_recs, walk_agree = walk_generate(torch, model, cfg, prompt, toks, n_max,
                                                       convert=conv, kc=kc,
                                                       logits_out=walk_logits)
        check(walk_agree == 1.0,
              f"(u) {mode}: the layer walk agrees with generate on {walk_agree} of steps")
        EP_SAVE[f"u_{mode}"] = ep_one_rank(torch, prompt, toks, walk_logits, pre_recs, dec_recs,
                                           keep_logits=mode == "dense",
                                           kernel1=launched[-1]["countsketch_batched"])
        del walk_logits
        runs[mode] = dict(prefill_ms=t_u["prefill"], convert_ms=t_u["convert"],
                          **decode_rate(t_u, st_u, SERVE_B),
                          peak_mem_over_resident_gib=(torch.cuda.max_memory_allocated()
                                                      - resident) / 2**30,
                          prefill_dispatch=route_stats(torch, pre_recs),
                          decode_dispatch=route_stats(torch, dec_recs),
                          launches=launched[-1], tokens=toks)
        del pre_recs, dec_recs
    dp = SERVE_KC["decode_panel"]
    n_folds = (KIMI_T - 1) // dp
    n_refresh = n_folds * dp // SERVE_KC["refresh_every"]
    per_stack = 2 * (SERVE_S // SERVE_KC["panel"] * 4 + 2)  # K and V of one layer
    per_conv = cfg.n_layers * per_stack  # each layer its own segment: one stack each
    want = per_conv + cfg.n_layers * (n_folds * 2 * 4 + n_refresh * 2 * 2)
    total = launched[1]["countsketch_batched"]
    check(launched[0]["countsketch_batched"] == 0, "(u) dense: kernel 1 launched")
    check(total == want, f"(u): kernel 1 launched {total} times, want {want}")
    check(runs["dense"]["decode_dispatch"]["dropped"] == 0
          and runs["compressed"]["decode_dispatch"]["dropped"] == 0, "(u): a decode drop")

    # the conversion alone: its launches, the factors against the histories
    _, dense = prefill(model, cfg, prompt, n_max)
    ops.reset_launches()
    comp = compress_prefill_cache(gen(torch, dev, SEED + 87), cfg, dense, kc)
    conv_n = ops.LAUNCHES["countsketch_batched"]
    check(conv_n == per_conv, f"(u): conversion launched kernel 1 {conv_n} times")
    errs, opts = serve_errors(torch, cfg, dense, comp)
    ratio = errs / opts
    check(bool((errs >= opts * (1 - OPT_SLACK)).all()), "(u): a head beats its optimal error")
    comp_bytes = cache_nbytes(comp)
    EP_SAVE["u_compressed"]["cache_nbytes"] = comp_bytes
    EP_SAVE["u_compressed"]["error_over_optimal"] = [float(ratio.min()), float(ratio.max())]
    dense_bytes = cache_nbytes(init_cache(cfg, SERVE_B, n_max, device=dev))
    toks_d, toks_c = runs["dense"].pop("tokens"), runs["compressed"].pop("tokens")
    emit("serve/u_kimi", arch=cfg.name, depth=KIMI_DEPTH, full_depth=full.n_layers,
         params=n_params, dtype=cfg.dtype, init_s=init_s, batch=SERVE_B, prompt_len=SERVE_S,
         new_tokens=KIMI_T, kc=SERVE_KC, head_dim=cfg.head_dim,
         heads_per_stack=SERVE_B * cfg.n_kv_heads, timing="CUDA events", runs=runs,
         kernel1_launches=dict(generate=total, per_conversion=conv_n, per_stack=per_stack,
                               per_layer_fold=2 * 4, folds_per_layer=n_folds,
                               refreshes_per_layer=n_refresh),
         cache_nbytes=comp_bytes, dense_cache_nbytes=dense_bytes,
         compressed_over_dense=comp_bytes / dense_bytes, heads=int(errs.numel()),
         kv_rel_err=dict(min=float(errs.min()), median=float(errs.median()),
                         max=float(errs.max())),
         error_over_optimal=dict(min=float(ratio.min()), median=float(ratio.median()),
                                 max=float(ratio.max())),
         tokens_agree_with_dense=float((toks_c == toks_d).float().mean()),
         resident_gib=resident_before / 2**30)
    del comp, dense, errs, opts
    graph_gate(torch, ops, model, cfg, prompt, KIMI_T, "u", kv_compress=kc)
    del model
    torch.cuda.empty_cache()
    emit("serve/u_synthetic", **serve_synthetic(torch, ops, dev, hd=cfg.head_dim))
    return launched


def serve_run(torch, ops, model, cfg, prompt, n_tokens: int, **kw) -> dict:
    """One ``generate`` over ``prompt``, its launch counts reset just before
    and read just after: the tokens, the CUDA-event phase times, the
    launches and the peak memory above what was resident."""
    from repro_torch.serve import generate

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ops.reset_launches()
    t, st = {}, {}
    toks = generate(model, cfg, prompt, n_tokens, timings=t, stats=st, **kw)
    launched = dict(ops.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
    check(toks.shape == (prompt.shape[0], n_tokens) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size, f"{cfg.name}: tokens out of range")
    return dict(tokens=toks, launches=launched, prefill_ms=t["prefill"], convert_ms=t["convert"],
                **decode_rate(t, st, prompt.shape[0]), peak_mem_over_resident_gib=peak)


def scan_gate(torch, cfg, dev) -> dict:
    """(v) gate (1): one full-width Mamba-2 layer in fp32, its chunked
    ``mamba2_forward`` over 8 requests of 2048 tokens against
    ``mamba2_decode`` stepped token by token from ``init_mamba2_state`` over
    the same inputs (two forms of one recurrence): y and the final state."""
    from repro_torch.models.ssm import Mamba2, init_mamba2_state, mamba2_decode, mamba2_forward

    f32 = dataclasses.replace(cfg, dtype="float32")
    g = gen(torch, dev, SEED + 92)
    layer = Mamba2(g, f32, dev)
    x = torch.randn((SERVE_B, SERVE_S, cfg.d_model), generator=g, device=dev)
    y, (_, _, st) = mamba2_forward(layer, x, f32)
    state = init_mamba2_state(f32, SERVE_B, dev)
    ys = torch.empty_like(y)
    for t in range(SERVE_S):
        ys[:, t : t + 1], state = mamba2_decode(layer, x[:, t : t + 1], f32, *state)
    check(bool(torch.isfinite(y).all() and torch.isfinite(st).all()), "(v): non-finite scan")
    e_y, e_s = err(ys, y), err(state[2], st)
    check(e_y[1] <= SCAN_TOL and e_s[1] <= SCAN_TOL,
          f"(v) gate (1): chunked against stepped, y rel {e_y[1]}, state rel {e_s[1]}")
    return dict(requests=SERVE_B, tokens=SERVE_S, chunk=cfg.ssm_chunk, dtype="float32",
                y=dict(max_abs_err=e_y[0], rel_err=e_y[1]),
                state=dict(max_abs_err=e_s[0], rel_err=e_s[1]), tol=SCAN_TOL)


def phase_mamba(torch, ops, dev) -> list:
    """(v) mamba2-1.3b at its full config, nothing cut: ``generate`` over 8
    requests of 2048 seeded tokens, 64 greedy tokens; the decode state's
    bytes; gates (1) the chunked scan against the recurrence, (2) decode
    after prefill against a longer prefill."""
    from repro_torch.configs import get_arch
    from repro_torch.models import decode_step, init_cache, init_params, param_count, prefill
    from repro_torch.serve import cache_nbytes, generate

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident_before = torch.cuda.memory_allocated()
    cfg = get_arch(MAMBA_ARCH).full_config()
    t0 = time.perf_counter()
    model = init_params(gen(torch, dev, SEED + 93), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)
    check(n_params == MAMBA_PARAMS, f"(v): {n_params} parameters, want {MAMBA_PARAMS}")
    g = gen(torch, dev, SEED + 94)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S + 1), generator=g, device=dev)
    n_max = SERVE_S + SERVE_T
    generate(model, cfg, prompt[:2, :256], 9)  # module loads, handles, plans
    _, cache = prefill(model, cfg, prompt[:, :SERVE_S], n_max)
    del cache

    run = serve_run(torch, ops, model, cfg, prompt[:, :SERVE_S], SERVE_T)
    toks = run.pop("tokens")
    # the state is O(1) in length: the prefilled cache, the zeroed one
    _, cache = prefill(model, cfg, prompt[:, :SERVE_S], n_max)
    state_bytes = cache_nbytes(cache["layers"])  # the states, not the length counter
    check(state_bytes == MAMBA_STATE_BYTES
          == cache_nbytes(init_cache(cfg, SERVE_B, 1, device=dev)["layers"]),
          f"(v): state {state_bytes} B, want {MAMBA_STATE_BYTES}")
    emit("profile/v_decode_8_steps", **serve_profile(torch, model, cfg, cache, toks))
    del cache
    emit("profile/v_prefill", **prefill_profile(torch, model, cfg, prompt[:, :SERVE_S], n_max))

    # gate (2): decode after S tokens against the last logits of S + 1
    lg_s, cache = prefill(model, cfg, prompt[:, :SERVE_S], SERVE_S + 1)
    lg_d, _ = decode_step(model, cfg, cache, prompt[:, SERVE_S:])
    lg_l, _ = prefill(model, cfg, prompt, SERVE_S + 1)
    check(bool(torch.isfinite(lg_d).all() and torch.isfinite(lg_l).all()), "(v): non-finite logits")
    e_abs, e_rel = err(lg_d, lg_l)
    check(e_rel <= MAMBA_LOGIT_TOL, f"(v) gate (2): decode against prefill rel err {e_rel}")
    c_rel = err(lg_s, lg_l)[1]  # the gate's power: the position before must fail it
    check(c_rel > MAMBA_LOGIT_TOL, f"(v) gate (2): the previous position passes, {c_rel}")
    del cache, lg_s, lg_d, lg_l
    graph_gate(torch, ops, model, cfg, prompt[:, :SERVE_S], SERVE_T, "v")
    scan = scan_gate(torch, cfg, dev)
    emit("serve/v_mamba2", arch=cfg.name, params=n_params, dtype=cfg.dtype, init_s=init_s,
         batch=SERVE_B, prompt_len=SERVE_S, new_tokens=SERVE_T, chunk=cfg.ssm_chunk,
         timing="CUDA events around prefill and the decode loop", **run,
         state_nbytes=state_bytes, resident_from_earlier_phases_gib=resident_before / 2**30,
         scan_vs_recurrence=scan,
         decode_vs_longer_prefill=dict(max_abs_err=e_abs, rel_err=e_rel, tol=MAMBA_LOGIT_TOL,
                                       previous_position_rel_err=c_rel))
    del model
    torch.cuda.empty_cache()
    return [run["launches"]]


def phase_zamba(torch, ops, dev) -> list:
    """(w) zamba2-1.2b at its full config, nothing cut (Mamba-2 with one
    shared GQA at six positions): ``generate`` over (v)'s requests, dense
    and with (s)'s compressed cache, which converts no layer (the reference
    converts only ``ATTN``): zero conversions, zero kernel-1 launches,
    identical tokens; the cache's bytes by kind."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, layer_specs, param_count, prefill
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import KVCompressionConfig, cache_nbytes

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = get_arch(ZAMBA_ARCH).full_config()
    t0 = time.perf_counter()
    model = init_params(gen(torch, dev, SEED + 95), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)
    check(n_params == ZAMBA_PARAMS, f"(w): {n_params} parameters, want {ZAMBA_PARAMS}")
    names = [n for n, _ in model.named_parameters()]
    shared_idx = [i for i, s in enumerate(layer_specs(cfg)) if s.mixer == "shared_attn"]
    check(sum(n.startswith("shared.") for n in names) == 4 and not any(
        n.startswith(f"blocks.{i}.mixer.") for i in shared_idx for n in names),
        "(w): the shared GQA is not held once")
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S),
                           generator=gen(torch, dev, SEED + 96), device=dev)
    n_max = SERVE_S + SERVE_T
    kc = KVCompressionConfig(**SERVE_KC)
    serve_run(torch, ops, model, cfg, prompt[:2, :256], 9, kv_compress=kc)  # warm-up
    _, cache = prefill(model, cfg, prompt, n_max)
    kv_bytes = sum(cache_nbytes(c) for s, c in zip(layer_specs(cfg), cache["layers"])
                   if s.mixer == "shared_attn")
    ssm_bytes = sum(cache_nbytes(c) for s, c in zip(layer_specs(cfg), cache["layers"])
                    if s.mixer == "mamba2")
    check(kv_bytes == ZAMBA_KV_BYTES and ssm_bytes == ZAMBA_SSM_BYTES,
          f"(w): cache {kv_bytes} B shared K/V, {ssm_bytes} B Mamba-2 state")
    del cache

    dense = serve_run(torch, ops, model, cfg, prompt, SERVE_T)
    reg = MetricsRegistry()
    comp = serve_run(torch, ops, model, cfg, prompt, SERVE_T, kv_compress=kc, registry=reg)
    toks_d, toks_c = dense.pop("tokens"), comp.pop("tokens")
    converted = reg.counters.get("serve/kv_layers_converted", 0)
    check(converted == 0 and comp["launches"]["countsketch_batched"] == 0,
          f"(w): {converted} layers converted, kernel 1 launched "
          f"{comp['launches']['countsketch_batched']} times")
    check(torch.equal(toks_c, toks_d), "(w): compressed tokens differ from the dense run's")
    _, cache = prefill(model, cfg, prompt, n_max)
    emit("profile/w_decode_8_steps", **serve_profile(torch, model, cfg, cache, toks_d))
    del cache
    graph_gate(torch, ops, model, cfg, prompt, SERVE_T, "w")
    emit("profile/w_prefill", **prefill_profile(torch, model, cfg, prompt, n_max))
    emit("serve/w_zamba2", arch=cfg.name, params=n_params, dtype=cfg.dtype, init_s=init_s,
         batch=SERVE_B, prompt_len=SERVE_S, new_tokens=SERVE_T, shared_positions=shared_idx,
         timing="CUDA events around prefill and the decode loop", dense=dense,
         compressed=dict(comp, kc=SERVE_KC, layers_converted=converted,
                         tokens_identical_to_dense=True,
                         cache_nbytes_gauge=reg.gauges.get("serve/kv_cache_bytes")),
         shared_kv_nbytes=kv_bytes, mamba2_state_nbytes=ssm_bytes)
    del model
    torch.cuda.empty_cache()
    return [dense["launches"], comp["launches"]]


def cross_gate(torch, model, cfg, vision, dev) -> dict:
    """(x) gate (1): the first cross layer with ``gate = 1`` on one request
    (a seeded bf16 hidden state of 2048 tokens against the projected patch
    embeddings): SDPA against the plain einsum path, and the plain path
    with the kv heads tiled (query head h reading kv head h % KV, not
    h // (H/KV)), which must fail it; the backend SDPA's dispatcher picks
    for these shapes."""
    from torch.nn.attention import SDPBackend

    from repro_torch.models.attention import plain_attention
    from repro_torch.models.blocks import _cross_attend, _cross_kv

    i = next(i for i, s in enumerate(cfg.pattern) if s.mixer == "cross")
    mix = model.blocks[i].mixer
    saved = mix.gate.clone()
    mix.gate.fill_(1.0)
    x = torch.randn((1, SERVE_S, cfg.d_model), generator=gen(torch, dev, SEED + 97), device=dev,
                    dtype=cfg.param_dtype)
    vis = vision[:1].to(cfg.param_dtype) @ model.vision_proj
    k, v = _cross_kv(mix, vis, cfg)
    got = _cross_attend(mix, cfg, x, k, v)
    G = cfg.n_heads // cfg.n_kv_heads
    with plain_attention():
        want = _cross_attend(mix, cfg, x, k, v)
        tiled = _cross_attend(mix, cfg, x, k.repeat(1, 1, G, 1), v.repeat(1, 1, G, 1))
    mix.gate.copy_(saved)
    check(bool(torch.isfinite(got).all()), "(x): non-finite cross-attention")
    e_abs, e_rel = err(got, want)
    check(e_rel <= CROSS_TOL, f"(x) gate (1): SDPA cross layer rel err {e_rel} > {CROSS_TOL}")
    c_rel = err(tiled, got)[1]
    check(c_rel > CROSS_TOL, f"(x) gate (1): tiled kv heads pass it, rel err {c_rel}")
    q = (x @ mix.w_q).reshape(1, SERVE_S, cfg.n_heads, cfg.head_dim).transpose(1, 2)
    chosen = SDPBackend(torch._fused_sdp_choice(q, k.transpose(1, 2), v.transpose(1, 2),
                                                enable_gqa=True)).name
    return dict(layer=i, gate=1.0, request=0, max_abs_err=e_abs, rel_err=e_rel, tol=CROSS_TOL,
                tiled_heads_control_rel_err=c_rel, sdpa_backend=chosen)


def phase_vision(torch, ops, dev) -> list:
    """(x) llama-3.2-vision-90b at full width, depth cut to 10 (two [4 self
    + 1 cross] units, one scanned segment of 2 repeats): ``generate`` over
    (v)'s requests with 2048 synthetic patches of width 1280 each, 32
    greedy tokens, dense and with (s)'s compressed cache (kernel 1's
    stacked launch at 128 heads of head_dim 128); the cross gates set to
    0.5 (at init 0 a cross layer adds nothing); gates (1) a cross layer
    against its plain path, (2) each head's error over its optimum."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_cache, init_params, param_count, prefill, segments
    from repro_torch.models.modality import synth_patch_embeddings
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import KVCompressionConfig, cache_nbytes, compress_prefill_cache

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    full = get_arch(VISION_ARCH).full_config()
    cfg = dataclasses.replace(full, n_layers=VISION_DEPTH, pattern=full.pattern[:VISION_DEPTH])
    t0 = time.perf_counter()
    model = init_params(gen(torch, dev, SEED + 98), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)
    check(n_params == VISION_PARAMS, f"(x): {n_params} parameters, want {VISION_PARAMS}")
    cross = [b.mixer for b, s in zip(model.blocks, cfg.pattern) if s.mixer == "cross"]
    check(len(cross) == 2 and all(float(m.gate) == 0.0 for m in cross), "(x): cross gates at init")
    for m in cross:
        m.gate.fill_(0.5)
    g = gen(torch, dev, SEED + 99)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S), generator=g, device=dev)
    vision = synth_patch_embeddings(g, cfg, SERVE_B, dev)
    n_max = SERVE_S + VISION_T
    kc = KVCompressionConfig(**SERVE_KC)
    serve_run(torch, ops, model, cfg, prompt[:2, :256], 9, vision=vision[:2], kv_compress=kc)
    _, cache = prefill(model, cfg, prompt, n_max, vision)
    del cache

    runs = {}
    for mode in ("dense", "compressed"):
        runs[mode] = serve_run(torch, ops, model, cfg, prompt, VISION_T, vision=vision,
                               gen=gen(torch, dev, SEED + 100),
                               kv_compress=kc if mode == "compressed" else None)
    n_attn = sum(s.mixer == "attn" for s in cfg.pattern)
    n_pos = sum(s.mixer == "attn" for s in segments(cfg)[0].unit)
    dp = SERVE_KC["decode_panel"]
    n_folds = (VISION_T - 1) // dp
    n_refresh = n_folds * dp // SERVE_KC["refresh_every"]
    per_stack = 2 * (SERVE_S // SERVE_KC["panel"] * 4 + 2)  # K and V of one segment position
    per_conv = n_pos * per_stack
    want = per_conv + n_attn * (n_folds * 2 * 4 + n_refresh * 2 * 2)
    total = runs["compressed"]["launches"]["countsketch_batched"]
    check(runs["dense"]["launches"]["countsketch_batched"] == 0, "(x) dense: kernel 1 launched")
    check(total == want, f"(x): kernel 1 launched {total} times, want {want}")

    # the conversion alone: its launches, the cross caches passed through, gate (2)
    _, dense = prefill(model, cfg, prompt, n_max, vision)
    reg = MetricsRegistry()
    ops.reset_launches()
    comp = compress_prefill_cache(gen(torch, dev, SEED + 101), cfg, dense, kc, registry=reg)
    conv_n = ops.LAUNCHES["countsketch_batched"]
    check(conv_n == per_conv and reg.counters["serve/kv_layers_converted"] == n_attn,
          f"(x): conversion launched kernel 1 {conv_n} times")
    check(all(c is d for s, c, d in zip(cfg.pattern, comp["layers"], dense["layers"])
              if s.mixer == "cross"), "(x): a cross cache was converted")
    errs, opts = serve_errors(torch, cfg, dense, comp)
    ratio = errs / opts
    check(bool((errs >= opts * (1 - OPT_SLACK)).all()), "(x) gate (2): a head beats its optimum")
    comp_bytes = cache_nbytes(comp)
    dense_bytes = cache_nbytes(init_cache(cfg, SERVE_B, n_max, device=dev))
    del comp
    emit("profile/x_decode_8_steps", **serve_profile(torch, model, cfg, dense,
                                                      runs["dense"]["tokens"]))
    del dense
    emit("profile/x_prefill", **prefill_profile(torch, model, cfg, prompt, n_max, vision=vision))
    gate1 = cross_gate(torch, model, cfg, vision, dev)
    graph_gate(torch, ops, model, cfg, prompt, VISION_T, "x", vision=vision, kv_compress=kc)
    toks_d, toks_c = runs["dense"].pop("tokens"), runs["compressed"].pop("tokens")
    emit("serve/x_vision", arch=cfg.name, depth=VISION_DEPTH, full_depth=full.n_layers,
         params=n_params, dtype=cfg.dtype, init_s=init_s, batch=SERVE_B, prompt_len=SERVE_S,
         patches=cfg.n_patches, d_vision=cfg.d_vision, new_tokens=VISION_T, kc=SERVE_KC,
         cross_gates=0.5, heads_per_stack=2 * SERVE_B * cfg.n_kv_heads,
         timing="CUDA events", runs=runs,
         kernel1_launches=dict(generate=total, per_conversion=conv_n, per_stack=per_stack,
                               stacks=n_pos, per_layer_fold=2 * 4, folds_per_layer=n_folds,
                               refreshes_per_layer=n_refresh),
         cache_nbytes=comp_bytes, dense_cache_nbytes=dense_bytes,
         compressed_over_dense=comp_bytes / dense_bytes, heads=int(errs.numel()),
         kv_rel_err=dict(min=float(errs.min()), median=float(errs.median()),
                         max=float(errs.max())),
         error_over_optimal=dict(min=float(ratio.min()), median=float(ratio.median()),
                                 max=float(ratio.max())),
         tokens_agree_with_dense=float((toks_c == toks_d).float().mean()),
         cross_layer_vs_plain=gate1)
    del model, errs, opts
    torch.cuda.empty_cache()
    return [runs["dense"]["launches"], runs["compressed"]["launches"]]


def train_grads(torch, model, cfg, batch, remat=None) -> tuple:
    """``(loss, {name: gradient})`` of one step's loss (``make_loss_fn``)."""
    from repro_torch.train import make_loss_fn

    params = dict(model.named_parameters())
    loss, _ = make_loss_fn(cfg, remat=remat)(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def grads_rel_err(torch, got: tuple, want: tuple) -> float:
    """The larger of the loss's relative error and the largest relative
    Frobenius error of a gradient, ``got`` against ``want`` (loss, grads)."""
    worst = abs(got[0] - want[0]) / abs(want[0])
    for k, w in want[1].items():
        d = torch.linalg.vector_norm((got[1][k].float() - w.float()).ravel())
        worst = max(worst, float(d / torch.linalg.vector_norm(w.float().ravel()).clamp(min=1e-30)))
    return worst


def sdpa_train_backends(torch, cfg, dev) -> dict:
    """Which SDPA backends take the training attention's shapes (4 requests
    of 2048 tokens, GQA 32/8 of 64, bf16) forward and backward, causal and
    with a windowed boolean mask, both with ``enable_gqa``, and the one its
    dispatcher picks."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = gen(torch, dev, SEED + 111)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mk = lambda h: torch.randn((TRAIN_B, h, TRAIN_S, hd), generator=g, device=dev,  # noqa: E731
                               dtype=torch.bfloat16).requires_grad_()
    q, k, v = mk(H), mk(KV), mk(KV)
    pos = torch.arange(TRAIN_S, device=dev)
    window = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < 512)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for case, kw in (("causal", dict(is_causal=True)), ("window_mask", dict(attn_mask=window))):
        acc = {}
        for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"):
            if not hasattr(SDPBackend, name):
                continue
            try:
                with sdpa_kernel(getattr(SDPBackend, name)):
                    o = sdpa(q, k, v, enable_gqa=True, **kw)
                    torch.autograd.grad(o.float().sum(), (q, k, v))
                acc[name] = True
            except RuntimeError as e:
                acc[name] = str(e).splitlines()[0][:120]
        try:
            chosen = SDPBackend(torch._fused_sdp_choice(q, k, v, enable_gqa=True, **kw)).name
        except (RuntimeError, TypeError) as e:
            chosen = f"not reported: {str(e).splitlines()[0][:80]}"
        out[case] = dict(accepts=acc, default=chosen)
    torch.cuda.synchronize()
    return out


def train_gates(torch, cfg_full, dev, batch, other) -> dict:
    """(y)'s gates (1) and (2) at full width, depth 2: one step's loss and
    gradients through SDPA against the plain attention path (its control: a
    wrong softmax scale) and under each remat policy (its control: the
    gradients of another batch)."""
    from repro_torch.models import init_params
    from repro_torch.models.attention import plain_attention

    cfg = dataclasses.replace(cfg_full, n_layers=TRAIN_GATE_DEPTH,
                              pattern=cfg_full.pattern[:TRAIN_GATE_DEPTH])
    model = init_params(gen(torch, dev, SEED + 110), cfg, device=dev)
    sdpa = train_grads(torch, model, cfg, batch)
    with plain_attention():
        plain = train_grads(torch, model, cfg, batch)
    e_sdpa = grads_rel_err(torch, sdpa, plain)
    check(e_sdpa <= TRAIN_SDPA_TOL, f"(y) gate 1: SDPA's gradients rel err {e_sdpa} > "
          f"{TRAIN_SDPA_TOL}")
    # the control: q scaled by sqrt(2) in every layer, SDPA's scale 1/sqrt(32)
    # for 1/sqrt(64) (RoPE is linear)
    with torch.no_grad():
        saved = [b.mixer.w_q.clone() for b in model.blocks]
        for b in model.blocks:
            b.mixer.w_q.mul_(math.sqrt(2.0))
    ctl = train_grads(torch, model, cfg, batch)
    with torch.no_grad():
        for b, w in zip(model.blocks, saved):
            b.mixer.w_q.copy_(w)
    e_ctl = grads_rel_err(torch, ctl, plain)
    check(e_ctl > TRAIN_SDPA_TOL, f"(y) gate 1: a wrong softmax scale passes: {e_ctl}")
    del plain, ctl, saved
    remat = {}
    for policy in ("dots", "full"):
        remat[policy] = grads_rel_err(torch, train_grads(torch, model, cfg, batch, policy), sdpa)
        check(remat[policy] <= TRAIN_REMAT_TOL,
              f"(y) gate 2: remat={policy} rel err {remat[policy]} > {TRAIN_REMAT_TOL}")
    e_other = grads_rel_err(torch, train_grads(torch, model, cfg, other), sdpa)
    check(e_other > TRAIN_REMAT_TOL, f"(y) gate 2: another batch's gradients pass: {e_other}")
    out = dict(depth=TRAIN_GATE_DEPTH, sdpa_vs_plain_rel_err=e_sdpa, sdpa_tol=TRAIN_SDPA_TOL,
               wrong_scale_control_rel_err=e_ctl, remat_rel_err=remat, remat_tol=TRAIN_REMAT_TOL,
               other_batch_control_rel_err=e_other, loss=sdpa[0],
               sdpa_backends=sdpa_train_backends(torch, cfg, dev))
    del model, sdpa
    torch.cuda.empty_cache()
    return out


def train_run(torch, ops, step_fn, state, batches, resident: int) -> tuple:
    """Drive ``step_fn`` over the batches with the launch counts reset just
    before; ``(state, record, launches)``: each step's CUDA-event ms, loss,
    grad_norm and ``comp/*`` metrics, the median ms of steps 2.., tokens/s
    and the peak memory over ``resident`` (bytes held by earlier phases)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    steps = []
    ops.reset_launches()
    for i, batch in enumerate(batches):
        ev[0].record()
        state, metrics = step_fn(state, batch, i)
        ev[1].record()
        torch.cuda.synchronize()
        steps.append(dict(ms=ev[0].elapsed_time(ev[1]),
                          **{k: float(v) for k, v in metrics.items()}))
    launches = dict(ops.LAUNCHES)
    ms = median([x["ms"] for x in steps[1:]])
    rec = dict(step_ms_median=ms, tokens_per_s=TRAIN_B * TRAIN_S / ms * 1e3,
               peak_gib=(torch.cuda.max_memory_allocated() - resident) / 2**30,
               losses=[x["loss"] for x in steps], grad_norms=[x["grad_norm"] for x in steps],
               step_ms=[x["ms"] for x in steps], loss_fell=steps[-1]["loss"] < steps[0]["loss"])
    comp = sorted({k for k in steps[0] if k.startswith("comp/")})
    rec.update({k: [x[k] for x in steps] for k in comp})
    vals = rec["losses"] + rec["grad_norms"] + [v for k in comp for v in rec[k]]
    check(all(math.isfinite(v) for v in vals), f"(y) gate 3: non-finite metrics {rec}")
    return state, rec, launches


def compressed_step_profile(torch, cstep, state, batch, seed: int) -> dict:
    """``torch.profiler`` over one compressed step: device busy ms and ops,
    the idle share, and the device ms of the kernels that
    ``compressed_mean_grads`` launches (sketch draws, kernel 4, the outer
    products, ``fast_gmr_core``, the reconstruction, the EF update)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tsmod = importlib.import_module("repro_torch.train.train_step")
    real, tag = tsmod.compressed_mean_grads, "chip_smoke/compression"

    def wrapped(*args, **kwargs):
        with record_function(tag):
            return real(*args, **kwargs)

    tsmod.compressed_mean_grads = wrapped
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = cstep(state, batch, seed)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
    finally:
        tsmod.compressed_mean_grads = real
    dev_us = [(e.key, getattr(e, "self_device_time_total", 0.0), e.count)
              for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not e.key.startswith("stream/") and e.key != tag]
    dev_us = [x for x in dev_us if x[1] > 0]
    busy = sum(x[1] for x in dev_us) / 1e3
    # the device-side span of the tag and the device entries inside it
    on_dev = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    span = [e for e in on_dev if e.name == tag]
    comp_ms = span_ms = None
    if span:
        lo, hi = span[0].time_range.start, span[0].time_range.end
        span_ms = (hi - lo) / 1e3
        comp_ms = sum(e.time_range.end - e.time_range.start for e in on_dev
                      if e.name != tag and not e.name.startswith("stream/")
                      and lo <= e.time_range.start and e.time_range.end <= hi) / 1e3
    top = sorted(dev_us, key=lambda x: -x[1])[:10]
    return dict(wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
                device_ops=sum(x[2] for x in dev_us), compression_device_ms=comp_ms,
                compression_device_span_ms=span_ms,
                compression_share_of_busy=None if comp_ms is None else comp_ms / busy,
                top=[[k[:60], us / 1e3, n] for k, us, n in top]), state


Y_CLI: dict = {}  # (y) gate (5)'s CLI process, run beside (hy)


def start_train_cli() -> None:
    """(y) gate (5): the training CLI at depth 2 on (y)'s batch shape and
    llama3.2-1b's vocabulary, compressed, a crash injected at step 3; a checkpoint
    every 3 steps under ``build/``. It runs in its own process beside (hy)
    (its work is the card's and the disk's, (hy)'s the host's collectives),
    finished by :func:`finish_train_cli` (the time limit)."""
    ckpt = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--layers",
           str(TRAIN_GATE_DEPTH), "--dtype", "bfloat16", "--batch", str(TRAIN_B), "--seq",
           str(TRAIN_S), "--steps", "6", "--grad-compress", "--fail-at-step", "3", "--ckpt-every", "3",
           "--ckpt-dir", str(ckpt)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    Y_CLI.update(cmd=cmd, ckpt=ckpt, t0=time.perf_counter(),
                 proc=subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True))


def finish_train_cli() -> dict:
    """Wait for (y) gate (5)'s CLI and check it: one restart, 6 steps."""
    cli = dict(Y_CLI)
    Y_CLI.clear()
    proc = cli["proc"]
    try:
        out, errs = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
        shutil.rmtree(cli["ckpt"], ignore_errors=True)
    wall = time.perf_counter() - cli["t0"]
    lines = [ln for ln in out.splitlines() if ln.startswith("[train]")]
    check(proc.returncode == 0, f"(y) gate 5: the CLI exited {proc.returncode}: {errs[-2000:]}")
    done = lines[-1] if lines else ""
    check("done: 6 steps" in done and "restarts=1" in done, f"(y) gate 5: {lines}")
    return dict(cmd=" ".join(cli["cmd"][1:]), wall_s=wall, lines=lines,
                beside="(hy): references and the ranks' job")


def phase_train(torch, ops, dev) -> list:
    """(y): llama3.2-1b's full config trained 8 steps, plain and compressed
    (a world of one rank), from one seeded initial state; gates (1)-(5) and
    kernel 4's launches (8 a compressed step)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.device import fold_in
    from repro_torch.models import init_params, param_count
    from repro_torch.train import (CompressionConfig, OptimizerConfig, compress, compression_ratio,
                                   decompress, init_opt_state, make_compressed_train_step,
                                   make_train_step)

    cfg = get_arch(TRAIN_ARCH).full_config()
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=TRAIN_B, seq_len=TRAIN_S,
                                  seed=SEED), device=dev)
    batches = [data.batch_at(i) for i in range(TRAIN_STEPS)]
    gates = train_gates(torch, cfg, dev, batches[0], batches[1])
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()  # what earlier phases still hold

    t0 = time.perf_counter()
    model = init_params(gen(torch, dev, SEED + 100), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)
    check(n_params == TRAIN_PARAMS, f"(y): {n_params} parameters")
    oc = OptimizerConfig(lr=TRAIN_LR, warmup_steps=min(20, TRAIN_STEPS // 10 + 1),
                         total_steps=TRAIN_STEPS)
    ccfg = CompressionConfig(**TRAIN_CCFG)
    ratio = compression_ratio(model, ccfg)
    check(ratio == TRAIN_RATIO, f"(y): compression_ratio {ratio} != the reference's {TRAIN_RATIO}")
    init = {k: v.detach().cpu() for k, v in model.named_parameters()}  # off the card

    def plain_step(s, b, i):
        return step(s, b)

    step = make_train_step(cfg, oc, remat="dots")
    state = {"params": model, "opt": init_opt_state(model, oc)}
    state, plain, launch_plain = train_run(torch, ops, plain_step, state, batches, resident)
    check(not any(launch_plain.values()), f"(y): the plain step launched {launch_plain}")
    # where a plain step's time goes: one more step under torch.profiler
    held = [state]
    wall, busy, n_ops, top = device_profile(torch, lambda: held.append(step(held.pop(), batches[0])[0]))
    plain["step_profile"] = dict(wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
                                 device_ops=n_ops, top=top)
    del state, held
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(init[k])
    del init
    torch.cuda.empty_cache()

    def compressed_step(s, b, i):
        return cstep(s, b, fold_in(9, i))

    cstep, init_err = make_compressed_train_step(cfg, oc, ccfg, remat="dots")
    state = {"params": model, "opt": init_opt_state(model, oc), "err": init_err(model)}
    state, comp, launched = train_run(torch, ops, compressed_step, state, batches, resident)
    profile, state = compressed_step_profile(torch, cstep, state, batches[0],
                                             fold_in(9, TRAIN_STEPS))
    check(launched["twoside_sketch"] == TRAIN_LEAVES * TRAIN_STEPS,
          f"(y): kernel 4 launched {launched['twoside_sketch']} times, not "
          f"{TRAIN_LEAVES * TRAIN_STEPS}")
    check(all(abs(r / TRAIN_RATIO - 1) <= 1e-6 for r in comp["comp/ratio"]),
          f"(y): comp/ratio {comp['comp/ratio']} != {TRAIN_RATIO}")
    del state, model
    torch.cuda.empty_cache()

    # gate (4): a rank-8 stacked gradient of w_up's shape reconstructs within
    # the reference's bound; a full-rank Gaussian one (the control) does not
    g = gen(torch, dev, SEED + 112)
    L, m, n = cfg.n_layers, cfg.d_model, cfg.d_ff
    recon = {}
    for name, G in (("rank_8", torch.matmul(torch.randn((L, m, 8), generator=g, device=dev),
                                           torch.randn((L, 8, n), generator=g, device=dev))),
                    ("full_rank_control", torch.randn((L, m, n), generator=g, device=dev))):
        Ghat = decompress(5, compress(5, G, ccfg), G.shape, ccfg)
        recon[name] = float(torch.linalg.vector_norm(G - Ghat) / torch.linalg.vector_norm(G))
        del G, Ghat
    check(recon["rank_8"] < TRAIN_RECON_TOL, f"(y) gate 4: rank-8 rel err {recon['rank_8']}")
    check(recon["full_rank_control"] > TRAIN_RECON_TOL,
          f"(y) gate 4: the full-rank control passes: {recon['full_rank_control']}")
    torch.cuda.empty_cache()
    start_train_cli()
    emit("train/y_llama_train", arch=TRAIN_ARCH, params=n_params, init_s=init_s,
         resident_from_earlier_phases_gib=resident / 2**30,
         batch=[TRAIN_B, TRAIN_S], steps=TRAIN_STEPS, remat="dots", optimizer=dataclasses.asdict(oc),
         plain=plain, compressed=dict(config=TRAIN_CCFG, compression_ratio=ratio, **comp),
         kernel4_launches=launched["twoside_sketch"], launches=launched,
         compressed_step_profile=profile, gates=dict(**gates, reconstruction=recon,
                                                     reconstruction_tol=TRAIN_RECON_TOL,
                                                     cli="train/y_cli"))
    return [launched]


class CollectiveCounter:
    """Wraps ``dist.all_reduce`` in a rank: calls, bytes and synchronised
    host ms by group name (``model``, ``data``; others ``world``)."""

    def __init__(self, torch, dist, groups: dict):
        self.torch, self.dist, self.real = torch, dist, dist.all_reduce
        self.names = {id(g): name for name, g in groups.items() if g is not None}
        self.reset()

    def reset(self) -> None:
        self.rec = {}

    def __call__(self, t, *args, group=None, **kwargs):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.real(t, *args, group=group, **kwargs)
        self.torch.cuda.synchronize()
        r = self.rec.setdefault(self.names.get(id(group), "world"), [0, 0, 0.0])
        r[0] += 1
        r[1] += t.numel() * t.element_size()
        r[2] += 1e3 * (time.perf_counter() - t0)
        return out

    def read(self) -> dict:
        return {k: dict(calls=c, bytes=b, ms=ms) for k, (c, b, ms) in self.rec.items()}


def tp_run(torch, ops, sh, mesh, cfg, kind: str, steps: int, ref: dict, counter, dev,
           seed: int = SEED + 100) -> dict:
    """One (tp) or (ep) training run on this rank: the initial model of
    ``seed`` ((y)'s, or (ep)'s one-rank run's), this rank's blocks drawn leaf
    by leaf; step 1's gradients and loss (``control``: with
    ``reduce_from_tp``'s backward all-reducing again, in them and in the
    step; ``control_ce``: with ``cross_entropy``'s sum of exponentials over
    the model axis left out; ``control_gates``: the MoE gates not passed
    through ``copy_to_tp``; ``control_whole``: Mamba-2's whole tensors read
    without ``copy_to_tp``) against the one-rank run's, then ``steps`` steps
    of (y)'s batches (this rank's data-parallel share); each step's
    CUDA-event ms, metrics, collectives, kernel-4 launches and whether every
    replicated leaf is equal bit for bit on the model axis's ranks after
    it, step 1's parameters against the one-rank run's of the same kind."""
    import torch.distributed as dist

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.device import fold_in
    from repro_torch.models import init_params
    from repro_torch.train import (CompressionConfig, OptimizerConfig, init_opt_state,
                                   make_compressed_train_step, make_loss_fn, make_train_step)

    rules = sh.ParallelismRules().with_mesh(mesh)
    d, at = mesh.shape["data"], mesh.index("data")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=TRAIN_B, seq_len=TRAIN_S,
                                  seed=SEED), device=dev)
    share = TRAIN_B // d
    batches = [{k: v[at * share:(at + 1) * share] for k, v in data.batch_at(i).items()}
               for i in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(gen(torch, dev, seed), cfg, device=dev, mesh=mesh)
    torch.cuda.empty_cache()
    blocks = sh.tp_names(model, rules, mesh)

    @torch.no_grad()
    def sq_err(got: dict, which: str) -> dict:
        # |got - (y)'s block|^2 by leaf, (y)'s whole tensors read from the file
        out = {}
        for k, g in got.items():
            w = ref[which][k]
            w = sh.block(w, sh.tp_cut(sh.ref_path(k), w.shape, rules, mesh)).to(dev)
            out[k] = (float(torch.sum((g.double() - w.double()) ** 2)),
                      float(torch.sum(w.double() ** 2)))
        return out

    oc = OptimizerConfig(lr=TRAIN_LR, warmup_steps=min(20, TRAIN_STEPS // 10 + 1),
                         total_steps=TRAIN_STEPS)
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import train_step as ts

    from repro_torch.models import ssm as ssm_mod

    real_backward, real_reduce = sh._ReduceFromTP.backward, ts.reduce_from_tp
    real_copy, real_ssm_copy = moe_mod.copy_to_tp, ssm_mod.copy_to_tp
    if kind == "control_whole":
        # bc, dt, A, D and w_out skip copy_to_tp; the input to w_z, w_x keeps it
        ssm_mod.copy_to_tp = lambda x: (real_ssm_copy(x) if x.dim() == 3
                                        and x.shape[-1] == cfg.d_model else x)
    if kind == "control_gates":
        # the gates (T, k) skip copy_to_tp; the experts' input keeps it
        moe_mod.copy_to_tp = lambda x: x if x.shape[-1] == cfg.moe_top_k else real_copy(x)
    if kind == "control_ce":
        # cross_entropy sums over the model axis twice, the exponentials
        # first: leave that sum out, so each rank's softmax sees its block
        calls = itertools.count()
        ts.reduce_from_tp = lambda x: x if next(calls) % 2 == 0 else real_reduce(x)
    if kind == "control":
        def again(ctx, g):
            g = g.clone()
            dist.all_reduce(g, group=mesh.group("model"))
            return g, None

        sh._ReduceFromTP.backward = staticmethod(again)
    try:
        # step 1's loss and gradients (their data-parallel mean) against (y)'s
        named = dict(model.named_parameters())
        with sh.activation_sharding(mesh, rules):
            loss, _ = make_loss_fn(cfg, remat="dots")(model, batches[0])
            grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        loss0 = float(loss.detach())
        if d > 1:
            for g in grads.values():
                dist.all_reduce(g, group=mesh.group("data"))
                g.div_(d)
            lv = torch.tensor([loss0], device=dev)
            dist.all_reduce(lv, group=mesh.group("data"))
            loss0 = float(lv) / d
        grad_sq = sq_err(grads, "grads0")
        del grads, loss
        torch.cuda.empty_cache()

        state = {"params": model, "opt": init_opt_state(model, oc)}
        if kind == "compressed":
            cstep, init_err = make_compressed_train_step(cfg, oc, CompressionConfig(**TRAIN_CCFG),
                                                         mesh=mesh, remat="dots")
            state["err"] = init_err(model)
            step_fn = lambda s, b, i: cstep(s, b, fold_in(9, i))  # noqa: E731
        else:
            step = make_train_step(cfg, oc, remat="dots", mesh=mesh)
            step_fn = lambda s, b, i: step(s, b)  # noqa: E731
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        recs, update_sq = [], None
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            dist.barrier()
            counter.reset()
            ops.reset_launches()
            ev[0].record()
            state, metrics = step_fn(state, batch, i)
            ev[1].record()
            torch.cuda.synchronize()
            recs.append(dict(ms=ev[0].elapsed_time(ev[1]), collectives=counter.read(),
                             kernel4=ops.LAUNCHES["twoside_sketch"], launches=dict(ops.LAUNCHES),
                             **{k: float(v) for k, v in metrics.items()}))
            recs[-1]["whole_equal"] = whole_leaves_equal(torch, dist, mesh, named, blocks)
            if i == 0:
                update_sq = sq_err(named, "params1c" if kind == "compressed" else "params1")
    finally:
        sh._ReduceFromTP.backward, ts.reduce_from_tp = real_backward, real_reduce
        moe_mod.copy_to_tp, ssm_mod.copy_to_tp = real_copy, real_ssm_copy
    out = dict(kind=kind, steps=recs, loss0=loss0, grad_sq=grad_sq, update_sq=update_sq,
               blocks=sorted(blocks), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               tp_index=mesh.index("model"), dp_index=at)
    del state, model, step_fn
    torch.cuda.empty_cache()
    return out


def whole_leaves_equal(torch, dist, mesh, named: dict, blocks) -> bool:
    """Whether every leaf not cut over the model axis (``named`` less
    ``blocks``) is equal bit for bit on this rank and the model axis's rank
    0: each broadcast from that rank and compared."""
    group, src = mesh.group("model"), mesh.rank - mesh.index("model")
    same = True
    with torch.no_grad():
        for k, p in named.items():
            if k in blocks or group is None:
                continue
            t = p.detach().clone()
            dist.broadcast(t, src=src, group=group)
            same &= bool(torch.equal(t, p.detach()))
    return same


def tp_rank(rank: int, world: int, job: dict) -> dict:
    """One pool rank's (tp) job on the card: the runs of ``TP_RUNS`` at its
    mesh, then (``job["cli"]``) the training CLI in the same group."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    dev = torch.device("cuda")
    mesh = make_host_mesh(*job["mesh"])
    counter = CollectiveCounter(torch, dist, {"model": mesh.group("model"),
                                              "data": mesh.group("data")})
    dist.all_reduce = counter
    full = get_arch(TRAIN_ARCH).full_config()
    cfg = dataclasses.replace(full, n_layers=TP_DEPTH, pattern=full.pattern[:TP_DEPTH])
    ref = torch.load(TP_REF, mmap=True, map_location="cpu", weights_only=True)
    results = {}
    for kind, steps in TP_RUNS[job["mesh"]]:
        results[kind] = tp_run(torch, ops, sh, mesh, cfg, kind, steps, ref, counter, dev)
    del ref
    dist.all_reduce = counter.real
    if job.get("cli"):
        from repro_torch.launch.train import main as train_main

        t0 = time.perf_counter()
        rep = train_main(job["cli"])
        results["cli"] = dict(steps_run=rep.steps_run, restarts=rep.restarts,
                              losses=[float(x) for x in rep.losses],
                              wall_s=time.perf_counter() - t0)
    return results


def _tp_gates(name: str, per_rank: dict, ref: dict, kind: str, watch: tuple = ()) -> dict:
    """(tp)'s gates over one run's ranks, against (y)'s run of the same kind
    (or (ep)'s one-rank run): step 1's loss, the largest relative gradient
    error, grad_norm, every step's loss, step 1's update; a block counted
    once over the data axis, a replicated leaf once; the relative error of
    each leaf whose name holds a ``watch`` string. Returns the errors; a
    control must fail a gate (``control_gates`` the router gradient's), any
    other run pass them all."""
    first = per_rank[0]
    grad_d, grad_w, upd = {}, {}, {}
    for r in per_rank.values():
        if r["dp_index"]:
            continue
        for k, (dd, ww) in r["grad_sq"].items():
            if k in r["blocks"] or r["tp_index"] == 0:
                grad_d[k] = grad_d.get(k, 0.0) + dd
                grad_w[k] = grad_w.get(k, 0.0) + ww
        for k, (dd, _) in r["update_sq"].items():
            if k in r["blocks"] or r["tp_index"] == 0:
                upd[k] = upd.get(k, 0.0) + dd
    leaf = {k: math.sqrt(grad_d[k] / max(grad_w[k], 1e-300)) for k in grad_d}
    grad_err = max(leaf.values())
    worst_leaf = max(leaf, key=leaf.get)
    which = "compressed" if kind == "compressed" else "plain"
    upd_d, c = sum(upd.values()), "_c" if kind == "compressed" else ""
    ref_upd, ref_upd_leaf = ref[f"update_sq{c}"], ref[f"update_sq{c}_leaf"]
    losses = [x["loss"] for x in first["steps"]]
    errs = dict(loss0_rel_err=abs(first["loss0"] / ref["loss0"] - 1),
                grad_rel_err=grad_err, worst_grad_leaf=worst_leaf,
                grad_norm_rel_err=abs(first["steps"][0]["grad_norm"]
                                      / ref[f"{which}_grad_norms"][0] - 1),
                loss_rel_err=max(abs(a / b - 1) for a, b in zip(losses, ref[f"{which}_losses"])),
                update_rel_err=math.sqrt(upd_d / ref_upd),
                # where step 1's update error lies: the three leaves with the
                # largest share of it, each with its own relative error and
                # its share of the one-rank run's update
                update_by_leaf={k: dict(rel_err=math.sqrt(upd[k] / max(ref_upd_leaf[k], 1e-300)),
                                        share_of_error=upd[k] / max(upd_d, 1e-300),
                                        share_of_update=ref_upd_leaf[k] / ref_upd)
                                for k in sorted(upd, key=upd.get, reverse=True)[:3]})
    limits = dict(loss0_rel_err=TP_LOSS0_TOL, grad_rel_err=TP_GRAD_TOL,
                  grad_norm_rel_err=TP_GRAD_NORM_TOL, loss_rel_err=TP_LOSS_TOL,
                  update_rel_err=TP_UPDATE_TOL)
    failed = [k for k, tol in limits.items() if not errs[k] <= tol]
    errs["failed"] = failed
    if watch:
        errs["watched_grad_rel_err"] = {k: v for k, v in leaf.items() if any(w in k for w in watch)}
    if kind == "control_gates":
        router = max(v for k, v in leaf.items() if k.endswith("router"))
        errs["router_grad_rel_err"] = router
        check(router > TP_GRAD_TOL, f"(tp) {name}: the router gradient passes: {router}")
    elif kind.startswith("control"):
        check(failed, f"(tp) {name}: the control passes the gates: {errs}")
    else:
        check(not failed, f"(tp) {name}: {errs} (limits {limits})")
    if kind != "control_ce":  # there each rank's loss has its own softmax
        same = {tuple(x["loss"] for x in r["steps"]) for r in per_rank.values()}
        check(len(same) == 1, f"(tp) {name}: the ranks' losses differ: {same}")
    return errs


def phase_tp(torch, ops, dev, kernel4_tp: dict) -> list:
    """(tp): tensor parallelism of (y)'s model, llama3.2-1b at full width cut
    to ``TP_DEPTH`` layers, in gloo ranks spawned on this one card (NCCL
    cannot put two ranks of a group on one GPU; gloo stages the collectives
    through the host): 1x2 plain against one rank's plain steps of the same
    model and its two controls, 1x2 compressed against its compressed steps
    (only the model axis's sums act), 2x2 plain and compressed (the
    compressed step's data-axis bytes below the plain step's), then the CLI
    at --mesh 2x2 --grad-compress through a crash. The one-rank run's step-1
    gradients and parameters reach the ranks through a file (``TP_REF``),
    each rank reading its blocks. Returns the ranks' launches."""
    import gc

    from repro_torch.configs import get_arch

    gc.collect()
    torch.cuda.empty_cache()
    full = get_arch(TRAIN_ARCH).full_config()
    ref = train_reference(torch, ops, dev, dataclasses.replace(
        full, n_layers=TP_DEPTH, pattern=full.pattern[:TP_DEPTH]), SEED + 100, TP_REF,
        TRAIN_LEAVES, TP_RATIO, "tp")
    emit("train/tp_one_rank_reference", **ref["one_rank"])
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    ckpt = ROOT / "build" / "chip_smoke_tp_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    cli = ["--arch", TRAIN_ARCH, "--layers", str(TRAIN_GATE_DEPTH), "--dtype", "bfloat16",
           "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--steps", str(TP_CLI_STEPS),
           "--mesh", "2x2", "--grad-compress", "--fail-at-step", "3", "--ckpt-every", "2",
           "--ckpt-dir", str(ckpt)]
    launched, gates = [], {}
    try:
        for shape, runs in TP_RUNS.items():
            world = shape[0] * shape[1]
            if world == 4:  # the last mesh run: the two-rank pool's memory back first
                close_pool(2)
                free_gib = torch.cuda.mem_get_info()[0] / 2**30
                emit("train/tp_memory", parent_allocated_gib=resident / 2**30,
                     card_free_gib=free_gib)
                check(free_gib >= 4 * TP_RANK_GIB,
                      f"(tp): {free_gib} GiB free on the card; 2x2 needs 4 x {TP_RANK_GIB}")
            job = dict(mesh=shape, cli=cli if shape == (2, 2) else None)
            results, wall = host_s(torch, lambda: pool_run(torch, world, tp_rank, job))  # noqa: B023
            tag = f"{shape[0]}x{shape[1]}"
            for kind, steps in runs:
                per_rank = {r: results[r][kind] for r in range(world)}
                name = f"{tag}_{kind}"
                gates[name] = _tp_gates(name, per_rank, ref, kind)
                recs = [r["steps"] for r in per_rank.values()]
                k4 = [[x["kernel4"] for x in rs] for rs in recs]
                if kind == "compressed":
                    check(all(n == TRAIN_LEAVES for ks in k4 for n in ks),
                          f"(tp) {name}: kernel 4 launched {k4} a step, not {TRAIN_LEAVES}")
                    ratios = [x["comp/ratio"] for rs in recs for x in rs]
                    check(all(abs(r / TP_RATIO - 1) <= 1e-6 for r in ratios),
                          f"(tp) {name}: comp/ratio {ratios} != {TP_RATIO}")
                else:
                    check(not any(n for ks in k4 for n in ks), f"(tp) {name}: kernel 4 {k4}")
                if not kind.startswith("control"):
                    for rs in recs:
                        totals = {}
                        for x in rs:
                            for k, v in x["launches"].items():
                                totals[k] = totals.get(k, 0) + v
                        launched.append(totals)
                ms = [median([x["ms"] for x in rs[1:]] or [rs[0]["ms"]]) for rs in recs]
                coll = [x["collectives"] for x in recs[0]]
                coll_ms = [sum(v["ms"] for v in c.values()) for c in coll]
                emit(f"train/tp_{name}", mesh=list(shape), backend="gloo on one card",
                     steps=len(recs[0]), step_ms_median_per_rank=ms,
                     tokens_per_s=TRAIN_B * TRAIN_S / max(ms) * 1e3,
                     peak_gib_per_rank=[r["peak_gib"] for r in per_rank.values()],
                     losses=[x["loss"] for x in recs[0]],
                     grad_norms=[x["grad_norm"] for x in recs[0]],
                     comp={k: [x[k] for x in recs[0]] for k in recs[0][0] if k.startswith("comp/")},
                     collectives_per_step_rank0=coll,
                     collective_share_rank0=[c / x["ms"] for c, x in zip(coll_ms, recs[0])],
                     kernel4_launches_per_step=k4, gates=gates[name],
                     whole_leaves_equal_per_step=[[x["whole_equal"] for x in rs] for rs in recs],
                     limits=dict(loss0=TP_LOSS0_TOL, loss=TP_LOSS_TOL, grad=TP_GRAD_TOL,
                                 grad_norm=TP_GRAD_NORM_TOL, update=TP_UPDATE_TOL),
                     step_ms_rank0=[x["ms"] for x in recs[0]],
                     resident_parent_gib=resident / 2**30)
            if shape == (2, 2):
                dp = {kind: [x["collectives"].get("data", {}).get("bytes", 0)
                             for x in results[0][kind]["steps"]] for kind, _ in runs}
                check(0 < max(dp["compressed"]) < min(dp["plain"]),
                      f"(tp) 2x2: compressed data-axis bytes {dp['compressed']} not below "
                      f"plain {dp['plain']}")
                clis = [results[r]["cli"] for r in range(world)]
                check(all(c["restarts"] == 1 and c["steps_run"] == TP_CLI_STEPS + 1
                          and c["losses"][2] == c["losses"][3] for c in clis), f"(tp) CLI: {clis}")
                emit("train/tp_2x2_cli_and_wire", data_axis_bytes_per_step_rank0=dp,
                     compressed_over_plain=max(dp["compressed"]) / min(dp["plain"]),
                     cli=dict(argv=cli, per_rank=clis))
            emit(f"train/tp_{tag}_ranks", pool_job_s=wall)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        TP_REF.unlink(missing_ok=True)
    emit("train/tp_kernel4_blocks", **kernel4_tp)
    return launched


def ts_tokens_gate(toks, ref: dict, rows: slice, limit: float = TS_LOGIT_TOL) -> dict:
    """Gate 3: greedy tokens equal to the one-rank run's for each request up
    to the first token whose logits there had a top-2 margin below
    ``limit`` of their largest logit (where the roundings of another
    summation order may flip the argmax)."""
    got = toks.cpu()
    n = got.shape[1]  # a run may take fewer tokens than the one-rank run's
    want, margins = ref["tokens"][rows, :n], ref["margins"][rows, :n]
    small = margins < limit
    first = [int(row.nonzero()[0]) if bool(row.any()) else want.shape[1] for row in small]
    equal_before = all(bool((got[b, :k] == want[b, :k]).all()) for b, k in enumerate(first))
    return dict(first_small_margin_step=first, equal_before_it=equal_before,
                tokens_equal=int((got == want).sum()), tokens=int(got.numel()))


def ts_collectives(after: dict, before: dict, steps: int) -> dict:
    """A counter's calls, bytes and ms by axis between two readings, over ``steps``."""
    return {k: {f: (v[f] - before.get(k, {}).get(f, 0)) / steps for f in v}
            for k, v in after.items()}


def ts_run(torch, ops, sh, mesh, model, cfg, kind: str, ref: dict, counter, dev) -> dict:
    """One (ts) run on this rank under ``activation_sharding``: ``dense``
    (``generate``, then prefill's logits (gate 1) and (r)'s tokens through
    ``decode_step``, each step's logits (gate 2)), ``uniform`` / ``adaptive``
    (``generate`` with (s)'s compression from (s)'s seed, then a conversion
    alone: each head's error over its optimum, ``cache_nbytes``, the
    adaptive allocation), ``sampled`` (``generate`` at (z)'s temperature
    from (z)'s seed), or a control (``control_reduce``: ``_gqa_decode``
    without its ``reduce_from_tp``; ``control_gather``: the vocab's shards
    gathered in the wrong order). Launch counts are reset just before and
    read just after ``generate``."""
    import torch.distributed as dist

    from repro_torch.models import blocks, decode_step, prefill, transformer
    from repro_torch.serve import KVCompressionConfig, cache_nbytes, compress_prefill_cache, generate
    from repro_torch.serve import kv_cache

    d, di = mesh.shape["data"], mesh.index("data")
    m, mi = mesh.shape["model"], mesh.index("model")
    rows = slice(di * SERVE_B // d, (di + 1) * SERVE_B // d)
    prompt = sh.shard_batch(ref["prompt"].to(dev), mesh)
    n_max = SERVE_S + SERVE_T
    out = dict(kind=kind, dp_index=di, tp_index=mi)

    def forced(cache, n):  # (r)'s tokens through decode_step: each step's rel err, ms, collectives
        errs, ms, coll = [], [], []
        for t in range(n):
            before = counter.read()
            lg, t_s = host_s(torch, lambda: decode_step(  # noqa: B023
                model, cfg, cache, ref["r"]["tokens"][rows, t:t + 1].to(dev))[0])
            errs.append(err(lg, ref["r"]["logits"][t][rows].to(dev))[1])
            ms.append(1e3 * t_s)
            coll.append(ts_collectives(counter.read(), before, 1))
        return errs, ms, coll

    with sh.activation_sharding(mesh):
        if kind.startswith("control"):
            real_decode, real_gather = blocks._gqa_decode, transformer.gather_vocab

            def unreduced(*a, **kw):
                blocks.reduce_from_tp = lambda x: x
                try:
                    return real_decode(*a, **kw)
                finally:
                    blocks.reduce_from_tp = sh.reduce_from_tp

            def reversed_shards(logits):
                whole = real_gather(logits)
                return torch.cat(torch.chunk(whole, m, dim=-1)[::-1], dim=-1)

            if kind == "control_reduce":
                blocks._gqa_decode = unreduced
            else:
                transformer.gather_vocab = reversed_shards
            try:
                lg0, cache = prefill(model, cfg, prompt, n_max)
                out["prefill_rel_err"] = err(lg0, ref["r"]["prefill_logits"][rows].to(dev))[1]
                if kind == "control_reduce":
                    out["step_rel_err"] = forced(cache, TS_CONTROL_STEPS)[0]
            finally:
                blocks._gqa_decode, transformer.gather_vocab = real_decode, real_gather
            return out

        kc = (KVCompressionConfig(**SERVE_KC, adaptive=kind == "adaptive")
              if kind in ("uniform", "adaptive") else None)
        sampled = kind == "sampled"
        seed = SEED + 62 if kc else SEED + 110
        generate(model, cfg, prompt[:, :256], 9 if kc else 3, kv_compress=kc)  # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        counter.reset()
        ops.reset_launches()
        t, st = {}, {}
        toks = generate(model, cfg, prompt, SERVE_T, gen=gen(torch, dev, seed),
                        temperature=Z_TEMPERATURE if sampled else 0.0, kv_compress=kc,
                        timings=t, stats=st)
        torch.cuda.synchronize()
        out.update(launches=dict(ops.LAUNCHES), tokens=toks.cpu(), timings=t, stats=st,
                   rate=decode_rate(t, st, prompt.shape[0]), collectives=counter.read(),
                   peak_gib=(torch.cuda.max_memory_allocated() - resident) / 2**30,
                   resident_gib=resident / 2**30)
        if sampled:
            return out
        if kc is None:
            out["tokens_gate"] = ts_tokens_gate(toks, ref["r"], rows)
            counter.reset()
            (lg0, cache), pre_s = host_s(torch, lambda: prefill(model, cfg, prompt, n_max))
            out.update(prefill_rel_err=err(lg0, ref["r"]["prefill_logits"][rows].to(dev))[1],
                       prefill_host_ms=1e3 * pre_s, prefill_collectives=counter.read(),
                       cache_nbytes=cache_nbytes(cache))
            errs, ms, coll = forced(cache, SERVE_T - 1)
            out.update(step_rel_err=errs, forced_step_host_ms=median(ms),
                       forced_step_collectives=coll[len(coll) // 2],
                       collective_share=median([sum(v["ms"] for v in c.values()) / x
                                                for c, x in zip(coll, ms)]))
            del cache
            if d > 1 and m == 1:  # gate 6: one graph launch a replayed step, as (r)'s
                out["step_profile"] = step_profile(torch, lambda hook: generate(
                    model, cfg, prompt, Z_PROFILE_STEP + 2, on_step=hook), Z_PROFILE_STEP)
            return out
        out["tokens_gate"] = ts_tokens_gate(toks, ref[f"s_{kind}"], rows)
        # the conversion alone: each head against its optimum, the bytes, the allocation
        _, dense = prefill(model, cfg, prompt, n_max)
        spy, real_alloc = [], kv_cache._allocate_ranks

        def recorded(sigma, kc_):
            masked, alloc = real_alloc(sigma, kc_)
            spy.append((sigma.double().sum().item(), alloc.cpu(), masked))
            return masked, alloc

        kv_cache._allocate_ranks = recorded
        try:
            comp = compress_prefill_cache(gen(torch, dev, seed), cfg, dense, kc)
        finally:
            kv_cache._allocate_ranks = real_alloc
        errs, opts = serve_errors(torch, cfg, dense, comp)
        ratio = errs / opts
        out.update(heads=int(errs.numel()), error_over_optimal_min=float(ratio.min()),
                   error_over_optimal_max=float(ratio.max()),
                   beats_optimum=bool((errs < opts * (1 - OPT_SLACK)).any()),
                   cache_nbytes=cache_nbytes(comp))
        if kind == "adaptive":
            # each half's rank allocation (K, then V) over the gathered sigma:
            # this rank's block of it is what its factors keep
            out["allocation"] = []
            for (total, alloc, masked), name in zip(spy, ("k_fac", "v_fac")):
                sig = torch.cat([getattr(c, name).sigma for c in comp["layers"]])
                kv = sig.shape[1]
                mine = alloc[:, mi * kv:(mi + 1) * kv]
                out["allocation"].append(dict(
                    gathered_sum=total, alloc=alloc,
                    block_equal=bool(torch.equal((sig > 0).sum(-1).cpu().to(mine.dtype), mine)),
                    sigma_equal=bool(torch.equal(sig, masked[:, mi * kv:(mi + 1) * kv]))))
        del dense, comp
        torch.cuda.empty_cache()
    return out


def ts_rank(rank: int, world: int, job: dict) -> dict:
    """One pool rank's (ts) job on the card: (r)'s model drawn whole from its
    seed, then each mesh of ``TS_RUNS[world]`` in turn (its weights cut by
    ``shard_params``; a 2x1 mesh keeps them whole) and its runs, the model
    axis's and the data axis's all-reduces counted; then (``job["cli"]``)
    the serve CLI at ``TS_CLI`` in the same group."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params

    dev = torch.device("cuda")
    real = dist.all_reduce
    ref = torch.load(TS_REF, mmap=True, map_location="cpu", weights_only=True)
    full = get_arch(SERVE_ARCH).full_config()
    cfg = dataclasses.replace(full, n_layers=TS_DEPTH, pattern=full.pattern[:TS_DEPTH])
    results = {}
    with torch.no_grad():
        model = init_params(gen(torch, dev, SEED + 60), cfg, device=dev)
        for shape, kinds in TS_RUNS[world]:
            mesh = make_host_mesh(*shape)
            sh.shard_params(model, sh.ParallelismRules(), mesh)
            torch.cuda.empty_cache()
            counter = CollectiveCounter(torch, dist, {"model": mesh.group("model"),
                                                      "data": mesh.group("data")})
            dist.all_reduce = counter
            for kind in kinds:
                results[(shape, kind)] = ts_run(torch, ops, sh, mesh, model, cfg, kind, ref,
                                                counter, dev)
            dist.all_reduce = real
        del model, ref
        torch.cuda.empty_cache()
        if job.get("cli"):
            from repro_torch.launch.serve import main as serve_main

            out, wall = host_s(torch, lambda: serve_main(TS_CLI))
            results["cli"] = dict(tokens=out.cpu(), wall_s=wall)
    return results


def _ts_gates(name: str, per_rank: dict, ref: dict, kind: str, shape: tuple) -> dict:
    """(ts)'s gates over one run's ranks; returns what it read. A control
    must fail gate 1 (``control_gather``) or 2 (``control_reduce``)."""
    m = shape[1]
    groups = {}  # data index -> the model-axis group's tokens
    for r in per_rank.values():
        if "tokens" in r:
            groups.setdefault(r["dp_index"], []).append(r["tokens"])
    same = all(all(torch_equal(t, ts[0]) for t in ts) for ts in groups.values())
    if kind.startswith("control"):
        worst = max(max(r.get("step_rel_err", [0.0]) + [r["prefill_rel_err"] if kind ==
                                                           "control_gather" else 0.0])
                    for r in per_rank.values())
        check(worst > TS_LOGIT_TOL, f"(ts) {name}: the control passes: {worst} <= {TS_LOGIT_TOL}")
        return dict(control_rel_err=worst, limit=TS_LOGIT_TOL, failed=True)
    check(same, f"(ts) {name}: ranks of a model-axis group returned different tokens")  # gate 4
    out = dict(model_group_tokens_equal=same)
    if kind == "sampled":
        eq = [float((r["tokens"] == ref["sampled_tokens"][r["dp_index"] * len(r["tokens"]):(
            r["dp_index"] + 1) * len(r["tokens"])]).float().mean()) for r in per_rank.values()]
        out["share_equal_to_one_rank"] = eq
        return out
    gates = [r["tokens_gate"] for r in per_rank.values()]
    check(all(g["equal_before_it"] for g in gates), f"(ts) {name}: tokens differ: {gates}")
    out["tokens"] = gates
    if kind == "dense":
        pre = max(r["prefill_rel_err"] for r in per_rank.values())
        step = max(max(r["step_rel_err"]) for r in per_rank.values())
        check(pre <= TS_LOGIT_TOL and step <= TS_LOGIT_TOL,
              f"(ts) {name}: prefill logits {pre}, decode steps {step} > {TS_LOGIT_TOL}")
        out.update(prefill_rel_err=pre, step_rel_err=step, limit=TS_LOGIT_TOL)
        return out
    check(not any(r["beats_optimum"] for r in per_rank.values()),
          f"(ts) {name}: a head beats its optimal error")
    out["error_over_optimal"] = [min(r["error_over_optimal_min"] for r in per_rank.values()),
                                 max(r["error_over_optimal_max"] for r in per_rank.values())]
    if kind == "adaptive":
        for half in range(2):
            recs = [r["allocation"][half] for r in per_rank.values()]
            check(all(x["block_equal"] and x["sigma_equal"] for x in recs),
                  f"(ts) {name}: a rank's factors do not keep its block of the allocation")
            for r in per_rank.values():  # the ranks of a model-axis group allocate alike
                mates = [x for x in per_rank.values() if x["dp_index"] == r["dp_index"]]
                check(all(torch_equal(x["allocation"][half]["alloc"], r["allocation"][half][
                    "alloc"]) for x in mates), f"(ts) {name}: allocations differ in a group")
        out["allocation_blocks_equal"] = True
    return out


def torch_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def phase_ts(torch, ops, dev) -> list:
    """(ts): (r)'s model served under ``--mesh d x m`` in gloo ranks spawned
    on this one card (NCCL cannot put two ranks of a group on one GPU;
    gloo stages the collectives through the host): 2x1 dense on each rank's
    CUDA graphs, 1x2 dense, compressed uniform and adaptive, sampled and its
    two controls, 2x2 dense and compressed uniform, then the serve CLI at
    ``--mesh 1x2 --kv-compress 16`` in two ranks. (r)'s and (s)'s one-rank
    runs reach the ranks through ``TS_REF``, removed after. Returns the
    ranks' launches."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    emit("serve/ts_memory", parent_allocated_gib=resident / 2**30,
         card_free_gib=torch.cuda.mem_get_info()[0] / 2**30)
    ref = torch.load(TS_REF, mmap=True, map_location="cpu", weights_only=True)
    dp, every = SERVE_KC["decode_panel"], SERVE_KC["refresh_every"]
    n_folds = (SERVE_T - 1) // dp
    per_conv = 2 * (SERVE_S // SERVE_KC["panel"] * 4 + 2)  # as (s): constant in heads
    want_k1 = per_conv + TS_DEPTH * (n_folds * 2 * 4 + n_folds * dp // every * 2 * 2)
    launched = []
    try:
        for world in (2, 4):
            job = dict(cli=world == 2)
            results, wall = host_s(torch, lambda: pool_run(torch, world, ts_rank, job))  # noqa: B023
            for shape, kinds in TS_RUNS[world]:
                tag = f"{shape[0]}x{shape[1]}"
                for kind in kinds:
                    per_rank = {r: results[r][(shape, kind)] for r in range(world)}
                    name = f"{tag}_{kind}"
                    gates = _ts_gates(name, per_rank, ref, kind, shape)
                    if kind.startswith("control"):
                        emit(f"serve/ts_{name}", mesh=list(shape), gates=gates)
                        continue
                    first = per_rank[0]
                    routes = {r["stats"]["route"] for r in per_rank.values()}
                    want_route = "graph" if shape[1] == 1 else "eager"
                    check(routes == {want_route}, f"(ts) {name}: routes {routes}")
                    k1 = [r["launches"]["countsketch_batched"] for r in per_rank.values()]
                    check(all(n == (want_k1 if kind in ("uniform", "adaptive") else 0) for n in k1),
                          f"(ts) {name}: kernel 1 launched {k1}, want "
                          f"{want_k1 if kind in ('uniform', 'adaptive') else 0}")
                    launched += [r["launches"] for r in per_rank.values()]
                    fields = dict(
                        mesh=list(shape), backend="gloo on one card", route=want_route,
                        requests_per_rank=SERVE_B // shape[0], gates=gates,
                        prefill_ms_per_rank=[r["timings"]["prefill"] for r in per_rank.values()],
                        decode_ms_per_token_per_rank=[r["rate"]["decode_ms_per_token"]
                                                      for r in per_rank.values()],
                        tokens_per_s=SERVE_B / max(r["rate"]["decode_ms_per_token"]
                                                   for r in per_rank.values()) * 1e3,
                        convert_ms_rank0=first["timings"].get("convert"),
                        generate_collectives_rank0=first["collectives"],
                        peak_gib_per_rank=[r["peak_gib"] for r in per_rank.values()],
                        resident_gib_per_rank=[r["resident_gib"] for r in per_rank.values()],
                        kernel1_launches_per_rank=k1, timing="CUDA events in each rank",
                        rate_rank0=first["rate"])
                    if kind == "dense":
                        fields.update(
                            prefill_collectives_rank0=first["prefill_collectives"],
                            decode_step_collectives_rank0=first["forced_step_collectives"],
                            decode_step_collective_share_rank0=first["collective_share"],
                            forced_step_host_ms_rank0=first["forced_step_host_ms"],
                            cache_nbytes_per_rank=first["cache_nbytes"],
                            r_cache_nbytes=ref["r_cache_nbytes"])
                        if "step_profile" in first:  # gate 6
                            prof = first["step_profile"]
                            check(prof["host_launches"] == ref["z_r"]["host_launches"],
                                  f"(ts) {name}: {prof['host_launches']} host launches a "
                                  f"replayed step, (r)'s graph {ref['z_r']['host_launches']}")
                            fields.update(step_profile_rank0=prof,
                                          r_graph_step=dict(host_launches=ref["z_r"][
                                              "host_launches"], device_ops=ref["z_r"][
                                              "device_ops"]))
                    elif kind in ("uniform", "adaptive"):
                        fields.update(cache_nbytes_per_rank=first["cache_nbytes"],
                                      s_cache_nbytes=ref[f"s_{kind}"]["cache_nbytes"],
                                      heads_per_rank=first["heads"])
                    emit(f"serve/ts_{name}", **fields)
            if job["cli"]:
                clis = [results[r]["cli"] for r in range(world)]
                check(all(torch_equal(c["tokens"], clis[0]["tokens"]) for c in clis),
                      "(ts) CLI: the ranks' tokens differ")
                emit("serve/ts_cli", argv=TS_CLI, shape=list(clis[0]["tokens"].shape),
                     wall_s=[c["wall_s"] for c in clis])
            emit(f"serve/ts_world{world}_ranks", pool_job_s=wall)
    finally:
        del ref
        TS_REF.unlink(missing_ok=True)
    return launched


# ---------------------------------------------------------------------------
# (ep): expert parallelism and MLA heads on the model axis
# ---------------------------------------------------------------------------


def ep_one_rank(torch, prompt, toks, walk_logits, pre_recs, dec_recs, keep_logits: bool = True,
                **extra) -> dict:
    """A one-rank serve run as (ep)'s ranks read it, on the host: the prompt
    and tokens, each token's top-2 margin (prefill's logits, then each
    step's), prefill's logits and (``keep_logits``) each step's, and every
    MoE call's expert choices (prefill: (T, k) a MoE layer; decode:
    (steps, MoE layers, B, k)); ``extra`` as given."""
    n_moe = len(pre_recs)
    out = dict(prompt=prompt.cpu(), tokens=toks.cpu(),
               margins=torch.stack([ts_margin(lg) for lg in walk_logits], 1),
               prefill_logits=walk_logits[0],
               experts_pre=[r["experts"].to(torch.int16).cpu() for r in pre_recs],
               experts_dec=torch.stack([r["experts"].to(torch.int16).cpu() for r in dec_recs])
               .reshape(len(dec_recs) // n_moe, n_moe, *dec_recs[0]["experts"].shape),
               dropped_share=route_stats(torch, pre_recs)["dropped_share"], **extra)
    if keep_logits:
        out["logits"] = torch.stack(walk_logits[1:])
    return out


def ep_layer_record(torch, model, cfg, prompt, n_max: int) -> dict:
    """(ep) gate 1's one-rank side, on the host: deepseek's first MoE layer
    over (t)'s prompt — its MLA mixer's input and output, its FFN's input
    and output, the routing's expert choices and the dispatch's slots and
    keep bits (each assignment in token-major, then top-k order)."""
    from repro_torch.models import blocks as blk
    from repro_torch.models import layer_specs
    from repro_torch.models.layers import embed_tokens, rmsnorm
    from repro_torch.models.mla import mla_prefill
    from repro_torch.models.moe import dispatch_groups, dispatch_slots, moe_ffn

    specs = layer_specs(cfg)
    i = next(j for j, spec in enumerate(specs) if spec.ffn == "moe")
    x = embed_tokens(model.embed.tok, prompt)
    for b, spec in zip(model.blocks[:i], specs[:i]):
        x, _ = blk.block_prefill(b, spec, cfg, x, n_max)
    b = model.blocks[i]
    h = rmsnorm(b.norm1, x, cfg.norm_eps)
    y, _ = mla_prefill(b.mixer, h, cfg, n_max)
    u = rmsnorm(b.norm2, x + y, cfg.norm_eps)
    out, r = moe_ffn(b.ffn, u, cfg)
    P, cap = dispatch_groups(u.shape[0] * u.shape[1], cfg)
    slot, keep = dispatch_slots(r.experts, P, cap, cfg.n_experts)
    return dict(layer=i, mla_in=h.cpu(), mla_out=y.cpu(), moe_in=u.cpu(), moe_out=out.cpu(),
                experts=r.experts.to(torch.int16).cpu(), slot=slot.reshape(-1).to(torch.int16).cpu(),
                keep=keep.reshape(-1).cpu(), groups=P, capacity=cap)


def ep_forced(torch, sh, mesh, model, cfg, ref: dict, rows: slice, dev, counter,
              n_steps: Optional[int] = None) -> dict:
    """Gate 2 on this rank: prefill's logits over its rows and each decode
    step's (the first ``n_steps``, all by default) fed the one-rank run's
    tokens, against that run's, relative to
    the largest logit, with the one-rank run's expert choices taken in place
    of its own (``moe.forced_experts``) and each MoE call's own choices
    counted against them (flipped assignments); the cache's bytes; each
    step's host ms and collectives. On random weights the ranks' own
    choices flip 4-26 % of a layer's assignments (H100 runs of this script,
    in PERF.md), so the logits are held with the choices replayed."""
    from repro_torch.models import decode_step, moe, prefill
    from repro_torch.serve import cache_nbytes

    n_steps = ref["logits"].shape[0] if n_steps is None else n_steps
    S = ref["prompt"].shape[1]
    cache_len = S + n_steps + 1
    prompt = ref["prompt"][rows].to(dev)
    n_moe = len(ref["experts_pre"])
    tok_rows = slice(rows.start * S, rows.stop * S)
    choices = [e[tok_rows] for e in ref["experts_pre"]]
    choices += [ref["experts_dec"][t, j, rows] for t in range(n_steps) for j in range(n_moe)]
    ms, coll = [], []
    with sh.activation_sharding(mesh), moe.forced_experts(choices) as flips:
        lg0, cache = prefill(model, cfg, prompt, cache_len)
        pre = err(lg0, ref["prefill_logits"][rows].to(dev))[1]
        nbytes = cache_nbytes(cache)
        errs = []
        for t in range(n_steps):
            before = counter.read()
            lg, t_s = host_s(torch, lambda: decode_step(  # noqa: B023
                model, cfg, cache, ref["tokens"][rows, t:t + 1].to(dev))[0])
            errs.append(err(lg, ref["logits"][t][rows].to(dev))[1])
            ms.append(1e3 * t_s)
            coll.append(ts_collectives(counter.read(), before, 1))
    flips = [int(f) for f in flips[:n_moe * (n_steps + 1)]]
    del cache
    out = dict(prefill_rel_err=pre, step_rel_err=errs,
               flips_prefill_by_layer=flips[:n_moe], flips_decode=sum(flips[n_moe:]),
               flips_decode_by_step=[sum(flips[n_moe + t * n_moe:n_moe + (t + 1) * n_moe])
                                     for t in range(n_steps)], cache_nbytes=nbytes)
    if ms:
        out.update(forced_step_host_ms=median(ms), forced_step_collectives=coll[len(coll) // 2])
    return out


def ep_serve(torch, ops, sh, mesh, model, cfg, ref: dict, counter, dev, n_new: int, limit: float,
             kc=None, seed: int = SEED + 140) -> dict:
    """One ``generate`` on this rank under the mesh, its launch counts and
    collectives reset just before: its tokens (gate 3), CUDA-event times,
    collectives, launches and peak memory."""
    import torch.distributed as dist

    from repro_torch.serve import generate

    d, di = mesh.shape["data"], mesh.index("data")
    rows = slice(di * SERVE_B // d, (di + 1) * SERVE_B // d)
    prompt = ref["prompt"][rows].to(dev)
    with sh.activation_sharding(mesh):
        generate(model, cfg, prompt[:, :64], 2, kv_compress=kc)  # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        counter.reset()
        ops.reset_launches()
        t, st = {}, {}
        toks = generate(model, cfg, prompt, n_new, gen=gen(torch, dev, seed), kv_compress=kc,
                        timings=t, stats=st)
        torch.cuda.synchronize()
    return dict(tokens=toks.cpu(), timings=t, stats=st, rate=decode_rate(t, st, prompt.shape[0]),
                collectives=counter.read(), launches=dict(ops.LAUNCHES),
                peak_gib=(torch.cuda.max_memory_allocated() - resident) / 2**30,
                resident_gib=resident / 2**30, tokens_gate=ts_tokens_gate(toks, ref, rows, limit),
                dp_index=di, tp_index=mesh.index("model"))


def ep_layer_gate(torch, sh, mesh, model, cfg, ref: dict, dev, controls: bool) -> dict:
    """Gate 1 on this rank: the first MoE layer's routing, dispatch and
    output, and its MLA mixer's output, on (t)'s recorded inputs over the
    rank's rows. A choice that differs from the one-rank run's is a near
    tie where the rank's own probabilities of the two experts lie within
    1e-4 of each other, relatively (fp32 products in another order). With
    ``controls`` also the two outputs with their ``reduce_from_tp`` left out
    (the MoE combine's, MLA's after ``w_o``), which must fail the gate."""
    from repro_torch.models import mla, moe
    from repro_torch.models.mla import mla_prefill

    lay = ref["layer"]
    blk = model.blocks[lay["layer"]]
    d, di = mesh.shape["data"], mesh.index("data")
    Bl, k = SERVE_B // d, cfg.moe_top_k
    T = Bl * SERVE_S
    u = lay["moe_in"][di * Bl:(di + 1) * Bl].to(dev)
    want_e = lay["experts"][di * T:(di + 1) * T].to(dev).long()
    asg = slice(di * T * k, (di + 1) * T * k)
    want_slot, want_keep = lay["slot"][asg].to(dev).long(), lay["keep"][asg].to(dev)
    with sh.activation_sharding(mesh):
        r = moe.route(blk.ffn, u.reshape(T, -1), cfg)
        _, slot_own, keep_own, P, cap = moe.dispatch_plan(r.experts, cfg)
        _, slot_w, keep_w, _, _ = moe.dispatch_plan(want_e, cfg)
        out, _ = moe.moe_ffn(blk.ffn, u, cfg)
        h = lay["mla_in"][di * Bl:(di + 1) * Bl].to(dev)
        y, _ = mla_prefill(blk.mixer, h, cfg, SERVE_S)
        ctl = {}
        if controls:
            for name, mod, fn in (("moe_combine_unreduced", moe, lambda: moe.moe_ffn(blk.ffn, u, cfg)),
                                  ("mla_unreduced", mla, lambda: mla_prefill(blk.mixer, h, cfg,
                                                                             SERVE_S))):
                real = mod.reduce_from_tp
                mod.reduce_from_tp = lambda x: x
                try:
                    got = fn()[0]
                finally:
                    mod.reduce_from_tp = real
                want = lay["moe_out" if name.startswith("moe") else "mla_out"]
                ctl[name] = err(got, want[di * Bl:(di + 1) * Bl].to(dev))[1]
    differ = r.experts != want_e
    p_own = torch.gather(r.probs, 1, r.experts)
    p_want = torch.gather(r.probs, 1, want_e)
    gap = ((p_own - p_want).abs() / torch.maximum(p_own, p_want))[differ]
    ties = int((gap <= 1e-4).sum())
    return dict(experts_equal=bool(torch.equal(r.experts, want_e)),
                flipped_assignments=int(differ.sum()), flipped_tokens=int(differ.any(-1).sum()),
                near_tie_flips=ties, other_flips=int(differ.sum()) - ties,
                largest_flip_gap=float(gap.max()) if gap.numel() else 0.0,
                own_slots_keep_equal=bool(torch.equal(slot_own, want_slot)
                                          and torch.equal(keep_own, want_keep)),
                slots_keep_equal_given_choices=bool(torch.equal(slot_w, want_slot)
                                                    and torch.equal(keep_w, want_keep)),
                dropped_own=int((~keep_own).sum()), dropped_given_choices=int((~keep_w).sum()),
                assignments=T * k, groups=P, capacity=cap,
                moe_rel_err=err(out, lay["moe_out"][di * Bl:(di + 1) * Bl].to(dev))[1],
                mla_rel_err=err(y, lay["mla_out"][di * Bl:(di + 1) * Bl].to(dev))[1],
                controls=ctl)


def ep_controls(torch, sh, mesh, model, cfg, ref: dict, dev, names: tuple) -> dict:
    """Serve controls at 1x2, each a prefill whose logits must fail gate 2's
    limit: ``moe_combine_unreduced``, the MoE combine without its
    ``reduce_from_tp``; ``every_rank_expert_block_0``, every rank taking
    expert block 0's assignments (with its own block's weights)."""
    from repro_torch.models import moe, prefill

    real = dict(moe_reduce=moe.reduce_from_tp, local=moe._local_experts)
    patches = {
        "moe_combine_unreduced": lambda: setattr(moe, "reduce_from_tp", lambda x: x),
        "every_rank_expert_block_0": lambda: setattr(
            moe, "_local_experts", lambda p, c: (0, real["local"](p, c)[1])),
    }
    prompt = ref["prompt"].to(dev)
    out = {}
    for name in names:
        patches[name]()
        try:
            with sh.activation_sharding(mesh):
                lg, _ = prefill(model, cfg, prompt, SERVE_S + 1)
        finally:
            moe.reduce_from_tp, moe._local_experts = real["moe_reduce"], real["local"]
        out[name] = err(lg, ref["prefill_logits"].to(dev))[1]
    return out


def ep_kimi_compressed(torch, sh, mesh, model, cfg, ref: dict, dev) -> dict:
    """Gate 4's conversion alone on this rank, from (u)'s seed: each of its
    heads' error over its optimum, ``cache_nbytes``."""
    from repro_torch.models import prefill
    from repro_torch.serve import KVCompressionConfig, cache_nbytes, compress_prefill_cache

    kc = KVCompressionConfig(**SERVE_KC)
    with sh.activation_sharding(mesh):
        _, dense = prefill(model, cfg, ref["prompt"].to(dev), SERVE_S + KIMI_T)
        comp = compress_prefill_cache(gen(torch, dev, SEED + 87), cfg, dense, kc)
    errs, opts = serve_errors(torch, cfg, dense, comp)
    ratio = errs / opts
    out = dict(heads=int(errs.numel()), error_over_optimal=[float(ratio.min()),
                                                            float(ratio.max())],
               beats_optimum=bool((errs < opts * (1 - OPT_SLACK)).any()),
               cache_nbytes=cache_nbytes(comp))
    del dense, comp
    return out


def ep_serve_runs(torch, ops, sh, mesh, arch: str, ref: dict, counter, dev) -> dict:
    """This rank's (ep) serve runs of ``arch`` (its blocks drawn leaf by leaf
    from (t)'s or (u)'s seed): deepseek — gate 1, ``generate``, gates 2-3,
    at 1x2 the controls; kimi — ``generate`` dense and compressed, gates
    2-3 dense, gate 4."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serve import KVCompressionConfig

    cfg = get_arch(arch).full_config()
    if arch == KIMI_ARCH:
        cfg = dataclasses.replace(cfg, n_layers=KIMI_DEPTH, pattern=cfg.pattern[:KIMI_DEPTH])
    seed = SEED + (80 if arch == DEEPSEEK_ARCH else 84)
    t0 = time.perf_counter()
    model = init_params(gen(torch, dev, seed), cfg, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    d, di = mesh.shape["data"], mesh.index("data")
    rows = slice(di * SERVE_B // d, (di + 1) * SERVE_B // d)
    limit = EP_LOGIT_TOL[arch]
    out = {}
    if arch == DEEPSEEK_ARCH:
        r = ref["t"]
        out["ds_layer"] = ep_layer_gate(torch, sh, mesh, model, cfg, r, dev,
                                        controls=mesh.shape["data"] == 1)
        out["ds_dense"] = ep_serve(torch, ops, sh, mesh, model, cfg, r, counter, dev, EP_DS_T,
                                   limit)
        out["ds_dense"]["forced"] = ep_forced(torch, sh, mesh, model, cfg, r, rows, dev, counter,
                                              EP_DS_T - 1)
        if mesh.shape["data"] == 1:
            out["ds_controls"] = ep_controls(torch, sh, mesh, model, cfg, r, dev,
                                             ("every_rank_expert_block_0",))
    else:
        kc = KVCompressionConfig(**SERVE_KC)
        out["kimi_dense"] = ep_serve(torch, ops, sh, mesh, model, cfg, ref["u_dense"], counter,
                                     dev, KIMI_T, limit, seed=SEED + 86)
        out["kimi_dense"]["forced"] = ep_forced(torch, sh, mesh, model, cfg, ref["u_dense"],
                                                rows, dev, counter)
        out["kimi_compressed"] = ep_serve(torch, ops, sh, mesh, model, cfg, ref["u_compressed"],
                                          counter, dev, KIMI_T, limit, kc=kc, seed=SEED + 86)
        out["kimi_compressed"].update(ep_kimi_compressed(torch, sh, mesh, model, cfg,
                                                         ref["u_compressed"], dev))
        out["kimi_controls"] = ep_controls(torch, sh, mesh, model, cfg, ref["u_dense"], dev,
                                           ("moe_combine_unreduced", "every_rank_expert_block_0"))
    for key in ("ds_dense", "kimi_dense", "kimi_compressed"):
        if key in out:
            out[key]["init_s"] = init_s
    del model
    torch.cuda.empty_cache()
    return out


def ep_rank(rank: int, world: int, job: dict) -> dict:
    """One pool rank's (ep) job on the card: the runs of ``EP_RUNS[world]`` at
    its mesh, the model and data axes' all-reduces counted."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    dev = torch.device(job["device"])
    shape, runs = EP_RUNS[world]
    mesh = make_host_mesh(*shape)
    counter = CollectiveCounter(torch, dist, {"model": mesh.group("model"),
                                              "data": mesh.group("data")})
    dist.all_reduce = counter
    results = {}
    with torch.no_grad():
        ref = torch.load(EP_REF, mmap=True, map_location="cpu", weights_only=True)
        for run in runs:
            if run == "ds_serve":
                results.update(ep_serve_runs(torch, ops, sh, mesh, DEEPSEEK_ARCH, ref, counter,
                                             dev))
            elif run == "kimi":
                results.update(ep_serve_runs(torch, ops, sh, mesh, KIMI_ARCH, ref, counter, dev))
        del ref
    if "ds_train" in runs:
        full = get_arch(DEEPSEEK_ARCH).full_config()
        cfg = dataclasses.replace(full, n_layers=EP_TRAIN_DEPTH,
                                  pattern=full.pattern[:EP_TRAIN_DEPTH])
        ref = torch.load(EP_TRAIN_REF, mmap=True, map_location="cpu", weights_only=True)
        for kind, steps in EP_TRAIN_RUNS[shape]:
            results[f"train_{kind}"] = tp_run(torch, ops, sh, mesh, cfg, kind, steps, ref,
                                              counter, dev, seed=SEED + 130)
        del ref
    return results


def train_reference(torch, ops, dev, cfg, seed: int, path, leaves: int, ratio: float,
                    what: str, steps: int = 3) -> dict:
    """A mesh phase's one-rank training run, in this process: ``cfg`` from
    ``seed``, step 1's loss and gradients, then ``steps`` plain and
    compressed steps from that state on (y)'s batches, optimizer and
    compression settings; kernel 4 ``leaves`` times a compressed step and
    ``comp/ratio`` the reference's ``ratio``. The gradients and each kind's
    parameters after step 1 go to ``path`` (memory-mapped by the ranks,
    which read their blocks); returns the losses, grad norms and the
    squared norms of step 1's updates."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.device import fold_in
    from repro_torch.models import init_params, param_count
    from repro_torch.train import (CompressionConfig, OptimizerConfig, compression_ratio,
                                   init_opt_state, make_compressed_train_step, make_train_step)

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=TRAIN_B, seq_len=TRAIN_S,
                                  seed=SEED), device=dev)
    batches = [data.batch_at(i) for i in range(steps)]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    model = init_params(gen(torch, dev, seed), cfg, device=dev)
    n_params = param_count(model)
    oc = OptimizerConfig(lr=TRAIN_LR, warmup_steps=min(20, TRAIN_STEPS // 10 + 1),
                         total_steps=TRAIN_STEPS)
    ccfg = CompressionConfig(**TRAIN_CCFG)
    got_ratio = compression_ratio(model, ccfg)
    check(got_ratio == ratio, f"({what}) one rank: compression_ratio {got_ratio} != {ratio}")
    # the initial weights stay on the card: step 1's updates are summed there
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    loss0, grads0 = train_grads(torch, model, cfg, batches[0], remat="dots")
    grads0 = {k: v.cpu() for k, v in grads0.items()}
    params1, params1c, update_sq = {}, {}, {}

    def keep_step1(into: dict, kind: str) -> None:
        named = dict(model.named_parameters())
        update_sq[kind] = {k: float(torch.sum((named[k].detach().double() - w.double()) ** 2))
                           for k, w in init.items()}
        into.update({k: v.detach().to("cpu", copy=True) for k, v in named.items()})

    def plain_step(st, b, i):
        out = step(st, b)
        if i == 0:
            keep_step1(params1, "plain")
        return out

    step = make_train_step(cfg, oc, remat="dots")
    state = {"params": model, "opt": init_opt_state(model, oc)}
    state, plain, _ = train_run(torch, ops, plain_step, state, batches, resident)
    del state
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(init[k])
    torch.cuda.empty_cache()

    def compressed_step(st, b, i):
        out = cstep(st, b, fold_in(9, i))
        if i == 0:
            keep_step1(params1c, "compressed")
        return out

    cstep, init_err = make_compressed_train_step(cfg, oc, ccfg, remat="dots")
    state = {"params": model, "opt": init_opt_state(model, oc), "err": init_err(model)}
    state, comp, launched = train_run(torch, ops, compressed_step, state, batches, resident)
    check(launched["twoside_sketch"] == leaves * steps,
          f"({what}) one rank: kernel 4 launched {launched['twoside_sketch']} times")
    check(all(abs(r / ratio - 1) <= 1e-6 for r in comp["comp/ratio"]),
          f"({what}) one rank: comp/ratio {comp['comp/ratio']}")
    out = dict(loss0=loss0, update_sq=sum(update_sq["plain"].values()),
               update_sq_c=sum(update_sq["compressed"].values()),
               update_sq_leaf=update_sq["plain"], update_sq_c_leaf=update_sq["compressed"],
               plain_losses=plain["losses"], plain_grad_norms=plain["grad_norms"],
               compressed_losses=comp["losses"], compressed_grad_norms=comp["grad_norms"],
               one_rank=dict(params=n_params, depth=cfg.n_layers, compression_ratio=got_ratio,
                             plain_step_ms=plain["step_ms"], compressed_step_ms=comp["step_ms"],
                             plain_peak_gib=plain["peak_gib"], compressed_peak_gib=comp["peak_gib"],
                             kernel4_launches=launched["twoside_sketch"]))
    del state, model, init
    torch.cuda.empty_cache()
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"grads0": grads0, "params1": params1, "params1c": params1c}, path)
    return out


def _ep_serve_gates(name: str, per_rank: dict, limit: float) -> dict:
    """Gates 2-3 over one (ep) serve run's ranks: the logits within ``limit``
    with the one-rank expert choices replayed (the ranks' own flips beside);
    tokens equal up to each request's first small margin; a model group's
    tokens equal."""
    groups = {}
    for r in per_rank.values():
        groups.setdefault(r["dp_index"], []).append(r["tokens"])
    check(all(all(torch_equal(t, ts[0]) for t in ts) for ts in groups.values()),
          f"(ep) {name}: ranks of a model-axis group returned different tokens")
    toks = [r["tokens_gate"] for r in per_rank.values()]
    check(all(g["equal_before_it"] for g in toks), f"(ep) {name}: tokens differ: {toks}")
    recs = [r["forced"] for r in per_rank.values()]
    rep = dict(prefill_rel_err=max(x["prefill_rel_err"] for x in recs),
               step_rel_err=max(max(x["step_rel_err"]) for x in recs),
               flips_prefill_by_layer=[x["flips_prefill_by_layer"] for x in recs],
               flips_decode=[x["flips_decode"] for x in recs])
    check(rep["prefill_rel_err"] <= limit and rep["step_rel_err"] <= limit,
          f"(ep) {name}: logits with the one-rank choices replayed {rep} (limit {limit})")
    return dict(tokens=toks, limit=limit, replayed=rep)


def phase_ep(torch, ops, dev, kernels_ep: dict) -> list:
    """(ep): expert parallelism and MLA heads on the model axis in gloo ranks
    spawned on this one card (NCCL cannot put two ranks of a group on one
    GPU; gloo stages the collectives through the host): deepseek-v2-lite's
    full config served at 1x2 (and its controls) and 2x2, kimi-k2 at depth 2
    at 1x2 dense and compressed, deepseek trained at ``EP_TRAIN_DEPTH`` at
    1x2 plain (and its control) and compressed and at 2x2 plain, against
    (t)'s and (u)'s runs and one rank's training run. Returns the ranks'
    launches."""
    import gc

    from repro_torch.configs import get_arch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    full = get_arch(DEEPSEEK_ARCH).full_config()
    train_ref = train_reference(torch, ops, dev, dataclasses.replace(
        full, n_layers=EP_TRAIN_DEPTH, pattern=full.pattern[:EP_TRAIN_DEPTH]), SEED + 130,
        EP_TRAIN_REF, EP_TRAIN_LEAVES, EP_TRAIN_RATIO, "ep", steps=2)
    check(train_ref["one_rank"]["params"] == EP_TRAIN_PARAMS,
          f"(ep) one rank: {train_ref['one_rank']['params']} parameters")
    emit("train/ep_one_rank_reference", s=time.perf_counter() - t0, **train_ref["one_rank"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.save(EP_SAVE, EP_REF)
    ref = {k: dict(dropped_share=v["dropped_share"], kernel1=v.get("kernel1"),
                   cache_nbytes=v.get("cache_nbytes"),
                   error_over_optimal=v.get("error_over_optimal"))
           for k, v in EP_SAVE.items()}
    n_moe_t = len(EP_SAVE["t"]["experts_pre"])
    lay = EP_SAVE["t"]["layer"]
    one_rank_drops = int((~lay["keep"]).sum())
    EP_SAVE.clear()
    free_gib = torch.cuda.mem_get_info()[0] / 2**30
    emit("ep/memory", parent_allocated_gib=torch.cuda.memory_allocated() / 2**30,
         card_free_gib=free_gib, reckoned_2x2_gib=4 * EP_RANK_GIB)
    check(free_gib >= 4 * EP_RANK_GIB, f"(ep): {free_gib} GiB free; 2x2 needs 4 x {EP_RANK_GIB}")
    launched = []
    try:
        for world in (2, 4):
            shape, runs = EP_RUNS[world]
            tag = f"{shape[0]}x{shape[1]}"
            results, wall = host_s(torch, lambda: pool_run(  # noqa: B023
                torch, world, ep_rank, dict(device=str(dev)), 1200.0))
            per = lambda key: {r: results[r][key] for r in range(world)}  # noqa: E731, B023
            if "ds_serve" in runs:
                lays = per("ds_layer")
                moe_tol = (get_arch(DEEPSEEK_ARCH).full_config().moe_top_k + 3) * 2.0 ** -8
                moe_err = max(x["moe_rel_err"] for x in lays.values())
                mla_err = max(x["mla_rel_err"] for x in lays.values())
                check(moe_err <= moe_tol and mla_err <= EP_MLA_TOL,
                      f"(ep) {tag} gate 1: MoE layer {moe_err} (limit {moe_tol}), MLA {mla_err} "
                      f"(limit {EP_MLA_TOL})")
                check(all(x["slots_keep_equal_given_choices"] for x in lays.values()),
                      f"(ep) {tag} gate 1: slots or keep differ given the one-rank choices")
                if shape[0] == 1:  # the rank routes (t)'s rows: bitwise
                    check(all(x["experts_equal"] and x["own_slots_keep_equal"]
                              for x in lays.values()), f"(ep) {tag} gate 1: routing not bitwise")
                check(all(x["other_flips"] == 0 for x in lays.values()),
                      f"(ep) {tag} gate 1: choices differ beyond near ties: {lays}")
                model0 = [x for r, x in lays.items() if results[r]["ds_dense"]["tp_index"] == 0]
                drops = sum(x["dropped_given_choices"] for x in model0)
                check(drops == one_rank_drops,
                      f"(ep) {tag} gate 1: {drops} drops over the data ranks, one rank "
                      f"{one_rank_drops}")
                gates = _ep_serve_gates(f"{tag}_deepseek", per("ds_dense"),
                                        EP_LOGIT_TOL[DEEPSEEK_ARCH])
                dense = per("ds_dense")
                first = dense[0]
                emit(f"serve/ep_{tag}_deepseek", mesh=list(shape), backend="gloo on one card",
                     route=first["stats"]["route"], requests_per_rank=SERVE_B // shape[0],
                     gates=gates, layer_gate=dict(
                         per_rank=lays, moe_limit=moe_tol, mla_limit=EP_MLA_TOL,
                         drops_over_data_ranks=drops, one_rank_drops=one_rank_drops,
                         assignments=sum(x["assignments"] for x in model0),
                         one_rank_dropped_share=ref["t"]["dropped_share"]),
                     prefill_ms_per_rank=[r["timings"]["prefill"] for r in dense.values()],
                     decode_ms_per_token_per_rank=[r["rate"]["decode_ms_per_token"]
                                                   for r in dense.values()],
                     generate_collectives_rank0=first["collectives"],
                     decode_step_collectives_rank0=first["forced"]["forced_step_collectives"],
                     forced_step_host_ms_rank0=first["forced"]["forced_step_host_ms"],
                     peak_gib_per_rank=[r["peak_gib"] for r in dense.values()],
                     resident_gib_per_rank=[r["resident_gib"] for r in dense.values()],
                     cache_nbytes_per_rank=first["forced"]["cache_nbytes"],
                     t_cache_nbytes=DEEPSEEK_LATENT_BYTES, init_s_per_rank=[
                         r["init_s"] for r in dense.values()],
                     moe_layers=n_moe_t, timing="CUDA events in each rank", rate_rank0=first["rate"])
                launched += [r["launches"] for r in dense.values()]
                if shape[0] == 1:
                    ctl = per("ds_controls")
                    worst = {c: min(x[c] for x in ctl.values()) for c in ctl[0]}
                    check(all(v > EP_LOGIT_TOL[DEEPSEEK_ARCH] for v in worst.values()),
                          f"(ep) a control passes gate 2: {worst}")
                    lay_ctl = {c: min(x["controls"][c] for x in lays.values())
                               for c in lays[0]["controls"]}
                    check(lay_ctl["moe_combine_unreduced"] > moe_tol
                          and lay_ctl["mla_unreduced"] > EP_MLA_TOL,
                          f"(ep) a layer control passes gate 1: {lay_ctl}")
                    emit(f"serve/ep_{tag}_deepseek_controls", prefill_rel_err_least_rank=worst,
                         limit=EP_LOGIT_TOL[DEEPSEEK_ARCH], layer_rel_err_least_rank=lay_ctl,
                         layer_limits=dict(moe=moe_tol, mla=EP_MLA_TOL), failed=True)
            if "kimi" in runs:
                limit = EP_LOGIT_TOL[KIMI_ARCH]
                ctl = per("kimi_controls")
                worst = {c: min(x[c] for x in ctl.values()) for c in ctl[0]}
                check(all(v > limit for v in worst.values()),
                      f"(ep) a kimi control passes gate 2: {worst}")
                emit(f"serve/ep_{tag}_kimi_controls", prefill_rel_err_least_rank=worst,
                     limit=limit, failed=True)
                for mode in ("dense", "compressed"):
                    runs_k = per(f"kimi_{mode}")
                    first = runs_k[0]
                    fields = {}
                    if mode == "dense":
                        fields["gates"] = _ep_serve_gates(f"{tag}_kimi_dense", runs_k, limit)
                    else:
                        toks = [r["tokens_gate"] for r in runs_k.values()]
                        check(all(g["equal_before_it"] for g in toks),
                              f"(ep) {tag} kimi compressed: tokens differ: {toks}")
                        k1 = [r["launches"]["countsketch_batched"] for r in runs_k.values()]
                        check(all(n == ref["u_compressed"]["kernel1"] for n in k1),
                              f"(ep) {tag} kimi compressed: kernel 1 launched {k1}, (u) "
                              f"{ref['u_compressed']['kernel1']}")
                        check(not any(r["beats_optimum"] for r in runs_k.values()),
                              f"(ep) {tag} kimi compressed: a head beats its optimal error")
                        fields.update(tokens=toks, kernel1_launches_per_rank=k1,
                                      u_kernel1_launches=ref["u_compressed"]["kernel1"],
                                      error_over_optimal_per_rank=[
                                          r["error_over_optimal"] for r in runs_k.values()],
                                      u_error_over_optimal=ref["u_compressed"]["error_over_optimal"],
                                      cache_nbytes_per_rank=first["cache_nbytes"],
                                      u_cache_nbytes=ref["u_compressed"]["cache_nbytes"],
                                      heads_per_rank=first["heads"])
                    launched += [r["launches"] for r in runs_k.values()]
                    emit(f"serve/ep_{tag}_kimi_{mode}", mesh=list(shape),
                         backend="gloo on one card", route=first["stats"]["route"],
                         prefill_ms_per_rank=[r["timings"]["prefill"] for r in runs_k.values()],
                         convert_ms_rank0=first["timings"].get("convert"),
                         decode_ms_per_token_per_rank=[r["rate"]["decode_ms_per_token"]
                                                       for r in runs_k.values()],
                         generate_collectives_rank0=first["collectives"],
                         peak_gib_per_rank=[r["peak_gib"] for r in runs_k.values()],
                         timing="CUDA events in each rank", **fields)
            if "ds_train" in runs:
                for kind, steps in EP_TRAIN_RUNS[shape]:
                    per_rank = per(f"train_{kind}")
                    name = f"{tag}_{kind}"
                    gates = _tp_gates(f"ep {name}", per_rank, train_ref, kind,
                                      watch=("router", "w_dkv"))
                    recs = [r["steps"] for r in per_rank.values()]
                    k4 = [[x["kernel4"] for x in rs] for rs in recs]
                    if kind == "compressed":
                        check(all(n == EP_TRAIN_LEAVES for ks in k4 for n in ks),
                              f"(ep) {name}: kernel 4 launched {k4} a step, not "
                              f"{EP_TRAIN_LEAVES}")
                        ratios = [x["comp/ratio"] for rs in recs for x in rs]
                        check(all(abs(r / EP_TRAIN_RATIO - 1) <= 1e-6 for r in ratios),
                              f"(ep) {name}: comp/ratio {ratios} != {EP_TRAIN_RATIO}")
                    else:
                        check(not any(n for ks in k4 for n in ks), f"(ep) {name}: kernel 4 {k4}")
                    if not kind.startswith("control"):
                        for rs in recs:
                            totals = {}
                            for x in rs:
                                for key, v in x["launches"].items():
                                    totals[key] = totals.get(key, 0) + v
                            launched.append(totals)
                    ms = [median([x["ms"] for x in rs[1:]] or [rs[0]["ms"]]) for rs in recs]
                    emit(f"train/ep_{name}", mesh=list(shape), depth=EP_TRAIN_DEPTH,
                         backend="gloo on one card", steps=len(recs[0]),
                         step_ms_median_per_rank=ms,
                         tokens_per_s=TRAIN_B * TRAIN_S / max(ms) * 1e3,
                         peak_gib_per_rank=[r["peak_gib"] for r in per_rank.values()],
                         losses=[x["loss"] for x in recs[0]],
                         grad_norms=[x["grad_norm"] for x in recs[0]],
                         comp={k: [x[k] for x in recs[0]] for k in recs[0][0]
                               if k.startswith("comp/")},
                         collectives_per_step_rank0=[x["collectives"] for x in recs[0]],
                         kernel4_launches_per_step=k4, gates=gates,
                         whole_leaves_equal_per_step=[[x["whole_equal"] for x in rs]
                                                      for rs in recs],
                         step_ms_rank0=[x["ms"] for x in recs[0]],
                         one_rank_step_ms=train_ref["one_rank"]["compressed_step_ms" if kind ==
                                                                 "compressed" else "plain_step_ms"])
            emit(f"ep/{tag}_ranks", pool_job_s=wall)
    finally:
        EP_REF.unlink(missing_ok=True)
        EP_TRAIN_REF.unlink(missing_ok=True)
    emit("ep/kernels", **kernels_ep)
    return launched


# ---------------------------------------------------------------------------
# (hy): Mamba-2, shared and cross attention on the model axis
# ---------------------------------------------------------------------------


def hy_cfg(arch: str):
    """(hy)'s config of ``arch``: its full width at ``HY_DEPTH[arch]`` layers."""
    from repro_torch.configs import get_arch

    full = get_arch(arch).full_config()
    depth = HY_DEPTH[arch]
    return dataclasses.replace(full, n_layers=depth, pattern=full.pattern[:depth])


def hy_model(torch, arch: str, dev, mesh=None) -> tuple:
    """(hy)'s model of ``arch`` from its seed (this rank's blocks, drawn leaf
    by leaf, with a ``mesh``), the vision model's cross gates at 0.5; the
    config and the seconds the draw took."""
    from repro_torch.models import init_params

    cfg = hy_cfg(arch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_params(gen(torch, dev, HY_SEED[arch]), cfg, device=dev, mesh=mesh)
    with torch.no_grad():
        for b, spec in zip(model.blocks, cfg.pattern):
            if spec.mixer == "cross":
                b.mixer.gate.fill_(0.5)
    torch.cuda.synchronize()
    return cfg, model, time.perf_counter() - t0


def hy_references(torch, ops, dev) -> dict:
    """One rank's serve runs of (hy)'s three models, saved to ``HY_REF``:
    ``HY_B`` requests of 2048 seeded tokens in each model's vocabulary (and
    the stub's patch embeddings for the vision model); dense ``generate``
    (tokens, margins, prefill's and each step's logits); the vision model's
    compressed run ((s)'s compression from a seed; tokens, margins, kernel
    1's launches); for mamba2 its first Mamba-2 layer's input and its gated
    norm's output, for the vision model its cross layer's input, projected
    patches and output, over ``HY_LAYER_B`` requests (the layer gates).
    Returns each model's parameter count, init seconds and kernel-1
    launches."""
    from repro_torch.models import blocks, prefill, ssm
    from repro_torch.models.attention import cross_attention
    from repro_torch.models.layers import embed_tokens, rmsnorm
    from repro_torch.models.modality import synth_patch_embeddings
    from repro_torch.serve import KVCompressionConfig

    ref, info = {}, {}
    with torch.no_grad():
        for arch in HY_DEPTH:
            cfg, model, init_s = hy_model(torch, arch, dev)
            g = gen(torch, dev, HY_SEED[arch] + 1)
            prompt = torch.randint(0, cfg.vocab_size, (HY_B, SERVE_S), generator=g, device=dev)
            vision = synth_patch_embeddings(g, cfg, HY_B, dev) if cfg.d_vision else None
            rec = dict(prompt=prompt.cpu(), vision=None if vision is None else vision.cpu(),
                       dense=ts_reference(torch, model, cfg, prompt, True, HY_T, vision))
            info[arch] = dict(params=sum(p.numel() for p in model.parameters()), init_s=init_s)
            if cfg.d_vision:
                ops.reset_launches()
                rec["compressed"] = ts_reference(
                    torch, model, cfg, prompt, False, HY_T, vision,
                    kv_compress=KVCompressionConfig(**SERVE_KC), gen=gen(torch, dev,
                                                                         HY_SEED[arch] + 2))
                info[arch]["kernel1"] = ops.LAUNCHES["countsketch_batched"]
            if arch == MAMBA_ARCH:
                layer = model.blocks[0]
                h = rmsnorm(layer.norm1, embed_tokens(model.embed.tok, prompt[:HY_LAYER_B]),
                            cfg.norm_eps)
                seen, real = [], ssm._gated_norm
                ssm._gated_norm = lambda s_, y, eps: seen.append(real(s_, y, eps)) or seen[-1]
                try:
                    ssm.mamba2_forward(layer.mixer, h, cfg)
                finally:
                    ssm._gated_norm = real
                rec["norm"] = dict(h=h.cpu(), g=seen[0].cpu())
            if cfg.d_vision:  # the cross layer's input and output at prefill
                seen, real = [], blocks._cross_attend

                def recorded(p_, c_, x, k, v, core=cross_attention):  # noqa: B023
                    y = real(p_, c_, x, k, v, core)  # noqa: B023
                    seen.append((x, y))  # noqa: B023
                    return y

                blocks._cross_attend = recorded
                try:
                    prefill(model, cfg, prompt[:HY_LAYER_B], SERVE_S + 1, vision[:HY_LAYER_B])
                finally:
                    blocks._cross_attend = real
                vis = vision[:HY_LAYER_B].to(cfg.param_dtype) @ model.vision_proj
                rec["cross"] = dict(h=seen[0][0].cpu(), vis=vis.cpu(), y=seen[0][1].cpu())
            ref[arch] = rec
            del model, vision
            torch.cuda.empty_cache()
    HY_REF.parent.mkdir(parents=True, exist_ok=True)
    torch.save(ref, HY_REF)
    return info


def hy_serve(torch, ops, sh, mesh, model, cfg, ref: dict, counter, dev, kc=None,
             seed: int = 0) -> dict:
    """One (hy) serve run on this rank under the mesh: ``generate`` of
    ``HY_T`` tokens on the ``HY_B`` requests, its launches and collectives
    reset just before (its tokens against the one-rank run's: gate 3); dense, also
    prefill's logits (gate 1) and the one-rank run's tokens through
    ``decode_step``, each step's logits (gate 2), its host ms and
    collectives."""
    import torch.distributed as dist

    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import cache_nbytes, generate

    rows = slice(0, HY_B)  # one data rank
    prompt = ref["prompt"].to(dev)
    vision = None if ref["vision"] is None else ref["vision"].to(dev)
    r = ref["compressed" if kc else "dense"]
    with sh.activation_sharding(mesh):
        generate(model, cfg, prompt[:2, :256], 9 if kc else 3, kv_compress=kc,
                 vision=None if vision is None else vision[:2])  # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        counter.reset()
        ops.reset_launches()
        t, st = {}, {}
        toks = generate(model, cfg, prompt, HY_T, vision=vision, kv_compress=kc,
                        gen=gen(torch, dev, seed) if kc else None, timings=t, stats=st)
        torch.cuda.synchronize()
        out = dict(tokens=toks.cpu(), timings=t, stats=st, rate=decode_rate(t, st, HY_B),
                   collectives=counter.read(), launches=dict(ops.LAUNCHES),
                   peak_gib=(torch.cuda.max_memory_allocated() - resident) / 2**30,
                   resident_gib=resident / 2**30,
                   tokens_gate=ts_tokens_gate(toks, r, rows, HY_LOGIT_TOL))
        if kc is not None:
            return out
        counter.reset()
        (lg0, cache), pre_s = host_s(torch, lambda: prefill(model, cfg, prompt,
                                                            SERVE_S + HY_T, vision))
        pre_coll = counter.read()
        out.update(prefill_rel_err=err(lg0, r["prefill_logits"].to(dev))[1],
                   prefill_host_ms=1e3 * pre_s, prefill_collectives=pre_coll,
                   prefill_collective_share=sum(v["ms"] for v in pre_coll.values()) / (1e3 * pre_s),
                   cache_nbytes=cache_nbytes(cache["layers"]))
        errs, ms, coll = [], [], []
        for i in range(HY_T - 1):
            before = counter.read()
            lg, t_s = host_s(torch, lambda: decode_step(  # noqa: B023
                model, cfg, cache, r["tokens"][rows, i:i + 1].to(dev))[0])
            errs.append(err(lg, r["logits"][i].to(dev))[1])
            ms.append(1e3 * t_s)
            coll.append(ts_collectives(counter.read(), before, 1))
        del cache
    out.update(step_rel_err=errs, forced_step_host_ms=median(ms),
               forced_step_collectives=coll[len(coll) // 2],
               collective_share=median([sum(v["ms"] for v in c.values()) / x
                                        for c, x in zip(coll, ms)]))
    return out


def hy_controls(torch, sh, mesh, model, cfg, ref: dict, dev) -> dict:
    """(hy)'s serve control on this rank, a prefill whose logits must fail
    gate 1: ``mamba2_unsummed``, Mamba-2's output left unsummed over the
    model axis (each rank's normed ``y`` placed in zeros, not gathered, so
    ``w_out`` gives the rank's partial output alone)."""
    from repro_torch.models import prefill, ssm

    def own_block(g, dim=-1):
        index, m = sh.tp_index()
        n = g.shape[-1]
        out = g.new_zeros((*g.shape[:-1], n * m))
        out[..., index * n:(index + 1) * n] = g
        return out

    ssm.gather_from_tp = own_block
    try:
        with sh.activation_sharding(mesh):
            lg, _ = prefill(model, cfg, ref["prompt"].to(dev), SERVE_S + 1)
    finally:
        ssm.gather_from_tp = sh.gather_from_tp
    return dict(mamba2_unsummed=err(lg, ref["dense"]["prefill_logits"].to(dev))[1])


def hy_layer_gate(torch, sh, mesh, model, cfg, ref: dict, dev) -> dict:
    """(hy)'s layer gate on this rank, on the one-rank run's recorded
    inputs, and its control, which must fail it: mamba2's first Mamba-2
    layer, its gated RMSNorm's output on this rank's channels against that
    run's block (control: the norm over the rank's own channels alone); the
    vision model's cross layer, its output against that run's (control:
    the output left unsummed over the model axis)."""
    from repro_torch.models import blocks, ssm
    from repro_torch.models.layers import rmsnorm

    out = {}
    if "norm" in ref:
        h = ref["norm"]["h"].to(dev)
        want = ref["norm"]["g"]
        m, mi = mesh.shape["model"], mesh.index("model")
        n = want.shape[-1] // m
        want = want[..., mi * n:(mi + 1) * n].to(dev)
        real = ssm._gated_norm
        for name, fn in (("rel_err", real), ("control_rel_err",
                                             lambda s_, y, eps: rmsnorm(s_, y, eps))):
            seen = []
            ssm._gated_norm = lambda s_, y, eps: seen.append(fn(s_, y, eps)) or seen[-1]  # noqa: B023
            try:
                with sh.activation_sharding(mesh):
                    ssm.mamba2_forward(model.blocks[0].mixer, h, cfg)
            finally:
                ssm._gated_norm = real
            out[name] = err(seen[0], want)[1]
        out.update(layer="mamba2 gated norm", control="own_mean", channels=[mi * n, (mi + 1) * n])
    else:
        rec = {k: v.to(dev) for k, v in ref["cross"].items()}
        mix = next(b.mixer for b, s_ in zip(model.blocks, cfg.pattern) if s_.mixer == "cross")
        for name in ("rel_err", "control_rel_err"):
            if name == "control_rel_err":
                blocks.reduce_from_tp = lambda x: x
            try:
                with sh.activation_sharding(mesh):
                    k, v = blocks._cross_kv(mix, rec["vis"], cfg)
                    y = blocks._cross_attend(mix, cfg, rec["h"], k, v)
            finally:
                blocks.reduce_from_tp = sh.reduce_from_tp
            out[name] = err(y, rec["y"])[1]
        out.update(layer="vision cross output", control="cross_unsummed")
    return out


def hy_rank(rank: int, world: int, job: dict) -> dict:
    """One pool rank's (hy) job on the card at mesh 1x2: each model's blocks
    drawn leaf by leaf, served dense (and the vision model compressed) with
    its controls and, for mamba2, the layer gate; then zamba2's training
    runs of ``HY_TRAIN_RUNS``, every replicated leaf compared bit for bit on
    the model axis after each step. The model axis's all-reduces counted."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import KVCompressionConfig

    dev = torch.device("cuda")
    mesh = make_host_mesh(1, 2)
    counter = CollectiveCounter(torch, dist, {"model": mesh.group("model"),
                                              "data": mesh.group("data")})
    dist.all_reduce = counter
    results = {}
    with torch.no_grad():
        ref = torch.load(HY_REF, mmap=True, map_location="cpu", weights_only=True)
        for arch in HY_DEPTH:
            cfg, model, init_s = hy_model(torch, arch, dev, mesh)
            out = dict(init_s=init_s, dense=hy_serve(torch, ops, sh, mesh, model, cfg, ref[arch],
                                                     counter, dev))
            if cfg.d_vision:
                out["compressed"] = hy_serve(torch, ops, sh, mesh, model, cfg, ref[arch],
                                             counter, dev, KVCompressionConfig(**SERVE_KC),
                                             HY_SEED[arch] + 2)
            if arch == MAMBA_ARCH:
                out["controls"] = hy_controls(torch, sh, mesh, model, cfg, ref[arch], dev)
            if arch != ZAMBA_ARCH:
                out["layer_gate"] = hy_layer_gate(torch, sh, mesh, model, cfg, ref[arch], dev)
            results[arch] = out
            del model
            torch.cuda.empty_cache()
        del ref
    ref = torch.load(HY_TRAIN_REF, mmap=True, map_location="cpu", weights_only=True)
    cfg = hy_cfg(ZAMBA_ARCH)
    for kind, steps in HY_TRAIN_RUNS:
        results[f"train_{kind}"] = tp_run(torch, ops, sh, mesh, cfg, kind, steps, ref, counter,
                                          dev, seed=HY_SEED[ZAMBA_ARCH])
    del ref
    return results


def _hy_serve_gates(name: str, per_rank: dict, controls: dict = None) -> dict:
    """(hy)'s serve gates over one run's ranks: dense — prefill's logits
    (gate 1) and each teacher-forced step's (gate 2) within
    ``HY_LOGIT_TOL`` of the largest logit; both — the tokens equal to the
    one-rank run's up to each request's first small margin (gate 3) and on
    the two model ranks (gate 4); each control failing gate 1."""
    toks = [r["tokens"] for r in per_rank.values()]
    same = all(torch_equal(t, toks[0]) for t in toks)
    check(same, f"(hy) {name}: the model ranks returned different tokens")
    gates = [r["tokens_gate"] for r in per_rank.values()]
    check(all(g["equal_before_it"] for g in gates), f"(hy) {name}: tokens differ: {gates}")
    out = dict(model_group_tokens_equal=same, tokens=gates)
    if "prefill_rel_err" in per_rank[0]:
        pre = max(r["prefill_rel_err"] for r in per_rank.values())
        step = max(max(r["step_rel_err"]) for r in per_rank.values())
        check(pre <= HY_LOGIT_TOL and step <= HY_LOGIT_TOL,
              f"(hy) {name}: prefill logits {pre}, decode steps {step} > {HY_LOGIT_TOL}")
        out.update(prefill_rel_err=pre, step_rel_err=step, limit=HY_LOGIT_TOL)
    if controls:
        worst = {c: min(x[c] for x in controls.values()) for c in controls[0]}
        check(all(v > HY_LOGIT_TOL for v in worst.values()),
              f"(hy) {name}: a control passes gate 1: {worst}")
        out["controls_prefill_rel_err_least_rank"] = worst
    return out


def phase_hy(torch, ops, dev, kernels_hy: dict) -> list:
    """(hy): Mamba-2, shared and cross attention on the model axis at 1x2 in
    the two-rank pool on this one card (gloo stages the collectives through
    the host): mamba2-1.3b, zamba2-1.2b and the vision model served at full
    width and cut depth (``HY_DEPTH``), dense and (the vision model) with
    the compressed cache, against one rank's runs of the same models and
    depths made here first; zamba2 trained plain, compressed and with the
    whole leaves' control against one rank's training run. Returns the
    ranks' launches."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    info = hy_references(torch, ops, dev)
    train_ref = train_reference(torch, ops, dev, hy_cfg(ZAMBA_ARCH), HY_SEED[ZAMBA_ARCH],
                                HY_TRAIN_REF, HY_ZAMBA_LEAVES, HY_ZAMBA_RATIO, "hy", steps=3)
    check(train_ref["one_rank"]["params"] == HY_ZAMBA_PARAMS,
          f"(hy) one rank: {train_ref['one_rank']['params']} parameters")
    emit("train/hy_one_rank_reference", **train_ref["one_rank"])
    gc.collect()
    torch.cuda.empty_cache()
    emit("hy/references", s=time.perf_counter() - t0, one_rank=info,
         parent_allocated_gib=torch.cuda.memory_allocated() / 2**30,
         card_free_gib=torch.cuda.mem_get_info()[0] / 2**30)
    launched = []
    try:
        results, wall = host_s(torch, lambda: pool_run(torch, 2, hy_rank, {}))
        for arch in HY_DEPTH:
            per = {r: results[r][arch] for r in range(2)}
            tag = HY_TAG[arch]
            for mode in ("dense", "compressed"):
                if mode not in per[0]:
                    continue
                runs = {r: x[mode] for r, x in per.items()}
                first = runs[0]
                ctl = ({r: x["controls"] for r, x in per.items()}
                       if mode == "dense" and "controls" in per[0] else None)
                gates = _hy_serve_gates(f"{tag} {mode}", runs, ctl)
                k1 = [x["launches"]["countsketch_batched"] for x in runs.values()]
                want_k1 = info[arch].get("kernel1", 0) if mode == "compressed" else 0
                check(all(n == want_k1 for n in k1),
                      f"(hy) {tag} {mode}: kernel 1 launched {k1}, one rank {want_k1}")
                if mode == "compressed":
                    check(want_k1 > 0, f"(hy) {tag}: the one-rank compressed run launched no "
                          "kernel 1")
                routes = {x["stats"]["route"] for x in runs.values()}
                check(routes == {"eager"}, f"(hy) {tag} {mode}: routes {routes}")
                fields = dict(
                    arch=arch, depth=HY_DEPTH[arch], mesh=[1, 2], backend="gloo on one card",
                    route="eager", requests=HY_B, prompt_len=SERVE_S, new_tokens=HY_T,
                    gates=gates, init_s_per_rank=[x["init_s"] for x in per.values()],
                    one_rank_params=info[arch]["params"],
                    prefill_ms_per_rank=[x["timings"]["prefill"] for x in runs.values()],
                    decode_ms_per_token_per_rank=[x["rate"]["decode_ms_per_token"]
                                                  for x in runs.values()],
                    generate_collectives_rank0=first["collectives"],
                    peak_gib_per_rank=[x["peak_gib"] for x in runs.values()],
                    resident_gib_per_rank=[x["resident_gib"] for x in runs.values()],
                    kernel1_launches_per_rank=k1, one_rank_kernel1_launches=want_k1,
                    timing="CUDA events in each rank", rate_rank0=first["rate"])
                if mode == "dense":
                    fields.update(
                        prefill_host_ms_rank0=first["prefill_host_ms"],
                        prefill_collectives_rank0=first["prefill_collectives"],
                        prefill_collective_share_rank0=first["prefill_collective_share"],
                        decode_step_collectives_rank0=first["forced_step_collectives"],
                        decode_step_collective_share_rank0=first["collective_share"],
                        forced_step_host_ms_rank0=first["forced_step_host_ms"],
                        cache_nbytes_per_rank=first["cache_nbytes"])
                if mode == "dense" and "layer_gate" in per[0]:
                    lg_ = {r: x["layer_gate"] for r, x in per.items()}
                    sound = max(x["rel_err"] for x in lg_.values())
                    ctl_l = min(x["control_rel_err"] for x in lg_.values())
                    check(sound <= HY_LAYER_TOL < ctl_l,
                          f"(hy) {tag}: {lg_[0]['layer']} {sound}, control {ctl_l} "
                          f"(limit {HY_LAYER_TOL})")
                    fields["layer_gate"] = dict(per_rank=lg_, rel_err=sound,
                                                control_rel_err=ctl_l, limit=HY_LAYER_TOL,
                                                requests=HY_LAYER_B)
                launched += [x["launches"] for x in runs.values()]
                emit(f"serve/hy_{tag}_{mode}", **fields)
        for kind, steps in HY_TRAIN_RUNS:
            per_rank = {r: results[r][f"train_{kind}"] for r in range(2)}
            name = f"1x2_{kind}"
            gates = _tp_gates(f"hy {name}", per_rank, train_ref, kind, watch=HY_WHOLE)
            recs = [r["steps"] for r in per_rank.values()]
            k4 = [[x["kernel4"] for x in rs] for rs in recs]
            if kind == "compressed":
                check(all(n == HY_ZAMBA_LEAVES for ks in k4 for n in ks),
                      f"(hy) {name}: kernel 4 launched {k4} a step, not {HY_ZAMBA_LEAVES}")
                ratios = [x["comp/ratio"] for rs in recs for x in rs]
                check(all(abs(r / HY_ZAMBA_RATIO - 1) <= 1e-6 for r in ratios),
                      f"(hy) {name}: comp/ratio {ratios} != {HY_ZAMBA_RATIO}")
            else:
                check(not any(n for ks in k4 for n in ks), f"(hy) {name}: kernel 4 {k4}")
            whole = [[x["whole_equal"] for x in rs] for rs in recs]
            if not kind.startswith("control"):
                check(all(all(w) for w in whole),
                      f"(hy) {name}: a replicated leaf differs between the model ranks: {whole}")
                for rs in recs:
                    totals = {}
                    for x in rs:
                        for key, v in x["launches"].items():
                            totals[key] = totals.get(key, 0) + v
                    launched.append(totals)
            ms = [median([x["ms"] for x in rs[1:]] or [rs[0]["ms"]]) for rs in recs]
            coll = [x["collectives"] for x in recs[0]]
            coll_ms = [sum(v["ms"] for v in c.values()) for c in coll]
            emit(f"train/hy_{name}", arch=ZAMBA_ARCH, depth=HY_DEPTH[ZAMBA_ARCH], mesh=[1, 2],
                 backend="gloo on one card", steps=len(recs[0]), step_ms_median_per_rank=ms,
                 tokens_per_s=TRAIN_B * TRAIN_S / max(ms) * 1e3,
                 peak_gib_per_rank=[r["peak_gib"] for r in per_rank.values()],
                 losses=[x["loss"] for x in recs[0]], grad_norms=[x["grad_norm"] for x in recs[0]],
                 comp={k: [x[k] for x in recs[0]] for k in recs[0][0] if k.startswith("comp/")},
                 collectives_per_step_rank0=coll,
                 collective_share_rank0=[c / x["ms"] for c, x in zip(coll_ms, recs[0])],
                 kernel4_launches_per_step=k4, whole_leaves_equal_per_step=whole, gates=gates,
                 step_ms_rank0=[x["ms"] for x in recs[0]],
                 one_rank_step_ms=train_ref["one_rank"]["compressed_step_ms" if kind ==
                                                         "compressed" else "plain_step_ms"])
        emit("hy/1x2_ranks", pool_job_s=wall)
    finally:
        HY_REF.unlink(missing_ok=True)
        HY_TRAIN_REF.unlink(missing_ok=True)
    emit("hy/kernels", **kernels_hy)
    return launched


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.synthetic import drifting_spectrum_matrix, powerlaw_matrix
    from repro_torch.kernels import build, ops

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    usage = ptxas_usage(build)
    emit("device", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, build_s=build.build_seconds,
         peaks={"fp32_flops": peaks[0], "hbm_bytes_per_s": peaks[1]})
    # no kernel may spill (kernels 2-4 share the stream-K mainloop)
    emit("ptxas", kernels=usage)
    check(all(any(k.startswith(f"{lib}:") for k in usage) for lib in build.SOURCES),
          "no ptxas usage for some library")
    spills = [k for k, v in usage.items() if v.get("spill_stores", 0) or v.get("spill_loads", 0)]
    check(not spills, f"kernels that spill: {spills}")

    t_start = time.perf_counter()
    mark = lambda done: emit("elapsed", after=done, s=time.perf_counter() - t_start)  # noqa: E731
    kernels = phase_kernels(torch, ops, peaks, dev)
    mark("kernels")

    t0 = time.perf_counter()
    A, _bounds = drifting_spectrum_matrix(SEED, M_ROWS, N_COLS, device=dev)
    torch.cuda.synchronize()
    emit("data", generator="drifting_spectrum_matrix", shape=[M_ROWS, N_COLS], dtype="float32",
         gib=A.numel() * 4 / 2**30, seconds=time.perf_counter() - t0)
    totals, runs, errors = phase_paths(torch, A, dev)
    phase_route_parity(torch, A, runs)
    phase_profile(torch, A, runs)
    mark("a-d")
    launches_e, res_e, ratio_e = run_oneshot(torch, A, dev)
    runs_launches = [launches_e, run_gmr(torch, A, res_e, ratio_e, dev)]
    del res_e
    torch.cuda.empty_cache()
    mark("e, l")
    runs_launches.append(run_sp_svd(torch, A, dev))
    mark("h")
    # the mesh phases' ranks start now, beside (m)-(p): one pool a world size
    for world in (2, 4):
        POOLS[world] = RankPool(torch, world)
    runs_launches += phase_obs(torch, A, runs)
    mark("m: a-d")
    runs_launches += phase_shard(torch, A, runs, errors, dev)
    mark("n: a, c, d, h")
    _, _, K, ci_i = spsd_data(torch, dev)
    make_i = functools.partial(spsd_state, ci_i, dev)
    try:
        runs_launches += phase_resume(torch, A, K, runs, make_i)
        mark("o: resume")
        runs_launches += phase_chaos(torch, A, K, runs, make_i)
        mark("p: chaos")
        runs_launches += phase_mesh(torch, A, K, runs["a_fixed_countsketch"].args[3:5], ci_i,
                                    dev)
        mark("q: mesh")
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    del A, K, runs
    torch.cuda.ipc_collect()  # (q)'s ranks held A and K through CUDA IPC
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    Ab = torch.stack([powerlaw_matrix(SEED + 100 + b, B_ROWS, B_COLS, device=dev)
                      for b in range(BATCH)])
    torch.cuda.synchronize()
    emit("data", generator="powerlaw_matrix", shape=[BATCH, B_ROWS, B_COLS], dtype="float32",
         gib=Ab.numel() * 4 / 2**30, seconds=time.perf_counter() - t0)
    launches_f, res_f = run_batched(torch, Ab, dev, "f_batched_uniform", "uniform")
    launches_g, _ = run_batched(torch, Ab, dev, "g_batched_approx_leverage", "approx_leverage")
    runs_launches += [launches_f, launches_g]
    phase_batched_parity(torch, Ab, res_f, dev)
    phase_profile_batched(torch, Ab, dev)
    runs_launches.append(run_sp_svd_item(torch, Ab[0], dev))
    del Ab, res_f
    torch.cuda.empty_cache()
    mark("f, g, h item")
    runs_launches += run_spsd(torch, dev)
    mark("i-k, m: i, j, n: i")
    with torch.no_grad():  # serving builds no autograd graph (its weights are trainable)
        runs_launches += phase_serve(torch, ops, dev)
        mark("r, s: serve")
        runs_launches += phase_ts(torch, ops, dev)
        mark("ts: serve on a mesh")
        runs_launches += phase_deepseek(torch, ops, dev)
        mark("t: deepseek")
        runs_launches += phase_kimi(torch, ops, dev)
        mark("u: kimi")
        with torch.enable_grad():  # its one-rank training run
            runs_launches += phase_ep(torch, ops, dev, dict(
                kernel4_blocks=kernels["twoside_sketch_ep"],
                kernel1_rank_heads=kernels["countsketch_batched"]["ep"]))
        mark("ep: expert parallel")
        runs_launches += phase_mamba(torch, ops, dev)
        mark("v: mamba2")
        runs_launches += phase_zamba(torch, ops, dev)
        mark("w: zamba2")
        runs_launches += phase_vision(torch, ops, dev)
        mark("x: vision")
    runs_launches += phase_train(torch, ops, dev)
    mark("y: train")
    runs_launches += phase_hy(torch, ops, dev, dict(
        kernel4_blocks=kernels["twoside_sketch_hy"],
        kernel1_rank_heads=kernels["countsketch_batched"]["hy"]))
    emit("train/y_cli", **finish_train_cli())  # (y) gate (5), run beside (hy)
    mark("hy: mamba2, shared and cross attention on a mesh")
    runs_launches += phase_tp(torch, ops, dev, kernels["twoside_sketch_tp"])
    mark("tp: tensor parallel")
    for world in (2, 4):
        close_pool(world)
    for launches in runs_launches:
        for k, v in launches.items():
            totals[k] += v

    rows = []
    for name, info in KERNEL_INFO.items():
        k = kernels[name]
        check(totals[name] > 0, f"{name} never launched on the main path")
        rows.append(dict(name=name, route="cuda", source=info["source"], replaces=info["replaces"],
                         launches=totals[name], max_abs_err=k["max_abs_err"], ms=k["ms"],
                         plain_ms=k["plain_ms"], bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                         library_ms=k["library_ms"]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:  # a failed phase leaves no rank or process behind
        for world in list(POOLS):
            POOLS.pop(world).close(timeout=30.0)
        if Y_CLI and Y_CLI["proc"].poll() is None:
            Y_CLI["proc"].kill()
    sys.exit(rc)
