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
   kernel 4's example and ragged shapes, and second
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
   (gitignored) and are removed.

The line before the last lists every kernel with its launches, error and
times; the last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the repository's ``src/repro_torch`` beside it, the script prints
no result and exits 1.
"""

from __future__ import annotations

import functools
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

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
# (m): the estimator's band (the reference's acceptance); (n): data-parallel workers
EST_BAND, WORKERS = 2.0, 4
SEED = 0
# fp32 sums over up to m = 32768 terms, in the kernel's fixed order against
# cuBLAS's / index_add_'s order: relative to the largest entry of the output
TOL = 1e-4
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
    host's launch overhead, which bounds a CUDA-event time of short calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    _, busy, n_ops, _ = device_profile(torch, run)
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
    for tel in (True, False, False, True) * 2:
        times[tel].append(_stream(torch, ops, lambda: make(tel), data, panel)[2])
        torch.cuda.empty_cache()
    t_off, t_on = (sorted(times[tel])[2] for tel in (False, True))
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
RESUME_TIMED = 3  # timed drives per side, taken in turns; saves and restores timed
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


def mesh_rank(rank: int, world: int, port: int, jobs: dict, out_q) -> None:
    """One gloo rank of (q), in its own process on the card: each job's
    column block (a view of the parent's tensor, shared through CUDA IPC)
    through ``mesh_sharded_stream``, launches and ``all_reduce`` calls
    counted over that call alone; then rank 0's merged state is broadcast
    and every rank compares it with its own, and rank 0 holds its state
    against ``simulate_sharded_stream`` at the same W (C, R, indices and
    counters bitwise; M bitwise at W = 2, within ``MESH_M_TOL`` beyond) and,
    for (a) at W = 2, against ``run_resilient_sharded_stream``."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build, ops
    from repro_torch.stream import (ArrayPanelSource, mesh_sharded_stream, padded_n,
                                    run_resilient_sharded_stream, simulate_sharded_stream)

    if any(data.is_cuda for _, data in jobs.values()):
        build.build_all()  # loads the libraries the parent built
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
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
        out_q.put((rank, results))
    finally:
        dist.all_reduce = real
        dist.destroy_process_group()


def spawn_ranks(torch, world: int, jobs: dict, timeout: float = 600.0) -> dict:
    """Run ``mesh_rank`` in ``world`` spawned processes and gather their
    results; a failed rank fails the phase (the others are stopped)."""
    import queue

    mp = torch.multiprocessing
    out_q = mp.get_context("spawn").Queue()
    procs = mp.start_processes(mesh_rank, args=(world, free_port(), jobs, out_q), nprocs=world,
                               join=False, start_method="spawn")
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, out = out_q.get(timeout=1.0)
                results[rank] = out
            except queue.Empty:
                procs.join(timeout=0)  # raises if a rank failed
                check(time.monotonic() < deadline, f"mesh W={world}: ranks did not report")
        while not procs.join(timeout=1.0):
            check(time.monotonic() < deadline, f"mesh W={world}: ranks did not exit")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
    return results


def phase_mesh(torch, A, K, ci_ri, ci_i, dev) -> list:
    """(q): ``mesh_sharded_stream`` in W = 2 and 4 gloo ranks on this one card
    ((a) telemetered, (c), (d), (i); ``mesh_rank``) — the ranks share the
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
        results, wall = host_s(torch, lambda: spawn_ranks(torch, world, jobs))
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
        emit(f"mesh/w{world}", spawn_to_exit_s=wall, shared_operands="CUDA IPC views, no copies")
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
    sys.exit(main())
