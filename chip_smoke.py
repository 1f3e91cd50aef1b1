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
   kernel and the device's idle share.

The line before the last lists every kernel with its launches, error and
times; the last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the repository's ``src/repro_torch`` beside it, the script prints
no result and exits 1.
"""

from __future__ import annotations

import importlib
import json
import math
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


def phase_paths(torch, A, dev) -> tuple:
    """The four runs of the main path at full width; launches per run."""
    from repro_torch.cur import (cur_error_ratio, cur_relative_error, select_columns,
                                 select_rows, streaming_cur_finalize, streaming_cur_init)
    from repro_torch.kernels import ops
    from repro_torch.stream.adaptive import adaptive_cur_finalize, adaptive_cur_init
    from repro_torch.stream.engine import stream_panels

    m, n = A.shape

    def gen(k):  # one seeded generator per run, so a run can be rebuilt exactly
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 10 + k)
        return g

    g = gen(0)
    ci = select_columns(g, A, C_BUDGET).idx
    ri = select_rows(g, A, R_BUDGET).idx
    runs = {
        "a_fixed_countsketch": lambda: streaming_cur_init(
            gen(1), m, n, ci, ri, sketch="countsketch", panel=PANEL, device=dev),
        "b_adaptive_countsketch_chunk": lambda: adaptive_cur_init(
            gen(2), m, n, C_BUDGET, ri, sketch="countsketch", panel=PANEL, device=dev),
        "c_adaptive_gaussian_route_b": lambda: adaptive_cur_init(
            gen(3), m, n, C_BUDGET, ri, sketch="gaussian", panel=PANEL, device=dev),
        "d_adaptive_gaussian_evict_rows": lambda: adaptive_cur_init(
            gen(4), m, n, C_BUDGET, None, r=R_BUDGET, sketch="gaussian", panel=PANEL,
            swap_gain=2.0, device=dev),
    }
    num_panels = n // PANEL  # 256 at full size
    need = {  # the kernel each run must go through, and its least launch count
        "a_fixed_countsketch": ("countsketch", num_panels),
        "b_adaptive_countsketch_chunk": ("countsketch", num_panels),
        "c_adaptive_gaussian_route_b": ("panel_update", num_panels),
        "d_adaptive_gaussian_evict_rows": ("panel_score", num_panels),
    }
    totals = {k: 0 for k in ops.LAUNCHES}
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
        emit(f"path/{name}", m=m, n=n, panel=PANEL, panels=num_panels, c=C_BUDGET, r=R_BUDGET,
             s_c=int(state.M.shape[0]), s_r=int(state.M.shape[1]), stream_s=t_stream,
             wall_s=t_total, ms_per_panel=1e3 * t_stream / num_panels, launches=launches,
             cols_admitted=n_cols, rows_filled=n_rows,
             n_evicted=int(getattr(state.ctx, "n_evicted", torch.zeros(())).item()),
             cur_relative_error=rel_err, cur_error_ratio=ratio,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        del state, res
        torch.cuda.empty_cache()
    return totals, runs


def item_errors(A_b, res_b) -> tuple:
    """``(cur_relative_error, cur_error_ratio)`` of one item; the ratio is
    against ``exact_cur`` on the same indices."""
    from repro_torch.cur import cur_error_ratio, cur_relative_error

    return float(cur_relative_error(A_b, res_b)), float(cur_error_ratio(A_b, res_b))


def run_oneshot(torch, A, dev) -> dict:
    """(e): one-shot ``fast_cur`` on the streaming runs' matrix."""
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
    del res
    torch.cuda.empty_cache()
    return launches


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
    t0 = time.perf_counter()
    X, sigma = spsd_points(torch, dev)
    K = rbf_kernel_oracle(X, sigma)(None, None)
    torch.cuda.synchronize()
    emit("data", generator="rbf_kernel_oracle over clustered points", shape=[n, n], d=SPSD_D,
         clusters=SPSD_CLUSTERS, sigma=sigma, dtype="float32", gib=K.numel() * 4 / 2**30,
         seconds=time.perf_counter() - t0)
    ci = torch.randperm(n, generator=gen(torch, dev, SEED + 51), device=dev)[:c]
    runs = {
        "i_streaming_spsd": (lambda: streaming_spsd_init(gen(torch, dev, SEED + 52), n, ci, s=s,
                                                         panel=PANEL, device=dev),
                             streaming_spsd_finalize, ("countsketch", num_panels)),
        # an RBF kernel's columns share most of their energy, so residuals
        # are small against the mean column energy: the default min_gain = 2
        # admits nothing here and 0.5 stops at the first panel's 16 columns
        "j_adaptive_spsd_route_b": (lambda: adaptive_spsd_init(
            gen(torch, dev, SEED + 53), n, c, s=s, sketch="gaussian", min_gain=SPSD_MIN_GAIN,
            panel=PANEL, device=dev), adaptive_spsd_finalize, ("panel_update", num_panels)),
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
    peaks = PEAKS["PCIe"] if "PCIe" in kind else PEAKS["SXM"]
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

    kernels = phase_kernels(torch, ops, peaks, dev)

    t0 = time.perf_counter()
    A, _bounds = drifting_spectrum_matrix(SEED, M_ROWS, N_COLS, device=dev)
    torch.cuda.synchronize()
    emit("data", generator="drifting_spectrum_matrix", shape=[M_ROWS, N_COLS], dtype="float32",
         gib=A.numel() * 4 / 2**30, seconds=time.perf_counter() - t0)
    totals, runs = phase_paths(torch, A, dev)
    phase_route_parity(torch, A, runs)
    phase_profile(torch, A, runs)
    runs_launches = [run_oneshot(torch, A, dev), run_sp_svd(torch, A, dev)]
    del A, runs
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
    runs_launches += run_spsd(torch, dev)
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
