#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits nonzero:

0. device — the card's name and power limit; TF32 off; the CUDA kernels
   built from ``src/repro_torch/kernels/csrc`` (first use, timed);
1. kernels — each hand-written kernel (countsketch, panel_score,
   panel_update, twoside_sketch) against its plain PyTorch version on the
   card at the main path's shapes (kernel 1 also at the selection sketches
   of (e) and (g), on A and on the strided view Aᵀ), plus a ragged panel,
   an empty admission, an exhausted budget, tied scores, bf16 inputs, the
   fp32-sketch/bf16-panel pair of a bf16 Gaussian stream (kernel 3 also
   with bf16 C and M, after that pair, fp32 or bf16 sketch and panel),
   kernel 4's example and ragged shapes, and second
   launches of kernels 2-4 compared bitwise; CUDA-event times of the
   kernel, the plain version and one library call, beside the card's bound;
   the stream-K grids of kernels 2 and 3 against the resident slots, and
   every kernel's registers and spills from ``ptxas`` (kernels 2 and 3 must
   not spill);
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
3. route parity — the first 8 panels of (b), (c), (d), and the first 4
   items of (f), with the kernels and with ``force_plain()``: indices
   equal, C (and R) bitwise, M (and U) within tolerance;
4. profile — ``torch.profiler`` over 8 panels of (b), (c), (d) and over
   run (f): device time by kernel and the device's idle share.

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
    k_ms = timed(torch, lambda: ops.countsketch_apply(h, sg, panels[next(it) % n_rot], s, order=order))
    with ops.force_plain():
        p_ms = timed(torch, lambda: ops.countsketch_apply(h, sg, panels[next(it) % n_rot], s))
    signed = [p * sg[:, None] for p in panels]
    acc = torch.zeros((s, L), device=dev)
    lib_ms = timed(torch, lambda: acc.index_add_(0, h.long(), signed[next(it) % n_rot]))
    t_ms = timed(torch, lambda: ops.countsketch_apply(hw, sgw, sca.T, s, transpose_out=True))
    # the M fold's shape: (S_R window · sc_aᵀ)ᵀ, L rows into s buckets, (s, s) out
    signed_t = sca.T * sgw[:, None]
    acc_t = torch.zeros((s, s), device=dev)
    t_lib_ms = timed(torch, lambda: acc_t.index_add_(0, hw.long(), signed_t))
    t_bound = bound_ms(4 * (L * s + 2 * L + s * s), L * s, peaks)
    sel = countsketch_selection(torch, ops, dev, g, peaks)
    b, by = bound_ms(4 * (m * L + 2 * m + s * L), m * L, peaks)
    out["countsketch"] = dict(max_abs_err=max(e_abs, e2[0], *(e[0] for e in sel.values())),
                              max_rel_err=max(e_rel, e2[1], *(e[1] for e in sel.values())),
                              ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b, bound_by=by)
    emit("kernel/countsketch", shape=[s, m, L], rel_err=e_rel, rel_err_apply_t=e2[1],
         rel_err_bf16=e3[1], ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
         library="index_add_ of pre-signed rows", bound_ms=b, bound_by=by,
         apply_t_ms=t_ms, apply_t_shape=[s, L, s], apply_t_library_ms=t_lib_ms,
         apply_t_bound_ms=t_bound[0], apply_t_bound_by=t_bound[1])

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
    out["twoside_sketch"] = kernel_twoside(torch, ops, peaks, dev, g)
    return out


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


def countsketch_selection(torch, ops, dev, g, peaks) -> dict:
    """Kernel 1 at the approx-leverage selection sketches of (e) and (g):
    ``S·A`` and ``S·Aᵀ`` (``select_rows`` hands the kernel the strided view
    ``Aᵀ`` and a row-major output) for a 32768 × 65536 matrix at s = 512, and
    for one 4096 × 4096 item of a stack at s = 256 (s = max(4k, k + 8) for
    k = c = 128 and 64), each against the plain version, beside its bound and
    one sparse product (``torch.sparse.mm`` of the sketch as a COO matrix with
    the same operand, view included)."""
    errs, ms, lib_ms, bounds = {}, {}, {}, {}

    def case(name, a, s):
        h = torch.randint(0, s, (a.shape[0],), generator=g, device=dev, dtype=torch.int32)
        sg = (torch.randint(0, 2, (a.shape[0],), generator=g, device=dev) * 2 - 1).float()
        order = ops.bucket_order(h, s)
        got = ops.countsketch_apply(h, sg, a, s, order=order)
        with ops.force_plain():
            want = ops.countsketch_apply(h, sg, a, s)
        errs[name] = err(got, want)
        check(errs[name][1] <= TOL, f"countsketch {name}: rel err {errs[name][1]} > {TOL}")
        ms[name] = timed(torch, lambda: ops.countsketch_apply(h, sg, a, s, order=order),
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
    emit("kernel/countsketch_selection", rel_err={k: v[1] for k, v in errs.items()},
         abs_err={k: v[0] for k, v in errs.items()}, ms=ms, library_ms=lib_ms,
         library="torch.sparse.mm(S as COO, A or the view A^T)",
         bound_ms={k: v[0] for k, v in bounds.items()}, bound_by={k: v[1] for k, v in bounds.items()},
         shapes={"e": [4 * C_BUDGET, M_ROWS, N_COLS], "g": [4 * B_BUDGET, B_ROWS, B_COLS]})
    return errs


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
    """``torch.profiler`` over panels 2–9 of (b), (c) and (d): device time by
    kernel, the device's busy share of the wall time, launches per panel."""
    from repro_torch.stream.engine import stream_panels

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


def device_profile(torch, fn) -> tuple:
    """``(wall ms, device busy ms, device ops, top 10 [name, ms, count])`` of
    one synchronised call of ``fn`` under ``torch.profiler``: device-side
    entries only (the host ops that launch them report the same time again)."""
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
    return (wall_ms, sum(x[1] for x in dev_us) / 1e3, sum(x[2] for x in dev_us),
            [[k[:60], us / 1e3, n] for k, us, n in top])


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
    # kernels 2 and 3 (the stream-K product, the score stage, the fold's
    # reduction) must not spill
    new = {k: v for k, v in usage.items() if k.startswith(("panel_score:", "panel_update:"))}
    emit("ptxas", kernels=new, others={k: v for k, v in usage.items() if k not in new})
    check(any(k.startswith("panel_score:") for k in new)
          and any(k.startswith("panel_update:") for k in new), "no ptxas usage of kernels 2, 3")
    spills = [k for k, v in new.items() if v.get("spill_stores", 0) or v.get("spill_loads", 0)]
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
    runs_launches = [run_oneshot(torch, A, dev)]
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
