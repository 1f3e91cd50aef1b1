#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits nonzero:

0. device — the card's name and power limit; TF32 off; the CUDA kernels
   built from ``src/repro_torch/kernels/csrc`` (first use, timed);
1. kernels — each hand-written kernel (countsketch, panel_score,
   panel_update) against its plain PyTorch version on the card at the main
   path's shapes, plus a ragged panel, an empty admission, an exhausted
   budget, tied scores and bf16 inputs; CUDA-event times of the kernel, the
   plain version and one library call, beside the card's bound;
2. paths — streaming CUR at m = 32768, n = 65536 (fp32 on the card), panel
   L = 256, c = r = 128, Table-2 sketch sizes: (a) fixed, countsketch;
   (b) adaptive, countsketch, admission-only, chunk route; (c) adaptive,
   gaussian, admission-only (Route B: kernel 3 every panel); (d) adaptive,
   gaussian, eviction plus adaptive rows (per-panel body: kernel 2 every
   panel). Launch counts are reset just before and read just after each run;
3. route parity — the first 8 panels of (b), (c), (d) with the kernels and
   with ``force_plain()``: indices equal, C bitwise, M within tolerance;
4. profile — ``torch.profiler`` over 8 panels of (b), (c), (d): device time
   by kernel and the device's idle share.

The line before the last lists every kernel with its launches, error and
times; the last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the repository's ``src/repro_torch`` beside it, the script prints
no result and exits 1.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
M_ROWS, N_COLS, PANEL, C_BUDGET, R_BUDGET = 32768, 65536, 256, 128, 128
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
    b, by = bound_ms(4 * (m * L + 2 * m + s * L), m * L, peaks)
    out["countsketch"] = dict(max_abs_err=max(e_abs, e2[0]), max_rel_err=max(e_rel, e2[1]),
                              ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b, bound_by=by)
    emit("kernel/countsketch", shape=[s, m, L], rel_err=e_rel, rel_err_apply_t=e2[1],
         rel_err_bf16=e3[1], ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
         library="index_add_ of pre-signed rows", bound_ms=b, bound_by=by,
         apply_t_ms=t_ms, apply_t_shape=[s, L, s])

    # --- kernel 2: panel_score ---
    def score_case(a_l, qq, dtype=torch.float32):
        got = ops.panel_score(sc.to(dtype), a_l.to(dtype), qq)
        with ops.force_plain():
            want = ops.panel_score(sc.to(dtype), a_l.to(dtype), qq)
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
    check(ps_err["bf16"][1] <= TOL, f"panel_score bf16: rel err {ps_err['bf16'][1]} > {TOL}")
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
         ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, library="torch.matmul(S_C, A_L), fp32 highest",
         bound_ms=b, bound_by=by)

    # --- kernel 3: panel_update ---
    C0 = torch.randn((m, c), generator=g, device=dev) * (torch.arange(c, device=dev) < c // 2)
    M0 = torch.randn((s, s), generator=g, device=dev)
    base = dict(min_gain=0.5, run_mean=0.0, true_cols=float(L), n_filled=c // 2,
                free=c - c // 2, panel_cap=16)

    def update_case(a_l, qq, kw, dtype=torch.float32, sc_=sc, srt_=srt, C_=C0, M_=M0):
        got = ops.panel_update(sc_.to(dtype), a_l.to(dtype), srt_.to(dtype), qq, C_.clone(),
                               M_.clone(), **kw)
        with ops.force_plain():
            want = ops.panel_update(sc_.to(dtype), a_l.to(dtype), srt_.to(dtype), qq,
                                    C_.clone(), M_.clone(), **kw)
        check(bool(torch.equal(got[5], want[5])), f"panel_update: slots differ {kw}")
        check(bool(torch.equal(got[0], want[0])), "panel_update: C differs")
        errs = [err(x, y) for x, y in zip(got[1:5], want[1:5])]
        return max(e[0] for e in errs), max(e[1] for e in errs), got

    pu_err, admitted = {}, {}
    for name, a_l, kw, srt_ in (
        ("full", panels[0], base, srt),
        ("ragged_L200", panels[1][:, :200], dict(base, true_cols=200.0), srt[:200]),
        ("empty_admission", panels[2], dict(base, min_gain=1e9), srt),
        ("budget_exhausted", panels[3], dict(base, n_filled=c, free=0), srt),
    ):
        e_abs, e_rel, got = update_case(a_l, q, kw, srt_=srt_)
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
    e_abs, e_rel, got = update_case(ai, torch.zeros_like(q), dict(base, min_gain=1.0, free=2),
                                    sc_=sci, srt_=torch.zeros_like(srt))
    r2 = got[3]
    check(bool(r2[7] == r2[70]) and bool(r2[70] == r2[170]) and bool(r2[7] == r2.max()),
          "tie case: duplicated columns must tie at the top")
    check(got[5][7].item() == c // 2 and got[5][70].item() == c // 2 + 1
          and got[5][170].item() == c, "ties must go to the lower index")
    pu_err["ties"] = (e_abs, e_rel)
    pu_err["bf16"] = update_case(panels[0], q, base, torch.bfloat16)[:2]
    check(pu_err["bf16"][1] <= TOL, f"panel_update bf16: rel err {pu_err['bf16'][1]} > {TOL}")
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
         admitted=admitted, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
         library="torch.matmul(S_C, A_L), fp32 highest", bound_ms=b, bound_by=by)
    del A_buf, panels, signed
    torch.cuda.empty_cache()
    return out


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
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.stream.engine import stream_panels

    for name in ("b_adaptive_countsketch_chunk", "c_adaptive_gaussian_route_b",
                 "d_adaptive_gaussian_evict_rows"):
        state = stream_panels(runs[name](), A, PANEL, stop=2 * PANEL)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            stream_panels(state, A, PANEL, stop=10 * PANEL)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()
        # device-side entries only (kernels, copies): the host ops that launch
        # them report the same time again, and the engine's record_function
        # span shows on the device timeline as an annotation covering them
        dev_us = [(e.key, getattr(e, "self_device_time_total", 0.0), e.count) for e in events
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and not e.key.startswith("stream/")]
        dev_us = [x for x in dev_us if x[1] > 0]
        busy_ms = sum(x[1] for x in dev_us) / 1e3
        top = sorted(dev_us, key=lambda x: -x[1])[:10]
        emit(f"profile/{name}", panels=8, wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_idle_share=(1 - busy_ms / wall_ms) if wall_ms > 0 else None,
             device_ops_per_panel=sum(x[2] for x in dev_us) / 8,
             top_device_ms=[[k[:60], us / 1e3, n] for k, us, n in top])
        del state
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.synthetic import drifting_spectrum_matrix
    from repro_torch.kernels import build, ops

    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    peaks = PEAKS["PCIe"] if "PCIe" in kind else PEAKS["SXM"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    ptxas = [ln.strip() for log in build.build_log.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("device", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, build_s=build.build_seconds,
         peaks={"fp32_flops": peaks[0], "hbm_bytes_per_s": peaks[1]}, ptxas=ptxas[:24])

    kernels = phase_kernels(torch, ops, peaks, dev)

    t0 = time.perf_counter()
    A, _bounds = drifting_spectrum_matrix(SEED, M_ROWS, N_COLS, device=dev)
    torch.cuda.synchronize()
    emit("data", generator="drifting_spectrum_matrix", shape=[M_ROWS, N_COLS], dtype="float32",
         gib=A.numel() * 4 / 2**30, seconds=time.perf_counter() - t0)
    totals, runs = phase_paths(torch, A, dev)
    phase_route_parity(torch, A, runs)
    phase_profile(torch, A, runs)

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
