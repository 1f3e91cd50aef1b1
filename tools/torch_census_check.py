"""Scan-body census gate of the port: the chunk route against the per-panel
body (counterpart of ``tools/census_check.py``, which gates the reference's
compiled programs and stays as it is).

Censuses the engine's ``scan_panels`` with ``fused=True`` (the chunk route:
the chunk's sketch hoisted out of the panel loop) and ``fused=False`` (the
per-panel body) on the reference's two configs — fixed-index streaming CUR
at 512 × 512, panel 128, c = r = 16, and adaptive CUR at 2048 × 1024, panel
256, c = 16, fixed rows, ``panel_cap=4`` — with CountSketch cores, through
:func:`repro_torch.launch.hlo_census.census_stream_program`, and fails (exit
1) when:

  * the chunk route's scan-body bytes a panel are not at most 0.75 × the
    per-panel body's (``scan_body_bytes_per_panel``: one panel in steady
    state, the difference of the censuses of N and 2N panels over N), or
  * its whole-program bytes a panel exceed the per-panel body's, or
  * any censused number exceeds its committed budget in
    ``tools/torch_census_budget.json`` by more than the tolerance (10 %).

The census counts the ops the port dispatches. It runs on the CPU with the
kernel route forced (``ops._FORCE_KERNEL_ROUTE``): each kernel wrapper
counts one launch with its bound's bytes and its plain version is not
counted, so the numbers are the card's program's; no card is needed.
Regenerate the budget after an intentional change with::

  PYTHONPATH=src python tools/torch_census_check.py --update
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

BUDGET_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_census_budget.json")

# committed gate constants (the reference's)
FUSED_BODY_MAX_RATIO = 0.75  # the chunk route's scan body must be >= 25 % leaner
TOLERANCE = 0.10

METRICS = ("bytes_per_panel", "scan_body_bytes_per_panel", "n_ops", "scan_body_n_ops")


def _configs():
    """(name, state, A, panel) for the censused programs."""
    from repro_torch.cur.streaming import streaming_cur_init
    from repro_torch.stream.adaptive import adaptive_cur_init

    out = []
    m, n, panel, c, r = 512, 512, 128, 16, 16
    st = streaming_cur_init(torch.Generator().manual_seed(0), m, n,
                            col_idx=torch.arange(c), row_idx=torch.arange(r),
                            sketch="countsketch", panel=panel, device="cpu")
    out.append((f"streaming_cur/{m}x{n}_p{panel}_c{c}", st, torch.zeros((m, n)), panel))

    m, n, panel, c, r = 2048, 1024, 256, 16, 16
    st = adaptive_cur_init(torch.Generator().manual_seed(1), m, n, c, row_idx=torch.arange(r),
                           panel_cap=4, sketch="countsketch", panel=panel, device="cpu")
    out.append((f"adaptive_cur/{m}x{n}_p{panel}_c{c}", st, torch.zeros((m, n)), panel))
    return out


def measure() -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch.hlo_census import census_stream_program

    results = {}
    prev, ops._FORCE_KERNEL_ROUTE = ops._FORCE_KERNEL_ROUTE, True
    try:
        for name, st, A, panel in _configs():
            pair = {}
            for fused in (True, False):
                cen = census_stream_program(st, A, panel, fused=fused)
                pair["fused" if fused else "unfused"] = {k: cen[k] for k in METRICS}
            results[name] = pair
    finally:
        ops._FORCE_KERNEL_ROUTE = prev
    return results


def check(results: dict, budget: dict | None) -> list:
    """The gate's failures (messages) for ``results`` against ``budget``."""
    failures = []
    for name, pair in results.items():
        f, u = pair["fused"], pair["unfused"]
        body_ratio = f["scan_body_bytes_per_panel"] / max(u["scan_body_bytes_per_panel"], 1.0)
        total_ratio = f["bytes_per_panel"] / max(u["bytes_per_panel"], 1.0)
        print(f"{name}:")
        print(f"  scan-body bytes/panel   fused {f['scan_body_bytes_per_panel']:.3e}  "
              f"unfused {u['scan_body_bytes_per_panel']:.3e}  ratio {body_ratio:.3f}")
        print(f"  whole-program bytes/panel fused {f['bytes_per_panel']:.3e}  "
              f"unfused {u['bytes_per_panel']:.3e}  ratio {total_ratio:.3f}")
        print(f"  n_ops fused {f['n_ops']:.0f} unfused {u['n_ops']:.0f}  "
              f"scan-body n_ops fused {f['scan_body_n_ops']:.0f} "
              f"unfused {u['scan_body_n_ops']:.0f}")
        if body_ratio > FUSED_BODY_MAX_RATIO:
            failures.append(f"{name}: fused scan-body bytes/panel ratio {body_ratio:.3f} > "
                            f"{FUSED_BODY_MAX_RATIO} (fused body must be >=25% leaner)")
        if total_ratio > 1.0:
            failures.append(f"{name}: fused whole-program bytes/panel ratio {total_ratio:.3f} "
                            "> 1.0 (the chunk hoist must not cost more than it saves)")
    if budget is None:
        return failures + [f"no committed budget at {BUDGET_PATH}: run with --update and "
                           "commit it"]
    tol = budget.get("tolerance", TOLERANCE)
    for name, pair in results.items():
        committed = budget.get("configs", {}).get(name)
        if committed is None:
            failures.append(f"{name}: missing from committed budget — rerun --update")
            continue
        for variant in ("fused", "unfused"):
            for metric in METRICS:
                fresh, limit = pair[variant][metric], committed[variant][metric] * (1.0 + tol)
                if fresh > limit:
                    failures.append(f"{name}/{variant}/{metric}: {fresh:.4e} exceeds committed "
                                    f"{committed[variant][metric]:.4e} (+{tol:.0%} tol)")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--update", action="store_true",
                    help="write the measured numbers as the new committed budget")
    args = ap.parse_args(argv)

    results = measure()
    if args.update:
        budget = {"fused_body_max_ratio": FUSED_BODY_MAX_RATIO, "tolerance": TOLERANCE,
                  "configs": results}
        with open(BUDGET_PATH, "w") as fh:
            json.dump(budget, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"wrote {BUDGET_PATH}")
    budget = None
    if os.path.exists(BUDGET_PATH):
        with open(BUDGET_PATH) as fh:
            budget = json.load(fh)
    failures = check(results, budget)
    if failures:
        print("\nCENSUS GATE FAILURES:", file=sys.stderr)
        for msg in failures:
            print(f"  - {msg}", file=sys.stderr)
        return 1
    print("\ncensus gate OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
