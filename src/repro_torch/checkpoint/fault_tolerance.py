"""A step loop that survives failures (counterpart of
``repro/checkpoint/fault_tolerance.py``).

``run_resilient_loop`` wraps a step function with:

* a checkpoint of the whole state and the data cursor every ``ckpt_every``
  steps and at the end;
* restore from the newest checkpoint and replay after any exception of a
  step (at most ``max_restarts`` times), or from scratch when there is none;
* a step-time watchdog that counts a step slower than ``straggler_factor``
  × the median of the recent steps as a straggler (at least five steps
  since the start or the last restart: the first steps after a restore
  rebuild caches and would be flagged against the old median);
* a deterministic injected failure at ``fail_at_step``, for tests.

The state is any tree :mod:`~repro_torch.checkpoint.checkpoint` walks;
restores put each tensor on its template leaf's device.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

from . import checkpoint as ckpt

log = logging.getLogger("repro_torch.fault_tolerance")

__all__ = ["LoopReport", "run_resilient_loop"]


@dataclasses.dataclass
class LoopReport:
    steps_run: int = 0
    restarts: int = 0
    stragglers: int = 0
    final_metrics: Optional[dict] = None
    losses: list = dataclasses.field(default_factory=list)
    # extra metadata of the last checkpoint restored (at entry or after a
    # failure); None if the loop never restored
    restored_extra: Optional[dict] = None


def run_resilient_loop(
    *,
    state,
    step_fn: Callable,  # (state, batch, step: int) -> (state, metrics)
    batch_fn: Callable,  # step: int -> batch
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 50,
    keep_last: int = 2,
    max_restarts: int = 3,
    straggler_factor: float = 3.0,
    fail_at_step: Optional[int] = None,
    extra_meta: Optional[dict] = None,
) -> LoopReport:
    """Run ``n_steps`` steps of ``step_fn`` from the newest checkpoint in
    ``ckpt_dir`` (or from ``state``), as the module docstring says. A
    step's metrics are read as floats (which waits for the card) before its
    time is taken. Restored checkpoint metadata other than the loop's own
    ``data_state`` is kept on the report and written again by later saves,
    ``extra_meta``'s keys winning."""
    report = LoopReport()

    def _carry_extra(extra: dict):
        nonlocal extra_meta
        report.restored_extra = extra
        carried = {k: v for k, v in extra.items() if k != "data_state"}
        extra_meta = {**carried, **(extra_meta or {})}

    start = 0
    if ckpt.latest_step(ckpt_dir) is not None:
        state, extra, start = ckpt.restore(ckpt_dir, state)
        _carry_extra(extra)
        log.info("resumed from step %d", start)

    step = start
    step_times = []
    restarts = 0
    injected = False

    while step < n_steps:
        try:
            t0 = time.perf_counter()
            if fail_at_step is not None and step == fail_at_step and not injected:
                injected = True
                raise RuntimeError(f"injected node failure at step {step}")
            batch = batch_fn(step)
            state, metrics = step_fn(state, batch, step)
            values = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            if len(step_times) >= 5:
                med = sorted(step_times)[len(step_times) // 2]
                if dt > straggler_factor * med:
                    report.stragglers += 1
                    log.warning("straggler: step %d took %.3fs (median %.3fs)", step, dt, med)
            step_times.append(dt)
            if len(step_times) > 64:
                step_times.pop(0)

            report.steps_run += 1
            report.final_metrics = values
            report.losses.append(values.get("loss", 0.0))
            step += 1
            if step % ckpt_every == 0 or step == n_steps:
                ckpt.save(ckpt_dir, step, state,
                          extra={"data_state": {"step": step}, **(extra_meta or {})},
                          keep_last=keep_last)
        except Exception as e:  # noqa: BLE001 — any step failure triggers a restart
            restarts += 1
            report.restarts = restarts
            if restarts > max_restarts:
                raise RuntimeError(f"exceeded {max_restarts} restarts") from e
            log.warning("step %d failed (%s); restoring the newest checkpoint", step, e)
            if ckpt.latest_step(ckpt_dir) is None:
                step = 0  # no checkpoint yet: replay from scratch
            else:
                state, extra, step = ckpt.restore(ckpt_dir, state)
                _carry_extra(extra)
            step_times = []
    return report
