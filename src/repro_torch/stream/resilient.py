"""Resilient streaming ingestion: resumable stream states, fault injection,
graceful degradation (counterpart of ``repro/stream/resilient.py``).

A crash at panel k of a single-pass stream loses the whole ingest unless
the carried :class:`~repro_torch.stream.engine.PanelState` (C, R, M, the
application's ctx, the telemetry frame) is kept. This module owns the
fault story in three layers:

* **Resumable streams** — :func:`run_resilient_stream` pulls fixed chunks
  of panels from a :class:`PanelSource`, drives each through
  :func:`~repro_torch.stream.engine.stream_panels` at the state's offset,
  checkpoints the whole state every ``ckpt_every`` chunks through
  :mod:`repro_torch.checkpoint` (packed layout, ``.part`` + rename, torn
  checkpoints skipped) with a ``panels_consumed`` cursor, and on restart
  replays only the panels not yet consumed. The per-panel updates depend
  only on the panel sequence and no kernel sums floats in an order that
  changes between runs, so a resumed run equals the uninterrupted one bit
  for bit at the same chunk cadence (Ψ folds once per chunk).
* **Fault injection** — :class:`FaultPlan` (crash at a panel, NaN panels,
  dropped, duplicated or late deliveries) applied by :class:`FaultInjector`
  at the source boundary, so the driver's retry, dedup and restart handling
  runs unmodified.
* **Graceful degradation** — :func:`~repro_torch.stream.engine.with_quarantine`
  arms the non-finite panel guard: a corrupt panel contributes exactly what
  an all-zero panel would, the state counts it, telemetry flags it with
  ``EVENT_QUARANTINED``, and the driver mirrors the count into
  :mod:`repro_torch.obs.metrics`. ``strict=True`` instead rolls back to
  the last checkpoint and raises :class:`QuarantineAbort`.

The engine updates the accumulators in place, where the reference donates
them: the driver keeps a :func:`~repro_torch.stream.engine.fresh_state`
copy taken before the first chunk, and a restart or rollback restores from
disk (fresh tensors; only the read-only sketches are shared) or from a new
copy of it, never from the state a failed chunk touched. Arming quarantine
arms a shallow copy, never the caller's object.

Distributed resume: :func:`run_resilient_sharded_stream` gives every worker
of the :func:`~repro_torch.stream.distributed.simulate_sharded_stream`
partition its own checkpoint directory, so one worker's crash restores
that worker's range and re-merges, equal to the all-healthy run and to
:func:`~repro_torch.stream.distributed.mesh_sharded_stream`'s.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import List, Optional, Protocol, Tuple

import torch

from ..checkpoint.checkpoint import latest_step, restore, save
from ..obs.metrics import default_registry
from ..obs.spans import span
from .distributed import merge_states, shard_panel_ranges
from .engine import PanelState, fresh_state, padded_n, stream_panels, with_quarantine

__all__ = [
    "PanelSource",
    "ArrayPanelSource",
    "FaultPlan",
    "FaultInjector",
    "TransientReadError",
    "InjectedCrash",
    "QuarantineAbort",
    "StreamReport",
    "save_stream_state",
    "restore_stream_state",
    "run_resilient_stream",
    "run_resilient_sharded_stream",
]


class TransientReadError(RuntimeError):
    """A chunk read failed in a retryable way (dropped delivery)."""


class InjectedCrash(RuntimeError):
    """Deterministic stand-in for process death, raised before the chunk
    holding ``FaultPlan.crash_at_panel`` is consumed."""


class QuarantineAbort(RuntimeError):
    """Strict mode: a non-finite panel was seen and the stream state rolled
    back to the last checkpoint. ``state`` (fresh) and ``panels_consumed``
    are where to resume once the source is repaired."""

    def __init__(self, msg: str, *, state: PanelState, panels_consumed: int):
        super().__init__(msg)
        self.state = state
        self.panels_consumed = panels_consumed


class PanelSource(Protocol):
    """Pull-model panel stream with idempotent, addressable chunk reads.

    ``read_chunk(lo_panel, num_panels)`` returns ``(tag, chunk)``: the
    ``num_panels · panel`` columns from panel ``lo_panel`` (zero-padded past
    the true column count ``n``) and the panel the delivery really starts
    at — the driver asks again on a stale tag (a duplicated delivery).
    Replays after a restore read the same panels again."""

    panel: int
    n: int
    num_panels: int

    def read_chunk(self, lo_panel: int, num_panels: int) -> Tuple[int, torch.Tensor]:
        ...


class ArrayPanelSource:
    """:class:`PanelSource` over a tensor ``A`` held in memory; a chunk is a
    view of ``A`` (a zero-padded copy at the ragged end)."""

    def __init__(self, A: torch.Tensor, panel: int, *, n: Optional[int] = None):
        self.A = A
        self.panel = panel
        self.n = A.shape[1] if n is None else n
        self.num_panels = padded_n(self.n, panel) // panel

    def read_chunk(self, lo_panel: int, num_panels: int) -> Tuple[int, torch.Tensor]:
        start = lo_panel * self.panel
        stop = min(start + num_panels * self.panel, self.n)
        chunk = self.A[:, start:stop]
        want = num_panels * self.panel
        if chunk.shape[1] < want:
            chunk = torch.nn.functional.pad(chunk, (0, want - chunk.shape[1]))
        return lo_panel, chunk


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic per-panel fault schedule (global panel ids).

    Crash, drop, duplicate and straggle fire on the first read that covers
    their panel and never again, so a replay sees a healthy source, as
    after a real transient. ``corrupt_panels`` is persistent: every read of
    them returns NaN there, so the quarantine outcome is the same on replay.
    """

    crash_at_panel: Optional[int] = None  # raise InjectedCrash before consuming it
    corrupt_panels: Tuple[int, ...] = ()  # NaN-fill these panels (persistent)
    drop_panels: Tuple[int, ...] = ()  # first read covering it raises (one-shot)
    duplicate_panels: Tuple[int, ...] = ()  # first read re-delivers the previous chunk
    straggler_panels: Tuple[int, ...] = ()  # first read sleeps straggler_delay_s
    straggler_delay_s: float = 0.01


class FaultInjector:
    """A :class:`PanelSource` with a :class:`FaultPlan` applied at its read
    boundary. Stateful (one-shot flags, the last delivery for duplicates)
    and meant to be shared across restarts, so a replayed read sees the
    source after the fault. NaN goes into a clone of the chunk, never into
    the wrapped source's data."""

    def __init__(self, source: PanelSource, plan: FaultPlan):
        self.source = source
        self.plan = plan
        self.panel = source.panel
        self.n = source.n
        self.num_panels = source.num_panels
        self._crashed = False
        self._dropped: set = set()
        self._duplicated: set = set()
        self._delayed: set = set()
        self._last: Optional[Tuple[int, torch.Tensor]] = None

    def read_chunk(self, lo_panel: int, num_panels: int) -> Tuple[int, torch.Tensor]:
        covered = range(lo_panel, lo_panel + num_panels)
        plan = self.plan
        if plan.crash_at_panel is not None and plan.crash_at_panel in covered and not self._crashed:
            self._crashed = True
            raise InjectedCrash(f"injected crash before consuming panel {plan.crash_at_panel}")
        for t in plan.drop_panels:
            if t in covered and t not in self._dropped:
                self._dropped.add(t)
                raise TransientReadError(f"injected drop of panel {t}")
        for t in plan.straggler_panels:
            if t in covered and t not in self._delayed:
                self._delayed.add(t)
                time.sleep(plan.straggler_delay_s)
        for t in plan.duplicate_panels:
            if t in covered and t not in self._duplicated and self._last is not None:
                self._duplicated.add(t)
                return self._last  # a stale tag: the driver asks again
        tag, chunk = self.source.read_chunk(lo_panel, num_panels)
        bad = [t for t in plan.corrupt_panels if t in covered]
        if bad:
            chunk = chunk.clone()
            for t in bad:
                rel = (t - lo_panel) * self.panel
                chunk[:, rel : rel + self.panel] = float("nan")
        self._last = (tag, chunk)
        return tag, chunk


@dataclasses.dataclass
class StreamReport:
    """Host-side outcome of one resilient drive (per worker when sharded)."""

    chunks: int = 0  # chunks consumed (replayed ones included)
    panels_consumed: int = 0  # the cursor after the drive
    retries: int = 0  # dropped or duplicated deliveries asked for again
    restarts: int = 0  # in-process restore-and-replay cycles
    checkpoints: int = 0  # checkpoints written
    quarantined: Optional[int] = None  # the final quarantine count, when armed
    resumed_from: Optional[int] = None  # the cursor restored at entry


def save_stream_state(directory: str, state: PanelState, panels_consumed: int, *,
                      keep_last: int = 3, extra: Optional[dict] = None, durable: bool = True,
                      async_: bool = False):
    """Checkpoint ``state`` at step ``panels_consumed`` (so the newest step
    is the furthest cursor) in the packed layout, with the cursor and the
    stream's name in the metadata. ``ops`` and ``n`` are static: they come
    from the restore template. ``async_`` copies to host before it returns
    and writes on a thread (returned); ``durable=False`` skips the fsync."""
    meta = {"panels_consumed": int(panels_consumed), "stream": state.ops.name, **(extra or {})}
    return save(directory, int(panels_consumed), state, extra=meta, keep_last=keep_last,
                durable=durable, async_=async_, pack=True)


def restore_stream_state(directory: str, template: PanelState, *, step=None):
    """``(state, panels_consumed, extra)`` from the newest intact checkpoint
    (or ``step``). ``template`` gives the structure, ``ops``, ``n`` and the
    device; the state's tensors are fresh (the read-only sketches are the
    template's when equal), so it shares no accumulator with the template."""
    tree, extra, step = restore(directory, template, step=step)
    return tree, int(extra.get("panels_consumed", step)), extra


def _read_with_retry(source, lo_panel, num, *, max_retries, backoff_s, report, reg):
    """One chunk read with bounded retries: a transient error backs off
    exponentially, a stale tag (duplicated delivery) is asked for again."""
    for attempt in range(max_retries + 1):
        try:
            tag, chunk = source.read_chunk(lo_panel, num)
        except TransientReadError:
            if attempt >= max_retries:
                raise
            report.retries += 1
            reg.inc("stream/resilient/retries")
            if backoff_s:
                time.sleep(backoff_s * (2**attempt))
            continue
        if tag != lo_panel:
            if attempt >= max_retries:
                raise TransientReadError(
                    f"chunk at panel {lo_panel} kept arriving with stale tag {tag}")
            report.retries += 1
            reg.inc("stream/resilient/retries")
            continue
        return chunk
    raise TransientReadError(f"chunk at panel {lo_panel} failed after retries")


def _armed(state: PanelState, quarantine: bool) -> PanelState:
    """``state``, or a shallow copy of it with the quarantine guard armed."""
    return with_quarantine(copy.copy(state)) if quarantine and state.quarantined is None else state


def run_resilient_stream(
    state: PanelState,
    source: PanelSource,
    *,
    chunk_panels: int = 4,
    start_panel: Optional[int] = None,
    stop_panel: Optional[int] = None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 2,
    keep_last: int = 3,
    max_retries: int = 3,
    backoff_s: float = 0.0,
    max_restarts: int = 0,
    strict: bool = False,
    quarantine: bool = False,
    durable: bool = False,
    resume: bool = True,
) -> Tuple[PanelState, StreamReport]:
    """Drive panels ``[start_panel, stop_panel)`` of ``source`` through the
    engine, ``chunk_panels`` at a time, with checkpoint, retry and restart
    handling. ``state``'s accumulators are updated in place (keep only the
    returned state). Two drives over the same source at the same
    ``chunk_panels`` give the same bits whatever crashes and restores
    either went through.

    * ``ckpt_dir`` — checkpoint every ``ckpt_every`` chunks and at the end,
      and resume: if the directory holds an intact checkpoint, restore it
      (``state`` then serves only as the template) and replay only the
      panels not yet consumed;
    * ``max_restarts`` — in-process restore-and-replay budget for
      :class:`InjectedCrash`; beyond it the crash propagates and a later
      invocation resumes from ``ckpt_dir``;
    * ``resume=False`` — ``ckpt_dir`` is write-only: earlier drives'
      checkpoints are ignored (and overwritten), and restarts restore only
      what this drive wrote;
    * ``quarantine`` — arm the non-finite panel guard (on a shallow copy);
      ``strict=True`` rolls back to the last checkpoint on a quarantined
      panel and raises :class:`QuarantineAbort`;
    * checkpoints are packed (one write and one rename per save);
      ``durable`` (default off: the fault model is process death, where the
      rename alone is atomic) adds an fsync per save.
    """
    panel = source.panel
    state = _armed(state, quarantine or strict)
    start = state.offset // panel if start_panel is None else start_panel
    stop = source.num_panels if stop_panel is None else stop_panel
    report = StreamReport()
    reg = default_registry()
    # a pristine copy for restarts from scratch and rollbacks, and the
    # restore template, taken before any chunk updates the state in place
    state0 = fresh_state(state)
    cursor = start
    last_saved: Optional[int] = None  # the newest step this drive wrote
    if resume and ckpt_dir is not None and latest_step(ckpt_dir) is not None:
        state, cursor, _ = restore_stream_state(ckpt_dir, state0)
        report.resumed_from = cursor
        last_saved = cursor

    def _rolled_back() -> Tuple[PanelState, int]:
        """A fresh state and cursor to go on from after a failure: the
        newest checkpoint (any, when resuming; else this drive's own), or
        the start."""
        step = None
        if ckpt_dir is not None:
            step = latest_step(ckpt_dir) if resume else last_saved
        if step is None:
            return fresh_state(state0), start
        st, cur, _ = restore_stream_state(ckpt_dir, state0, step=step)
        return st, cur

    armed = state.quarantined is not None
    q_seen = int(state.quarantined) if armed else 0
    chunks_since_ckpt = 0
    with span(f"stream/{state.ops.name}/resilient"):
        while cursor < stop:
            num = min(chunk_panels, stop - cursor)
            try:
                chunk = _read_with_retry(source, cursor, num, max_retries=max_retries,
                                         backoff_s=backoff_s, report=report, reg=reg)
            except InjectedCrash:
                if report.restarts >= max_restarts:
                    raise
                report.restarts += 1
                reg.inc("stream/resilient/restarts")
                state, cursor = _rolled_back()
                q_seen = int(state.quarantined) if armed else 0
                chunks_since_ckpt = 0
                continue
            state = stream_panels(state, chunk, panel, col0=cursor * panel)
            report.chunks += 1
            if armed:
                q_now = int(state.quarantined)
                if q_now > q_seen:
                    reg.inc("stream/resilient/quarantined", q_now - q_seen)
                    if strict:
                        st, cur = _rolled_back()
                        raise QuarantineAbort(
                            f"non-finite panel in chunk [{cursor}, {cursor + num}); "
                            f"state rolled back to panel {cur}",
                            state=st, panels_consumed=cur)
                q_seen = q_now
            cursor += num
            chunks_since_ckpt += 1
            if ckpt_dir is not None and (chunks_since_ckpt >= ckpt_every or cursor >= stop):
                save_stream_state(ckpt_dir, state, cursor, keep_last=keep_last, durable=durable)
                last_saved = cursor
                report.checkpoints += 1
                reg.inc("stream/resilient/checkpoints")
                chunks_since_ckpt = 0
    report.panels_consumed = cursor
    if armed:
        report.quarantined = q_seen
    return state, report


def run_resilient_sharded_stream(
    state0: PanelState,
    source: PanelSource,
    num_workers: int,
    *,
    ckpt_dir: Optional[str] = None,
    chunk_panels: int = 4,
    ckpt_every: int = 2,
    keep_last: int = 3,
    max_retries: int = 3,
    backoff_s: float = 0.0,
    max_restarts: int = 0,
    strict: bool = False,
    quarantine: bool = False,
    durable: bool = False,
    resume: bool = True,
) -> Tuple[PanelState, List[StreamReport]]:
    """The resilient :func:`~repro_torch.stream.distributed.simulate_sharded_stream`:
    every worker drives its contiguous panel range through
    :func:`run_resilient_stream` with its own checkpoint directory
    (``<ckpt_dir>/worker_<w>``), then the workers merge as on the healthy
    path (:func:`~repro_torch.stream.distributed.merge_states`).

    A crash in one worker loses at most that worker's panels since its
    checkpoint: invoking again with the same ``ckpt_dir`` resumes every
    finished worker from its final checkpoint (replaying nothing), restores
    the crashed one, and merges to the all-healthy result. ``state0`` must
    be fresh (offset 0) and is only a template — each worker streams its
    own copy — so it survives a crashed invocation and can be passed again.
    """
    if state0.offset != 0:
        raise ValueError(
            "run_resilient_sharded_stream needs a fresh state: every worker clones "
            f"state0's accumulators (offset={state0.offset})")
    panel = source.panel
    state0 = _armed(state0, quarantine or strict)
    ops = state0.ops
    ctx0 = ops.prep_shard(state0.ctx, num_workers) if ops.prep_shard is not None else state0.ctx
    base = dataclasses.replace(state0, ctx=ctx0)
    shards: List[PanelState] = []
    reports: List[StreamReport] = []
    for w, (lo, hi) in enumerate(shard_panel_ranges(source.n, panel, num_workers)):
        st = fresh_state(base)
        if ops.bind_shard is not None:
            st.ctx = ops.bind_shard(st.ctx, w)
        st.offset = lo
        lo_p = lo // panel
        hi_p = lo_p + padded_n(hi - lo, panel) // panel
        wdir = os.path.join(ckpt_dir, f"worker_{w:02d}") if ckpt_dir else None
        st, rep = run_resilient_stream(
            st, source, chunk_panels=chunk_panels, start_panel=lo_p, stop_panel=hi_p,
            ckpt_dir=wdir, ckpt_every=ckpt_every, keep_last=keep_last, max_retries=max_retries,
            backoff_s=backoff_s, max_restarts=max_restarts, strict=strict,
            quarantine=quarantine, durable=durable, resume=resume)
        shards.append(st)
        reports.append(rep)
    return merge_states(shards), reports
