"""Data-parallel sharded stream ingestion (counterpart of
``repro/stream/distributed.py``).

Every worker holds the same sketches and consumes a disjoint, contiguous,
panel-aligned column range at its global offset. C and R are written in
disjoint slots and blocks of zero buffers and M is a running sum, so the
sum of the workers' accumulators is the single-host state: C and R bit
for bit where the writes are copies, M (and any summed C, as SP-SVD's) up
to the order of its fp32 sums.

Two ways to run the workers, on the same math:

* :func:`simulate_sharded_stream` runs them one after the other in this
  process, each on a :func:`~repro_torch.stream.engine.fresh_state` copy of
  the initial state, and :func:`merge_states` sums them;
* :func:`mesh_sharded_stream` is called by every rank of a
  ``torch.distributed`` group, each streaming its own column block, and
  all-reduces the accumulators once per call (never per panel). It takes
  the place of the reference's ``shard_map`` program, so the reference's
  ``shard_map_compat`` (``repro/distributed/sharding.py``) has no
  counterpart here.

Context that differs between workers (adaptive admission) goes through the
``PanelOps`` hooks ``prep_shard`` / ``bind_shard`` and ``merge_ctx`` (in
process) or ``collective_ctx`` (across ranks), and repairs that need the
merged accumulators (adaptive row dedup) through ``merge_state``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from ..obs.spans import span
from .engine import PanelState, fresh_state, padded_n, stream_panels

__all__ = ["shard_panel_ranges", "merge_states", "simulate_sharded_stream", "mesh_sharded_stream"]


def shard_panel_ranges(n: int, panel: int, num_workers: int) -> List[Tuple[int, int]]:
    """Contiguous, panel-aligned column ranges ``[lo, hi)``, one per worker:
    the panels dealt out as evenly as possible (only the last range can end
    ragged, at ``n``; workers past the panel count get empty ranges)."""
    num_panels = (n + panel - 1) // panel
    bounds = [round(i * num_panels / num_workers) for i in range(num_workers + 1)]
    return [(min(bounds[i] * panel, n), min(bounds[i + 1] * panel, n))
            for i in range(num_workers)]


def merge_states(states: Sequence[PanelState]) -> PanelState:
    """The single-host state of a set of worker states: C, R and M summed,
    the ctxs merged by ``merge_ctx`` (else the first worker's kept), the
    telemetry frames and quarantine counts summed, then ``merge_state``.
    The result has consumed the whole stream (``offset = n``)."""
    states = list(states)
    base = states[0]

    def tot(xs):
        return sum(xs[1:], xs[0])

    ops = base.ops
    ctx = ops.merge_ctx([s.ctx for s in states]) if ops.merge_ctx is not None else base.ctx
    tel = base.tel.merge([s.tel for s in states]) if base.tel is not None else None
    quarantined = None
    if base.quarantined is not None:  # disjoint panel tallies
        quarantined = tot([s.quarantined for s in states])
    merged = dataclasses.replace(
        base, C=tot([s.C for s in states]), R=tot([s.R for s in states]),
        M=tot([s.M for s in states]), offset=base.n, ctx=ctx, tel=tel, quarantined=quarantined)
    return ops.merge_state(merged) if ops.merge_state is not None else merged


def simulate_sharded_stream(state0: PanelState, A, panel: int, num_workers: int, *,
                            route: str = "chunk") -> PanelState:
    """Run ``num_workers`` data-parallel workers over ``A`` in this process
    and merge them (:func:`merge_states`).

    ``prep_shard`` splits the budgets once; then each worker streams its
    range of :func:`shard_panel_ranges` on its own :func:`fresh_state` of
    ``state0`` bound by ``bind_shard(ctx, w)``, starting at its range's
    offset, through :func:`stream_panels` (``route`` as there), and is
    merged into the workers before it as soon as it finishes: the sums are
    taken in worker order as :func:`merge_states` takes them, and merging
    a merged state again is the same merge (its slot ranges start at 0,
    its ``merge_state`` repairs are idempotent). ``state0`` is left as it
    was. Fixed-index streams reproduce the single-host C and
    R bitwise; adaptive workers admit into their own slot ranges, a valid
    admission outcome that is not the single host's.
    """
    if state0.offset != 0:
        raise ValueError(
            "simulate_sharded_stream needs a fresh state: every worker clones state0's "
            f"accumulators, so a partially-streamed prefix would be summed once per worker "
            f"(offset={state0.offset})"
        )
    ops = state0.ops
    n = min(A.shape[1], state0.n)
    ctx0 = ops.prep_shard(state0.ctx, num_workers) if ops.prep_shard is not None else state0.ctx
    base = dataclasses.replace(state0, ctx=ctx0)
    with span(f"stream/{ops.name}/sharded_simulate"):
        merged = None
        for w, (lo, hi) in enumerate(shard_panel_ranges(n, panel, num_workers)):
            st = fresh_state(base)
            if ops.bind_shard is not None:
                st.ctx = ops.bind_shard(st.ctx, w)
            st.offset = lo
            if hi > lo:
                st = stream_panels(st, A, panel, stop=hi, route=route)
            # merged as the workers finish, so one worker's state is alive at a time
            merged = merge_states([st] if merged is None else [merged, st])
        return merged


def mesh_sharded_stream(state0: PanelState, A, panel: int, group=None) -> PanelState:
    """Stream this rank's column block and merge across the ranks of the
    ``torch.distributed`` ``group`` (default: the default group); every rank
    calls it and gets the same merged state.

    With ``W`` ranks and ``n_pad`` the panel-padded column count, rank ``w``
    passes ``A``, its own block: columns ``[w·n_pad/W, (w+1)·n_pad/W)`` of
    the stream, e.g. ``A_full[:, w * n_pad // W:(w + 1) * n_pad // W]`` (a
    view; the last block may end at the true column count, its tail is
    zero-padded). ``n_pad`` must split into whole panels per rank and
    ``state0`` must be fresh (offset 0) and initialised with ``panel=``.

    The rank streams its block on a :func:`fresh_state` copy of ``state0``
    (left as it was) bound by ``bind_shard(ctx, w)`` after ``prep_shard``,
    then all-reduces (SUM) C, R (when it has elements), M and the
    quarantine count, runs ``collective_ctx`` and the frame's
    ``collective`` — a fixed number of collectives per call whatever the
    panel count — sets ``offset = n`` and applies ``merge_state``."""
    import torch.distributed as dist

    if state0.offset != 0:
        raise ValueError(
            "mesh_sharded_stream needs a fresh state: every rank starts from state0's "
            "accumulators, so a partially-streamed prefix would be summed once per rank "
            f"(offset={state0.offset})"
        )
    n = state0.n
    W, w = dist.get_world_size(group), dist.get_rank(group)
    n_pad = padded_n(n, panel)
    if n_pad % W or (n_pad // W) % panel:
        raise ValueError(f"padded column count {n_pad} must split into whole panels per "
                         f"worker (W={W}, panel={panel})")
    if state0.R.shape[1] != n_pad:
        raise ValueError("state was initialised without `panel=`; R is unpadded")
    shard_n = n_pad // W
    if A.shape[1] > shard_n:
        raise ValueError(f"rank {w} got {A.shape[1]} columns, its block has {shard_n}")
    ops = state0.ops
    ctx = ops.prep_shard(state0.ctx, W) if ops.prep_shard is not None else state0.ctx
    st = fresh_state(dataclasses.replace(state0, ctx=ctx))
    if ops.bind_shard is not None:
        st.ctx = ops.bind_shard(st.ctx, w)
    st.offset = lo = w * shard_n
    with span(f"stream/{ops.name}/sharded_mesh"):
        st = stream_panels(st, A, panel, col0=lo)

        def all_sum(t):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            return t

        st.C, st.M = all_sum(st.C), all_sum(st.M)
        if st.R.numel():  # symmetric streams carry the (0, n_pad) placeholder
            st.R = all_sum(st.R)
        if st.quarantined is not None:
            st.quarantined = all_sum(st.quarantined)
        if ops.collective_ctx is not None:
            st.ctx = ops.collective_ctx(st.ctx, group)
        if st.tel is not None:
            st.tel = st.tel.collective(group)
        st.offset = n
        return ops.merge_state(st) if ops.merge_state is not None else st
