"""Stream telemetry: a per-panel diagnostics frame carried by the streaming
engine (counterpart of ``repro/obs/telemetry.py``).

A :class:`TelemetryFrame` of fixed-shape tensors lives in
``PanelState.tel``; the application's ``PanelOps.telemetry`` hook folds one
panel's diagnostics into it after the panel's C/R/M updates, in place.
Everything is indexed by the global panel id ``t = offset // panel``:

* opt-in and inert: ``tel=None`` (the default) and the engine runs exactly
  what it runs without telemetry;
* read-only with respect to the factors: the hook runs after the updates
  and writes only the frame, so C, R, M and the indices are the same bits
  with telemetry on or off;
* per-panel slots are written by the one worker that streamed the panel,
  and the running sums (``energy_mass``, ``psi``, ``panels_seen``) are sums
  of per-panel terms, so worker frames merge by summation
  (:meth:`TelemetryFrame.merge`), as C, R and M do.

The frame also carries the error estimator's test sketch: ``psi``
accumulates ``Ψ = A Ω_test``, folded by the engine as one fp32
``torch.matmul`` over each consumed window (:func:`fold_psi_chunk`;
:func:`repro_torch.obs.error_estimate.estimate_rel_error` reads it).
Per-panel values are panel-local, never cumulative: ``admitted[t]`` counts
the columns admitted in panel ``t``, ``occupancy[t]`` the worker's filled
slots after it. Decode ``events`` with the ``EVENT_*`` bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "TelemetryFrame",
    "init_telemetry",
    "check_telemetry",
    "adaptive_stream_telemetry",
    "fixed_stream_telemetry",
    "fold_psi_chunk",
    "telemetry_summary",
    "EVENT_ADMIT",
    "EVENT_EVICT",
    "EVENT_ROW_ADMIT",
    "EVENT_BUDGET_FULL",
    "EVENT_QUARANTINED",
]

# ``events`` bitmask: what happened in panel t (the reference's values)
EVENT_ADMIT = 1  # ≥1 column admitted
EVENT_EVICT = 2  # ≥1 column evicted (swap_gain policy)
EVENT_ROW_ADMIT = 4  # ≥1 row admitted (adaptive rows)
EVENT_BUDGET_FULL = 8  # the worker's column budget is full after this panel
EVENT_QUARANTINED = 16  # the panel carried NaN/Inf and was zero-scaled

_QUANTILES = (0.0, 25.0, 50.0, 75.0, 100.0)
# the fields worker frames merge by summation (all but ``omega``)
_SUMMED = ("admitted", "evicted", "rows_admitted", "occupancy", "events", "panel_scores",
           "panel_energy", "energy_mass", "psi", "panels_seen")


@dataclasses.dataclass
class TelemetryFrame:
    """Fixed-shape per-panel diagnostics, carried in ``PanelState.tel``.

    ``P = ceil(n / panel)`` panel slots, indexed by global panel id; the
    dtypes are the reference's. ``omega`` is the estimator's test sketch, a
    constant shared by every worker copy (``FRESH_SHARED``) and kept once by
    :meth:`merge`.
    """

    FRESH_SHARED = ("omega",)  # read-only fields fresh_state does not clone

    admitted: torch.Tensor  # (P,) int32 — columns admitted in panel t
    evicted: torch.Tensor  # (P,) int32 — columns evicted in panel t
    rows_admitted: torch.Tensor  # (P,) int32 — rows admitted in panel t
    occupancy: torch.Tensor  # (P,) int32 — filled slots after panel t (worker-local)
    events: torch.Tensor  # (P,) int32 — EVENT_* bitmask of panel t
    panel_scores: torch.Tensor  # (P, panel) f32 — raw column scores (padded columns 0)
    panel_energy: torch.Tensor  # (P,) f32 — Σ sketched column energy of panel t
    energy_mass: torch.Tensor  # () f32 — running Σ panel_energy
    psi: torch.Tensor  # (m, q) f32 — running Ψ = A Ω_test
    omega: torch.Tensor  # (n_pad, q) f32 — the test sketch Ω_test (rows ≥ n zero)
    panels_seen: torch.Tensor  # () int32 — panels folded into this frame
    panel: int
    n: int

    def merge(self, frames) -> "TelemetryFrame":
        """Sum worker frames into the single-stream frame: per-panel slots
        are disjoint writes into zeros and the rest running sums, so the sum
        is the single stream's frame (up to the float order of ``psi`` and
        ``energy_mass``); ``omega`` is kept once."""

        def tot(name):
            xs = [getattr(f, name) for f in frames]
            return sum(xs[1:], xs[0])

        return dataclasses.replace(frames[0], **{name: tot(name) for name in _SUMMED},
                                   omega=self.omega)

    def collective(self, group=None) -> "TelemetryFrame":
        """:meth:`merge` across the ranks of a ``torch.distributed`` group,
        in place: one ``all_reduce(SUM)`` per summed field; ``omega``, the
        same on every rank, is left alone (a sum would scale it by W)."""
        import torch.distributed as dist

        for name in _SUMMED:
            dist.all_reduce(getattr(self, name), op=dist.ReduceOp.SUM, group=group)
        return self


def check_telemetry(telemetry: bool, panel: Optional[int]) -> None:
    """The inits' rule: a frame is indexed by global panel id, so
    ``telemetry=True`` needs a fixed ``panel=`` width."""
    if telemetry and panel is None:
        raise ValueError(
            "telemetry=True requires a fixed panel= width (the diagnostics frame is "
            "indexed by global panel id)"
        )


def init_telemetry(gen: Optional[torch.Generator], m: int, n: int, panel: int, *, q: int = 16,
                   omega=None, device=None) -> TelemetryFrame:
    """A zero :class:`TelemetryFrame` and the estimator's test sketch.

    ``m`` is the stream's row count (``n`` for a kernel stream), ``n`` its
    true column count, ``panel`` the width it will be driven with. ``Ω_test``
    (``n × q``, N(0, 1), rows past ``n`` zero so a zero-padded tail adds
    nothing to ``Ψ``) is the tensor ``omega`` when given (at least ``n``
    rows, e.g. the reference's draw through
    :func:`repro_torch.convert.stream_init_inputs`: ``q`` is then its
    width) or drawn from ``gen``, which
    must be independent of the core sketches' draws to keep the estimator
    held out. The frame lives on ``device`` (default: ``gen``'s).
    """
    n_pad = -(-n // panel) * panel
    P = n_pad // panel
    if omega is None:
        if gen is None:
            raise ValueError("telemetry needs a generator or a pre-drawn `omega`")
        dev = torch.device(device) if device is not None else gen.device
        om = torch.randn((n_pad, q), generator=gen, device=gen.device, dtype=torch.float32).to(dev)
    else:
        om = omega.float()
        dev = torch.device(device) if device is not None else om.device
        q = om.shape[1]
        om = torch.nn.functional.pad(om[:n], (0, 0, 0, n_pad - n)).to(dev)
    om[n:] = 0.0
    zi = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)  # noqa: E731
    zf = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
    return TelemetryFrame(
        admitted=zi(P), evicted=zi(P), rows_admitted=zi(P), occupancy=zi(P), events=zi(P),
        panel_scores=zf(P, panel), panel_energy=zf(P), energy_mass=zf(), psi=zf(m, q),
        omega=om.contiguous(), panels_seen=zi(), panel=panel, n=n,
    )


def _fold_panel(tel: TelemetryFrame, A_L, sc_a, scores, off: int) -> tuple:
    """The application-independent fold of the columns ``[off, off + W)``:
    their score rows and energies, ``W`` the placeholder's width (one panel,
    or a whole chunk of panels when the ops have no per-panel ctx update).
    Scores are ``scores[0]`` when given (with energies ``scores[1]``), else
    the sketched column energies; padded tail columns count 0. Returns the
    frame and the first panel id."""
    W = A_L.shape[1]
    P = W // tel.panel
    t = off // tel.panel
    if scores is None:
        y = sc_a.float()
        energy = torch.sum(y * y, dim=0)
        svec = energy
    else:
        svec, energy = (x.float() for x in scores)
    valid = min(max(tel.n - off, 0), W)
    if valid < W:  # mask the zero-padded tail columns
        keep = torch.arange(W, device=energy.device) < valid
        energy = torch.where(keep, energy, 0.0)
        svec = torch.where(keep, svec, 0.0)
    tel.panel_scores[t : t + P] = svec.reshape(P, tel.panel)
    if P == 1:
        e = torch.sum(energy)
        tel.panel_energy[t] = e
    else:
        pe = torch.sum(energy.reshape(P, tel.panel), dim=1)
        tel.panel_energy[t : t + P] = pe
        e = torch.sum(pe)
    tel.energy_mass.add_(e)
    tel.panels_seen.add_(P)
    return tel, t


def fold_psi_chunk(tel: TelemetryFrame, A_block: torch.Tensor, off: int) -> TelemetryFrame:
    """``Ψ += A_block · Ω_test[off : off + W]`` in place, as one fp32
    ``torch.matmul`` over the ``W`` columns a stream consumes (the engine
    folds the whole window once, on either route). Zero-padded columns meet
    zero rows of ``Ω_test``."""
    w = tel.omega[off : off + A_block.shape[1]]
    tel.psi.add_(A_block.float() @ w)
    return tel


def fixed_stream_telemetry(tel, ctx, ctx_new, A_L, sc_a, scores, off):
    """``PanelOps.telemetry`` hook of the fixed-index plug-ins
    (``streaming_cur``, ``streaming_spsd``): a selected column counts as
    admitted in the panel it streams by, read off the fixed ``col_idx``
    (the same on every worker, so the counts are global). Takes one panel,
    or a whole chunk of them at once (``A_L`` a ``(0, W)`` placeholder):
    the counts of each panel then come from one comparison table."""
    tel, t = _fold_panel(tel, A_L, sc_a, scores, off)
    P = A_L.shape[1] // tel.panel
    idx = ctx_new.col_idx.long()
    ends = off + tel.panel * torch.arange(1, P + 1, device=idx.device)
    before_end = idx[None, :] < ends[:, None]  # (P, c)
    adm = torch.sum(before_end & (idx[None, :] >= (ends - tel.panel)[:, None]), dim=1)
    occ = torch.sum(before_end & (idx[None, :] >= 0), dim=1)
    full = occ >= idx.shape[0]
    events = torch.where(adm > 0, EVENT_ADMIT, 0) + torch.where(full, EVENT_BUDGET_FULL, 0)
    tel.admitted[t : t + P] = adm.to(torch.int32)
    tel.occupancy[t : t + P] = occ.to(torch.int32)
    tel.events[t : t + P] = events.to(torch.int32)
    return tel


def adaptive_stream_telemetry(tel, ctx, ctx_new, A_L, sc_a, scores, off):
    """``PanelOps.telemetry`` hook of the adaptive policy (``adaptive_cur``,
    ``adaptive_spsd``): one panel's admission, eviction and row-admission
    counts from the counters of the ctx before (``ctx``) and after
    (``ctx_new``) it. Occupancy is worker-local under sharding (the filled
    slots of the worker's own range)."""
    tel, t = _fold_panel(tel, A_L, sc_a, scores, off)
    adm = ctx_new.n_filled - ctx.n_filled
    ev = ctx_new.n_evicted - ctx.n_evicted
    occ = ctx_new.n_filled - ctx_new.slot_lo
    full = ctx_new.n_filled >= ctx_new.slot_lo + ctx_new.c_local
    if ctx_new.rows is not None:
        radm = ctx_new.rows.n_filled - ctx.rows.n_filled
        tel.rows_admitted[t] = radm
        row_event = torch.where(radm > 0, EVENT_ROW_ADMIT, 0)
    else:
        row_event = 0
    events = (torch.where(adm > 0, EVENT_ADMIT, 0) + torch.where(ev > 0, EVENT_EVICT, 0)
              + row_event + torch.where(full, EVENT_BUDGET_FULL, 0))
    tel.admitted[t] = adm
    tel.evicted[t] = ev
    tel.occupancy[t] = occ
    tel.events[t] = events
    return tel


def telemetry_summary(state_or_tel) -> dict:
    """Host-side view of a streamed frame (a ``PanelState``'s ``.tel`` or a
    frame): the per-panel arrays as numpy, each panel's nearest-rank score
    quantiles (0, 25, 50, 75, 100) over its true columns, the decoded event
    names per panel and the totals."""
    tel = getattr(state_or_tel, "tel", state_or_tel)
    if tel is None:
        raise ValueError("state has no telemetry (init with telemetry=True)")
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    names = ((EVENT_ADMIT, "admit"), (EVENT_EVICT, "evict"), (EVENT_ROW_ADMIT, "row_admit"),
             (EVENT_BUDGET_FULL, "budget_full"), (EVENT_QUARANTINED, "quarantined"))
    events = host(tel.events)
    scores = host(tel.panel_scores).astype(np.float32)
    P, L = scores.shape
    score_q = np.zeros((P, len(_QUANTILES)), np.float32)
    for t in range(P):
        cnt = int(np.clip(tel.n - t * tel.panel, 0, L))
        if cnt > 0:
            srt = np.sort(scores[t, :cnt])
            ranks = np.clip(np.round(np.asarray(_QUANTILES) / 100.0 * (cnt - 1)), 0,
                            cnt - 1).astype(np.int64)
            score_q[t] = srt[ranks]
    admitted, evicted, rows_admitted = host(tel.admitted), host(tel.evicted), host(tel.rows_admitted)
    return {
        "admitted": admitted,
        "evicted": evicted,
        "rows_admitted": rows_admitted,
        "occupancy": host(tel.occupancy),
        "panel_scores": scores,
        "score_q": score_q,
        "panel_energy": host(tel.panel_energy),
        "events": [[nm for bit, nm in names if e & bit] for e in events],
        "energy_mass": float(tel.energy_mass),
        "panels_seen": int(tel.panels_seen),
        "total_admitted": int(admitted.sum()),
        "total_evicted": int(evicted.sum()),
        "total_rows_admitted": int(rows_admitted.sum()),
    }
