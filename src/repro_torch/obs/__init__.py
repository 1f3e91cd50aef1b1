"""Observability for the port's streaming engine (counterpart of ``repro.obs``).

* :mod:`~repro_torch.obs.telemetry` — a fixed-shape per-panel diagnostics
  frame (:class:`TelemetryFrame`) carried in ``PanelState.tel`` and folded
  by the ``PanelOps.telemetry`` hook; off by default (``tel=None``: the
  engine runs what it runs without it);
* :mod:`~repro_torch.obs.error_estimate` — :func:`estimate_rel_error`, a
  relative Frobenius-error estimate from the in-stream ``Ψ = A Ω_test``,
  with no second pass over ``A``;
* :mod:`~repro_torch.obs.metrics` / :mod:`~repro_torch.obs.spans` — a
  host-side registry of counters, gauges and histograms with a JSON-lines
  dump, and spans marked in the ``torch.profiler`` trace; the process
  default registry starts disabled.

Turn telemetry on per stream with ``telemetry=True`` on the inits
(``streaming_cur_init``, ``adaptive_cur_init``, ``streaming_spsd_init``,
``adaptive_spsd_init``).
"""

from .error_estimate import estimate_rel_error, low_rank_apply
from .metrics import MetricsRegistry, SpanRecord, default_registry, set_registry
from .spans import render_timeline, span
from .telemetry import (
    EVENT_ADMIT,
    EVENT_BUDGET_FULL,
    EVENT_EVICT,
    EVENT_QUARANTINED,
    EVENT_ROW_ADMIT,
    TelemetryFrame,
    adaptive_stream_telemetry,
    fixed_stream_telemetry,
    init_telemetry,
    telemetry_summary,
)

__all__ = [
    "TelemetryFrame",
    "init_telemetry",
    "adaptive_stream_telemetry",
    "fixed_stream_telemetry",
    "telemetry_summary",
    "EVENT_ADMIT",
    "EVENT_EVICT",
    "EVENT_ROW_ADMIT",
    "EVENT_BUDGET_FULL",
    "EVENT_QUARANTINED",
    "estimate_rel_error",
    "low_rank_apply",
    "MetricsRegistry",
    "SpanRecord",
    "default_registry",
    "set_registry",
    "render_timeline",
    "span",
]
