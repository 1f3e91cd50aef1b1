"""Host-side metrics registry: counters, gauges, histograms and spans,
dumped as JSON lines (counterpart of ``repro/obs/metrics.py``).

The in-stream half of observability (:mod:`repro_torch.obs.telemetry`)
lives on the device with the stream. This module is the host half: a
process-local :class:`MetricsRegistry` that callers write structured
metrics into, one JSON object per line from :meth:`~MetricsRegistry.dump_jsonl`,
in the reference's layout. Names are flat strings, ``layer/subject_unit``
(``stream/admitted``):

* counter — a running total (:meth:`MetricsRegistry.inc`);
* gauge — the last value written (:meth:`MetricsRegistry.set_gauge`);
* histogram — every observation kept, summarised at dump time as
  count/mean/min/p50/p90/max (:meth:`MetricsRegistry.observe`).

The registry also collects the :class:`SpanRecord` of every closed
:func:`repro_torch.obs.spans.span`. The process default registry starts
disabled: every write returns at once, so library code (the engine's
spans) may emit unconditionally. Turn it on with :func:`set_registry` or
``default_registry().enabled = True``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np

__all__ = ["MetricsRegistry", "SpanRecord", "default_registry", "set_registry"]


@dataclasses.dataclass
class SpanRecord:
    """One closed span: ``start`` in seconds since the registry's epoch,
    ``duration`` seconds of host wall clock (dispatch time unless the body
    synchronised with the device), ``depth`` its nesting level."""

    name: str
    start: float
    duration: float
    depth: int


class MetricsRegistry:
    """Process-local sink for counters, gauges, histograms and spans; with
    ``enabled=False`` every write is a no-op."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.counters: dict = {}
        self.gauges: dict = {}
        self.histograms: dict = {}
        self.spans: list = []
        self.epoch = time.perf_counter()
        self._span_stack: list = []  # names of the open spans (nesting depth)

    def inc(self, name: str, value: float = 1) -> None:
        """Add ``value`` to counter ``name`` (created at 0)."""
        if not self.enabled:
            return
        self.counters[name] = self.counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        """Set gauge ``name`` (the last write wins)."""
        if not self.enabled:
            return
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        """Record one observation into histogram ``name``."""
        if not self.enabled:
            return
        self.histograms.setdefault(name, []).append(float(value))

    def histogram_summary(self, name: str) -> dict:
        """count/mean/min/p50/p90/max of histogram ``name``."""
        obs = np.asarray(self.histograms[name], np.float64)
        return {
            "count": int(obs.size),
            "mean": float(obs.mean()),
            "min": float(obs.min()),
            "p50": float(np.percentile(obs, 50)),
            "p90": float(np.percentile(obs, 90)),
            "max": float(obs.max()),
        }

    def record_stream_telemetry(self, state_or_tel, prefix: str = "stream") -> None:
        """Fold a streamed :class:`~repro_torch.obs.telemetry.TelemetryFrame`
        into host metrics after the stream: totals become counters and
        gauges, each seen panel's score median and energy one observation of
        a histogram."""
        if not self.enabled:
            return
        from .telemetry import telemetry_summary

        s = telemetry_summary(state_or_tel)
        self.inc(f"{prefix}/admitted", s["total_admitted"])
        self.inc(f"{prefix}/evicted", s["total_evicted"])
        self.inc(f"{prefix}/rows_admitted", s["total_rows_admitted"])
        self.inc(f"{prefix}/panels", s["panels_seen"])
        self.set_gauge(f"{prefix}/energy_mass", s["energy_mass"])
        occ = s["occupancy"]
        if occ.size:
            self.set_gauge(f"{prefix}/final_occupancy", float(occ[-1]))
        for t in range(s["panels_seen"]):
            self.observe(f"{prefix}/panel_score_p50", float(s["score_q"][t, 2]))
            self.observe(f"{prefix}/panel_energy", float(s["panel_energy"][t]))

    def record_kv_compression(self, errs, *, ratio=None, ranks=None, prefix="serve") -> None:
        """Fold per-head relative reconstruction errors ``errs`` (any shape;
        one device-to-host copy) into the ``{prefix}/kv_rel_err`` histogram
        and the ``{prefix}/kv_heads_compressed`` counter; ``ratio`` sets the
        ``{prefix}/kv_compression_ratio`` gauge, and ``ranks`` feed the
        ``{prefix}/kv_head_rank`` histogram."""
        if not self.enabled:
            return
        e = _host(errs).ravel()
        for v in e:
            self.observe(f"{prefix}/kv_rel_err", float(v))
        self.inc(f"{prefix}/kv_heads_compressed", int(e.size))
        if ratio is not None:
            self.set_gauge(f"{prefix}/kv_compression_ratio", float(ratio))
        if ranks is not None:
            for r in _host(ranks).ravel():
                self.observe(f"{prefix}/kv_head_rank", float(r))

    def to_records(self) -> list:
        """The registry as dump-ready dicts, one per instrument and span."""
        recs = [{"type": "counter", "name": k, "value": v} for k, v in sorted(self.counters.items())]
        recs += [{"type": "gauge", "name": k, "value": v} for k, v in sorted(self.gauges.items())]
        recs += [{"type": "histogram", "name": k, **self.histogram_summary(k)}
                 for k in sorted(self.histograms)]
        recs += [{"type": "span", "name": s.name, "start_s": round(s.start, 6),
                  "duration_s": round(s.duration, 6), "depth": s.depth} for s in self.spans]
        return recs

    def dump_jsonl(self, path) -> None:
        """Write :meth:`to_records` as JSON lines."""
        with open(path, "w") as fh:
            for rec in self.to_records():
                fh.write(json.dumps(rec) + "\n")


def _host(x) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as a float64 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


_default = MetricsRegistry(enabled=False)


def default_registry() -> MetricsRegistry:
    """The process-wide registry library code emits into (starts disabled)."""
    return _default


def set_registry(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install ``registry`` as the process-wide one (``None``: a fresh
    disabled one) and return the previous one, so a caller can restore it."""
    global _default
    prev = _default
    _default = registry if registry is not None else MetricsRegistry(enabled=False)
    return prev
