"""Named spans: wall-clock records and profiler annotations (counterpart
of ``repro/obs/spans.py``).

:func:`span` pushes a :class:`~repro_torch.obs.metrics.SpanRecord` (start,
duration, nesting depth) into the active registry and wraps its body in
``torch.profiler.record_function(name)``, so the same name marks the
``torch.profiler`` trace. Names are ``layer/subject/stage``, e.g.
``stream/adaptive_cur/scan`` or ``stream/adaptive_cur/sharded_simulate``.

A span does not synchronise with the device: CUDA work is launched
asynchronously, so a span around launches measures their dispatch, not
their execution. Synchronise inside the span when device time is what is
measured. With the registry disabled (the default) a span is a bare
``yield``: no clock read, no annotation.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

from torch.profiler import record_function

from .metrics import MetricsRegistry, SpanRecord, default_registry

__all__ = ["span", "render_timeline"]


@contextmanager
def span(name: str, registry: Optional[MetricsRegistry] = None):
    """Record a named wall-clock span into ``registry`` (default: the
    process registry) and annotate the profiler trace; a no-op when the
    registry is disabled."""
    reg = registry if registry is not None else default_registry()
    if not reg.enabled:
        yield
        return
    depth = len(reg._span_stack)
    reg._span_stack.append(name)
    start = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        duration = time.perf_counter() - start
        reg._span_stack.pop()
        reg.spans.append(SpanRecord(name=name, start=start - reg.epoch, duration=duration,
                                    depth=depth))


def render_timeline(registry: Optional[MetricsRegistry] = None, width: int = 40) -> str:
    """An ASCII timeline of the registry's spans, one line each in start
    order: indentation for nesting, a bar for the span's extent within the
    whole recorded window. ``"(no spans recorded)"`` when there are none."""
    reg = registry if registry is not None else default_registry()
    spans = sorted(reg.spans, key=lambda s: s.start)
    if not spans:
        return "(no spans recorded)"
    t0 = min(s.start for s in spans)
    t1 = max(s.start + s.duration for s in spans)
    window = max(t1 - t0, 1e-9)
    lines = []
    for s in spans:
        lo = int((s.start - t0) / window * width)
        hi = max(int((s.start + s.duration - t0) / window * width), lo + 1)
        bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
        label = "  " * s.depth + s.name
        lines.append(f"{label:<44} {s.duration * 1e3:>9.2f}ms |{bar}|")
    return "\n".join(lines)
