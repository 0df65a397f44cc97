"""Fusion observability for the port: launch traces, timelines, drift.

The plan ladder (``x_slots`` / ``w_slots`` / ``c_tiles``, resident vs
streamed vs channel-tiled) is chosen by *modeled* cycles; this package
records what each launch planned and what it measurably did on the device.
Pieces:

* :mod:`repro_torch.obs.trace` — the :class:`TraceCollector` span/event
  store, the process-global tracer hook (:func:`get_tracer` /
  :func:`tracing`) and :class:`SpanTimer` (CUDA events on a card, the host
  clock elsewhere).  The default tracer is a no-op whose only cost is one
  attribute check in ``net/runner.run_network``.
* :mod:`repro_torch.obs.stats` — :func:`percentile` and
  :func:`timed_stats_ms`.
* :mod:`repro_torch.obs.timeline` — Chrome-trace (Perfetto) JSON export:
  each launch's modeled DMA-vs-MXU timeline from the cycle model beside the
  measured spans, plus the schema validator.
* :mod:`repro_torch.obs.report` — the model-vs-measured drift report.
* :mod:`repro_torch.obs.explain` — ``python -m repro_torch.obs.explain``:
  the partition plan as a per-launch table, optionally run traced and
  guarded on the card.
"""

from .stats import percentile, timed_stats_ms
from .timeline import chrome_trace, validate_chrome_trace, write_chrome_trace
from .trace import (
    NULL_TRACER,
    LaunchSpan,
    SpanTimer,
    TraceCollector,
    TraceEvent,
    get_tracer,
    set_tracer,
    tracing,
)

_REPORT_EXPORTS = (
    "drift_report", "drift_rows_from_bench", "drift_rows_from_spans",
)


def __getattr__(name: str):
    # lazy so `python -m repro_torch.obs.report` doesn't import the module
    # twice (runpy would warn about the package __init__'s copy)
    if name in _REPORT_EXPORTS:
        from . import report

        return getattr(report, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "NULL_TRACER",
    "LaunchSpan",
    "SpanTimer",
    "TraceCollector",
    "TraceEvent",
    "chrome_trace",
    "drift_report",
    "drift_rows_from_bench",
    "drift_rows_from_spans",
    "get_tracer",
    "percentile",
    "set_tracer",
    "timed_stats_ms",
    "tracing",
    "validate_chrome_trace",
    "write_chrome_trace",
]
