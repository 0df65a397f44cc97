"""Launch tracing for the port: spans, events, counters (:mod:`.trace`)."""

from .trace import (
    NULL_TRACER,
    LaunchSpan,
    TraceCollector,
    TraceEvent,
    get_tracer,
    set_tracer,
    tracing,
)

__all__ = [
    "NULL_TRACER",
    "LaunchSpan",
    "TraceCollector",
    "TraceEvent",
    "get_tracer",
    "set_tracer",
    "tracing",
]
