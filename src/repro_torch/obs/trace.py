"""Structured launch tracing: spans, events, counters, and the global hook.

A stdlib copy of the reference package's ``repro.obs.trace``.  One
:class:`LaunchSpan` is recorded per fused-pyramid launch — the plan's static
knobs and modeled costs (what the planner promised) next to the measured
launch time (what the launch did).  :class:`TraceEvent` covers everything
that is not a launch: ``auto_partition`` cache hits/misses, per-level
END-skip counts, whole-forward timings.

The collector is deliberately dumb — append-only lists plus a counter dict —
so instrumented code stays cheap.

The process-global tracer defaults to :data:`NULL_TRACER`, whose ``enabled``
is ``False``: instrumented call sites check that one attribute and take
their uninstrumented fast path.  Enable collection with::

    from repro_torch.obs import tracing

    with tracing() as collector:
        run_network(x, params, plan=plan)
    print(collector.spans)

The traced runner (:func:`repro_torch.net.runner.run_network`) times each
launch with CUDA events on the launch's stream when the input lives on a
CUDA device, and with the host clock otherwise (CPU tensors complete
synchronously).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class LaunchSpan:
    """One fused-pyramid launch: planned knobs + modeled costs + measurement.

    ``start_s`` is :func:`time.perf_counter` when the launch was issued
    (comparable only within one process); ``duration_ms`` is the measured
    launch time — CUDA-event elapsed time on a CUDA device, host wall clock
    on the CPU.  The first launch of a process includes building the kernel
    library, so callers wanting steady-state numbers warm up first.  The
    modeled fields are the exact quantities the partitioner optimized,
    copied from the :class:`~repro_torch.core.program.LaunchPlan`.
    """

    name: str  # pyramid name, e.g. "CL1..MPL2"
    model: str  # graph name, e.g. "lenet"
    regime: str  # resident / streamed_w2 / streamed_w2_c4 / ...
    out_region: int
    alpha: int
    q_convs: int
    x_slots: int
    w_slots: int
    c_tiles: int
    batch: int
    compute_dtype: str
    streamed: bool
    hbm_bytes: int  # modeled off-chip traffic of the launch (batch-scaled)
    vmem_bytes: int  # modeled resident working set
    modeled_cycles: int  # pipeline-aware cycle model (batch-scaled)
    modeled_us: float  # modeled_cycles at the cycle model's 100 MHz
    start_s: float
    duration_ms: float


@dataclass(frozen=True)
class TraceEvent:
    """A point event: cache hit/miss, skip stats, forward-level timing."""

    name: str
    ts_s: float
    args: dict


class TraceCollector:
    """Append-only span/event store with named counters.

    ``enabled`` is class-level ``True`` so the instrumented fast-path check
    (``get_tracer().enabled``) costs one attribute load either way.
    """

    enabled = True

    def __init__(self) -> None:
        self.spans: list[LaunchSpan] = []
        self.events: list[TraceEvent] = []
        self.counters: dict[str, int] = {}

    def record_span(self, span: LaunchSpan) -> None:
        self.spans.append(span)

    def record_event(self, name: str, **args) -> None:
        self.events.append(
            TraceEvent(name=name, ts_s=time.perf_counter(), args=args)
        )

    def bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n


class _NullTracer:
    """The zero-overhead default: nothing is recorded, nothing is kept."""

    enabled = False
    spans: tuple = ()
    events: tuple = ()
    counters: dict = {}

    def record_span(self, span: LaunchSpan) -> None:
        pass

    def record_event(self, name: str, **args) -> None:
        pass

    def bump(self, counter: str, n: int = 1) -> None:
        pass


NULL_TRACER = _NullTracer()

_tracer = NULL_TRACER


def get_tracer():
    """The process-global tracer: :data:`NULL_TRACER` unless a collector was
    installed via :func:`set_tracer` / :func:`tracing`."""
    return _tracer


def set_tracer(tracer) -> None:
    """Install ``tracer`` globally (``None`` restores the no-op default)."""
    global _tracer
    _tracer = NULL_TRACER if tracer is None else tracer


@contextlib.contextmanager
def tracing(collector: TraceCollector | None = None):
    """Scope a collector as the global tracer; yields the collector.

    Nesting restores the previous tracer on exit.
    """
    col = TraceCollector() if collector is None else collector
    prev = get_tracer()
    set_tracer(col)
    try:
        yield col
    finally:
        set_tracer(prev)
