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
launch with a :class:`SpanTimer`: CUDA events on the launch's stream when
the input lives on a CUDA device, the host clock otherwise (CPU tensors
complete synchronously).  Each span names the device it was measured on
(:func:`device_label`).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


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
    device: str = "cpu"  # where duration_ms was measured (device_label)


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


def _is_cuda(device) -> bool:
    if device is None:
        return False
    return str(getattr(device, "type", device)).split(":")[0] == "cuda"


def device_label(device) -> str:
    """The name a measurement on ``device`` is filed under: the card's name
    (``torch.cuda.get_device_name``) for a CUDA device, else the device
    type (``"cpu"``)."""
    if _is_cuda(device):
        import torch

        return torch.cuda.get_device_name(device)
    return str(getattr(device, "type", device or "cpu")).split(":")[0]


@dataclass
class SpanTimer:
    """Measure one span body: ``start()`` ... ``stop_ms()``.

    ``start_s`` is :func:`time.perf_counter` at :meth:`start`, on every
    device.  Given a CUDA ``device``, :meth:`start` and :meth:`stop_ms`
    record CUDA events on that device's current stream and :meth:`stop_ms`
    waits for the second and returns the device time between them; for any
    other device (or none) it returns the host clock's time since
    :meth:`start`.  The two clocks are never mixed within one span."""

    start_s: float = 0.0
    device: object = None
    _events: tuple | None = field(default=None, repr=False)

    def start(self) -> SpanTimer:
        self.start_s = time.perf_counter()
        if _is_cuda(self.device):
            import torch

            stream = torch.cuda.current_stream(self.device)
            begin = torch.cuda.Event(enable_timing=True)
            begin.record(stream)
            self._events = (begin, torch.cuda.Event(enable_timing=True))
        return self

    def stop_ms(self) -> float:
        if self._events is None:
            return (time.perf_counter() - self.start_s) * 1e3
        import torch

        begin, end = self._events
        end.record(torch.cuda.current_stream(self.device))
        end.synchronize()
        return begin.elapsed_time(end)
