"""Structured tracing: launch spans, host spans, events, and the global hook.

A stdlib copy of the reference package's ``repro.obs.trace``, plus host
spans and join spans.  One :class:`LaunchSpan` is recorded per
fused-pyramid launch when the collector asks for them — the plan's static
knobs and modeled costs (what the planner promised) next to the measured
launch time (what the launch did) — and one :class:`JoinSpan` per residual
join run between them (its ``add`` and ``relu``, the bytes they move).
:class:`HostSpan` records a stretch of host work at a layer boundary of
the serving path (admission, a batch's formation, staging,
dispatch, wait and record, the replayed forward) on the host's
``time.perf_counter_ns`` clock.  :class:`TraceEvent` covers everything that
is neither: ``auto_partition`` cache hits/misses, per-level END-skip
counts, whole-forward timings.

The collector is deliberately dumb — append-only lists — so instrumented
code stays cheap.

The process-global tracer defaults to :data:`NULL_TRACER`, whose ``enabled``
is ``False``: instrumented call sites check that one attribute and take
their uninstrumented fast path.  Enable collection with::

    from repro_torch.obs import tracing

    with tracing() as collector:
        engine.serve(images)
    print(collector.host_spans)

A collector leaves the forward's route alone: ``run_network`` replays its
compiled forward and records one ``runner.replay`` host span.  Per-launch
spans need ``tracing(launches=True)``: then the runner
(:func:`repro_torch.net.runner.run_network`) runs the forward launch by
launch and times each launch and each join with a :class:`SpanTimer` —
CUDA events on the launch's stream when the input lives on a CUDA device
(a synchronize after each launch), the host clock otherwise (CPU tensors
complete synchronously).  Each launch span names the device it was
measured on (:func:`device_label`).

Each host span is also opened as a profiler range of the same name.  On a
thread a running profiler records, both copies exist, and the offset
between the two clocks can be read from those pairs; spans of other
threads (the serving engine's drain thread, started before the profiler)
then map onto the profiler's timeline with it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple


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


class HostSpan(NamedTuple):
    """One stretch of host work, on :func:`time.perf_counter_ns`.

    ``thread`` is the native id of the thread that ran it (``None`` for a
    request span, which starts on its caller's thread and ends on the drain
    thread).  ``batch`` is the serving engine's sequence number of the
    batch the work belongs to, ``request`` the request's id, ``parent`` the
    ``id`` of the span open around it on its thread.  A request span's
    ``dispatch_ns`` is when its batch's ``serve.dispatch`` began (``None``
    when its batch failed before dispatch).  ``args`` holds what the
    span's site adds: ``runner.replay``'s ``fused_convs`` and ``joins``."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int | None
    batch: int | None = None
    request: int | None = None
    parent: int | None = None
    dispatch_ns: int | None = None
    args: dict | None = None


@dataclass(frozen=True)
class JoinSpan:
    """One residual join: a graph's ``add`` and the ``relu`` that consumes
    it, run between launches as plain ops.  ``hbm_bytes`` is what the join
    moves at the batch (the add reads two maps and writes one, the relu
    reads and writes one); ``start_s`` and ``duration_ms`` are measured as
    a :class:`LaunchSpan`'s are."""

    name: str  # the add node, e.g. "b0_add"
    model: str
    batch: int
    compute_dtype: str
    hbm_bytes: int
    start_s: float
    duration_ms: float
    device: str = "cpu"
    kind: str = "join"


class _Open:
    """An open host span: what :meth:`TraceCollector.begin` hands back."""

    __slots__ = ("id", "name", "start_ns", "batch", "request", "parent",
                 "mirror")


class TraceCollector:
    """Append-only store of launch spans, host spans and events.

    ``enabled`` is class-level ``True`` so the instrumented fast-path check
    (``get_tracer().enabled``) costs one attribute load either way.
    ``launches`` asks ``run_network`` for a :class:`LaunchSpan` per launch,
    which runs the forward eagerly with a synchronize after each launch;
    without it the forward takes its untraced route.
    """

    enabled = True

    def __init__(self, *, launches: bool = False) -> None:
        self.launches = launches
        self.spans: list[LaunchSpan] = []
        self.join_spans: list[JoinSpan] = []
        self.host_spans: list[HostSpan] = []
        self.events: list[TraceEvent] = []
        self._ids = itertools.count()
        self._stacks = threading.local()
        # a span's profiler range: PyTorch's C++ RecordFunction behind
        # torch.profiler.record_function's operator, opened directly (0.4-0.6
        # against 12.6-15.2 us an enter and exit on an H100 machine's host)
        from torch._C._profiler import _RecordFunctionFast

        self._mirror = _RecordFunctionFast

    def record_span(self, span: LaunchSpan) -> None:
        self.spans.append(span)

    def record_join(self, span: JoinSpan) -> None:
        self.join_spans.append(span)

    def record_event(self, name: str, **args) -> None:
        self.events.append(
            TraceEvent(name=name, ts_s=time.perf_counter(), args=args)
        )

    def _stack(self) -> list:
        stack = getattr(self._stacks, "open", None)
        if stack is None:
            stack = self._stacks.open = []
        return stack

    def begin(self, name: str, *, batch: int | None = None,
              request: int | None = None) -> _Open:
        """Open host span ``name`` on this thread, inside the span open
        there (its parent), with its profiler range; returns what
        :meth:`end` takes."""
        stack = self._stack()
        span = _Open()
        span.id = next(self._ids)
        span.name = name
        span.batch = batch
        span.request = request
        span.parent = stack[-1].id if stack else None
        span.mirror = self._mirror(name)
        span.mirror.__enter__()
        span.start_ns = time.perf_counter_ns()
        stack.append(span)
        return span

    def end(self, span: _Open, *, batch: int | None = None,
            request: int | None = None, args: dict | None = None) -> None:
        """Close ``span`` (and any span left open inside it by an
        exception, which is dropped) and record it; ``batch`` and
        ``request`` fill in what was not known when it began, ``args``
        what the site adds."""
        end_ns = time.perf_counter_ns()
        stack = self._stack()
        while span in stack:
            top = stack.pop()
            top.mirror.__exit__(None, None, None)
            if top is span:
                break
        self.host_spans.append(HostSpan(
            span.id, span.name, span.start_ns, end_ns,
            threading.get_native_id(),
            span.batch if batch is None else batch,
            span.request if request is None else request,
            span.parent,
            args=args,
        ))

    def add_span(self, name: str, start_ns: int, end_ns: int, **ids) -> None:
        """Record a finished span that no one thread ran (a request's,
        from admission to its result): no parent, no profiler twin."""
        self.host_spans.append(HostSpan(
            id=next(self._ids), name=name, start_ns=start_ns, end_ns=end_ns,
            thread=None, **ids,
        ))


class _NullTracer:
    """The zero-overhead default: nothing is recorded, nothing is kept."""

    enabled = False
    launches = False
    spans: tuple = ()
    join_spans: tuple = ()
    host_spans: tuple = ()
    events: tuple = ()

    def record_span(self, span: LaunchSpan) -> None:
        pass

    def record_join(self, span: JoinSpan) -> None:
        pass

    def record_event(self, name: str, **args) -> None:
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
def tracing(collector: TraceCollector | None = None, *,
            launches: bool = False):
    """Scope a collector as the global tracer; yields the collector.

    ``launches`` makes a new collector ask for per-launch spans
    (:class:`TraceCollector`).  Nesting restores the previous tracer on
    exit.
    """
    col = TraceCollector(launches=launches) if collector is None else collector
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
