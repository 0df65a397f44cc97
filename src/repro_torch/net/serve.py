"""Serving engine: continuous bucketed batching over the fused-pyramid runner.

The port of the reference's ``repro.net.serve``.  ``run_network`` is a
batch call: fast once planned and compiled, but both costs key on the exact
batch size — every distinct request shape pays a fresh ``auto_partition``
DP and a fresh capture of the compiled forward.  Sustained traffic is the
opposite shape: many small requests, few distinct sizes.  This module
turns the runner into a service:

* **Admission** — requests (single images or micro-batches, host arrays)
  enter the queue through :func:`repro_torch.robust.validate.check_request`
  under one engine lock, so N producer threads can feed one drain loop (the
  contract :mod:`repro_torch.net.frontend` builds on).  Admission does no
  CUDA work: a request on a CUDA device is rejected typed, so a producer
  thread never issues device work while the drain thread captures a graph.
* **Deadlines and priorities** — ``submit(x, deadline_us=, priority=)``
  with ``ServeConfig(deadline_aware=True)`` turns the FIFO queue into an
  earliest-deadline-first scheduler: higher priority first, then nearest
  deadline.  A request whose modeled ETA (queue delay from
  :func:`repro_torch.core.cycle_model.queue_delay_cycles` plus its bucket's
  SLO, scaled by the measured-vs-modeled calibration ratio) already blows
  its deadline is **shed at admission** with a typed
  :class:`~repro_torch.robust.errors.DeadlineExceeded`; requests that expire
  while queued complete with the same typed error and never occupy a
  launch.
* **Bucketing** — admitted rows are packed (FIFO, or EDF order when
  deadline-aware) into batch **buckets** (:func:`bucket_for`) and padded to
  the bucket size (:func:`pad_to_bucket`).  Batch elements are independent
  through every op, so the real rows of a padded batch match running them
  unpadded under the same plan (bit for bit on the CPU; on the card cuDNN
  and cuBLAS may pick other algorithms at another batch size).
* **Plan + compile cache** — each bucket executes through one cache entry
  keyed ``(graph, budget, bucket, dtype)``: the bucket-batch
  ``auto_partition`` plan, its prepared params, its modeled cycles and its
  modeled staging cycles.  All requests of a bucket share one padded shape
  and the entry's params, so the runner's compiled forward (a captured CUDA
  graph on the card) is reused too — wave 2 of a bucket performs zero
  replans and zero captures (``repro_torch.net.runner.jit_trace_count``).
* **Double-buffered input staging** — the reference's ``jax.device_put``:
  bucket ``n+1``'s rows are padded straight into pinned host memory and
  copied ``non_blocking`` on a side CUDA stream while bucket ``n`` runs on
  the compute stream; an event orders the compute stream after the copy,
  and the pinned buffer stays referenced until the batch is done.  With
  the resilience hooks off, a card keeps two batches dispatched: ``n+1``'s
  forward queues behind ``n``'s before the host waits for ``n``, so the
  host's work between batches never idles the card.  The cost model twin
  is :func:`repro_torch.core.cycle_model.serve_stream_cycles`.
* **Failure containment** — a launch that dies with a typed
  :class:`~repro_torch.robust.errors.RobustError` (including injected
  staging failures) fails *its batch* typed and the queue keeps draining.
  A **watchdog** (``watchdog_factor=N``) flags launches over N× their
  expected wall; a per-key **circuit breaker** (``breaker_threshold=K``)
  opens after K consecutive failing launches and pins the key to a
  degraded rung (``eager``: every pyramid through its kernel's plain
  version; or ``reference``) for a cooldown window; an **output sentinel**
  re-serves a batch with non-finite logits from the reference walk.  All of
  it is off by default.  Only an *injected* fault (one the process's
  :class:`~repro_torch.robust.faults.FaultInjector` fired in that batch)
  counts as a breaker failure or is re-served: a genuine watchdog trip
  fails its batch with :class:`~repro_torch.robust.errors.WatchdogError`,
  genuine non-finite logits with
  :class:`~repro_torch.robust.errors.NumericError`, and the key stays on
  the kernels, so a broken kernel is never hidden behind a plain
  version.
* **SLO + measurement** — each bucket publishes ``slo_us`` (the 100 MHz
  cycle model's cold latency: staging + the plan's cycles — a model, not a
  measurement), ``steady_us`` (the double-buffered steady state) and the
  measured p50/p95 request latency and images/s; with a tracer installed
  every batch and every resilience action records an event, and the host
  work of admission and of the drain loop records host spans
  (:meth:`ServingEngine.drain`).

``python -m repro_torch.net.serve --model lenet --requests 32 --dry-stream``
drives a deterministic two-wave synthetic stream on the card and prints the
bucket/SLO/throughput table (``--device cpu`` runs the plain path here);
``--inject slow_launch --breaker 1 --watchdog 3`` arms a wave-2 fault and
shows the breaker cycle in the summary.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from collections import Counter, OrderedDict, deque
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.core.cycle_model import (
    DEFAULT_PARAMS,
    host_staging_cycles,
    queue_delay_cycles,
    serve_stream_cycles,
)
from repro_torch.core.dtypes import DTYPE_BYTES, canonical_dtype
from repro_torch.core.program import CARD_BUDGET, REFERENCE_BUDGET, Budget
from repro_torch.obs.stats import percentile
from repro_torch.obs.trace import get_tracer
from repro_torch.robust.breaker import HALF_OPEN, CircuitBreaker
from repro_torch.robust.errors import (
    DeadlineExceeded,
    NumericError,
    PreflightError,
    RobustError,
    WatchdogError,
)
from repro_torch.robust.faults import get_injector
from repro_torch.robust.guard import GuardConfig, guarding
from repro_torch.robust.validate import check_request

from .graph import Graph
from .partition import PartitionPlan, auto_partition, partition_cache_info
from .runner import (
    Params,
    jit_trace_count,
    prepare_network_params,
    reference_network,
    run_network,
)


def bucket_for(rows: int, buckets: tuple[int, ...]) -> int:
    """Smallest configured bucket that fits ``rows`` real rows."""
    for b in sorted(buckets):
        if rows <= b:
            return b
    raise PreflightError(
        f"request spans {rows} rows but the largest bucket is"
        f" {max(buckets)}; split micro-batches before submit",
        rows=rows, buckets=sorted(buckets),
    )


def pad_to_bucket(x, bucket: int) -> np.ndarray:
    """Zero-pad a ``(rows, H, W, C)`` batch up to ``bucket`` rows.

    Zero rows ride along through the padded launch and are sliced off
    before results are returned (batch elements never interact)."""
    x = np.asarray(x)
    rows = x.shape[0]
    if rows == bucket:
        return x
    if rows > bucket:
        raise PreflightError(
            f"cannot pad {rows} rows down to bucket {bucket}",
            rows=rows, bucket=bucket,
        )
    pad = np.zeros((bucket - rows,) + x.shape[1:], dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


@dataclass(frozen=True)
class ServeConfig:
    """Static knobs of one serving engine (the reference's, without
    ``interpret``: the engine's device comes from its ``device=``).

    ``buckets`` are the admissible padded batch sizes (ascending and
    unique).  ``plan_cache_size`` bounds the engine's plan+params LRU.
    ``compute_dtype`` ``None`` means the graph's own default.  ``budget``
    is what every bucket's plan is made under: the card's
    (:data:`~repro_torch.core.program.CARD_BUDGET`) unless the reference's
    TPU budget (:data:`~repro_torch.core.program.REFERENCE_BUDGET`) is
    asked for, as the parity tests do.  ``guarded``
    runs every bucket under the degradation ladder; ``require_finite``
    controls the admission NaN/Inf scan (shape checks always run).
    ``max_queue`` bounds queued requests — an overfull queue rejects at
    submit.

    The resilience knobs all default **off**:

    * ``deadline_aware`` — EDF batch formation, queue-expiry sweeps, and
      admission-time load shedding against modeled ETA.  ``shed_margin``
      scales the modeled ETA before it is compared to the deadline.
    * ``breaker_threshold`` / ``breaker_cooldown_s`` — per-(graph, bucket,
      dtype) circuit breaker: K consecutive failing launches pin the key
      to a degraded rung for the cooldown window.
    * ``watchdog_factor`` — flag launches whose wall clock exceeds N× the
      expected batch wall (max of modeled SLO, the bucket's measured p50
      and :data:`WATCHDOG_FLOOR_MS`).
    * ``output_sentinel`` — finite check on every launch's logits; a trip
      re-serves the batch from the reference walk.

    Breaker failures and sentinel re-serves answer injected faults only;
    a genuine trip fails its batch typed (module docstring)."""

    buckets: tuple[int, ...] = (1, 2, 4, 8)
    plan_cache_size: int = 16
    compute_dtype: str | None = None
    budget: Budget = CARD_BUDGET
    prefer_region: str = "largest"
    end_skip: bool = True
    guarded: bool = False
    require_finite: bool = True
    max_queue: int = 1024
    deadline_aware: bool = False
    shed_margin: float = 1.0
    breaker_threshold: int | None = None
    breaker_cooldown_s: float = 5.0
    watchdog_factor: float | None = None
    output_sentinel: bool = False

    def __post_init__(self):
        if not self.buckets or list(self.buckets) != sorted(set(self.buckets)):
            raise PreflightError(
                f"buckets must be ascending and unique, got {self.buckets}",
                buckets=list(self.buckets),
            )
        if self.shed_margin <= 0:
            raise PreflightError(
                f"shed_margin must be positive, got {self.shed_margin}",
                shed_margin=self.shed_margin,
            )
        if self.breaker_threshold is not None and self.breaker_threshold < 1:
            raise PreflightError(
                f"breaker_threshold must be >= 1, got"
                f" {self.breaker_threshold}",
                breaker_threshold=self.breaker_threshold,
            )
        if self.watchdog_factor is not None and self.watchdog_factor <= 1:
            raise PreflightError(
                f"watchdog_factor must exceed 1, got {self.watchdog_factor}",
                watchdog_factor=self.watchdog_factor,
            )


@dataclass(frozen=True)
class Request:
    """One admitted unit of work: ``rows`` real images awaiting a bucket.

    ``deadline_s`` is the absolute ``time.perf_counter`` deadline computed
    at admission from the caller's relative ``deadline_us`` (``None`` means
    no deadline); ``priority`` orders EDF batches — higher runs first."""

    id: int
    x: np.ndarray  # (rows, H, W, C), host-side
    rows: int
    enqueue_s: float
    deadline_us: float | None = None
    deadline_s: float | None = None
    priority: int = 0


@dataclass(frozen=True)
class RequestResult:
    """Terminal state of one submitted request.

    Exactly one of ``logits``/``error`` is set: rejected, shed, expired,
    and failed requests carry the typed
    :class:`~repro_torch.robust.errors.RobustError` (``bucket`` and
    ``latency_ms`` stay ``None`` unless the request reached a launch);
    completed requests carry their real rows' logits (a float32 host array,
    whatever the compute dtype) and the enqueue→complete wall clock."""

    id: int
    rows: int
    bucket: int | None = None
    logits: np.ndarray | None = None
    error: RobustError | None = None
    latency_ms: float | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclass(frozen=True)
class _PlanEntry:
    """One plan cache entry: everything a bucket needs to execute."""

    bucket: int
    plan: PartitionPlan
    prepared: Params
    compute_cycles: int
    staging_cycles: int

    @property
    def slo_us(self) -> float:
        """Modeled cold latency of one bucket execution at the cycle
        model's 100 MHz: the host→device input copy plus the plan's
        launches, nothing overlapped."""
        return serve_stream_cycles(
            1, self.compute_cycles, self.staging_cycles, double_buffered=False
        ) / DEFAULT_PARAMS.freq_mhz

    @property
    def steady_us(self) -> float:
        """Modeled steady-state per-bucket latency under double buffering:
        ``max(compute, staging)`` — the throughput bound."""
        two = serve_stream_cycles(
            2, self.compute_cycles, self.staging_cycles, double_buffered=True
        )
        return (two - (self.compute_cycles + self.staging_cycles)) / (
            DEFAULT_PARAMS.freq_mhz
        )


@dataclass
class _BucketStats:
    requests: int = 0
    images: int = 0
    batches: int = 0
    wall_ms: float = 0.0
    latencies_ms: list = field(default_factory=list)
    # clean per-batch walls only (watchdog-tripped walls are excluded so an
    # injected stall cannot poison its own detection threshold)
    batch_walls_ms: list = field(default_factory=list)


@dataclass
class _Staged:
    """One formed batch on its way to the device: the padded input ``x``,
    the event its copy records (``None`` on the CPU) and the pinned host
    buffer the copy reads, kept until the batch is done.  ``seq`` is the
    engine's sequence number of the batch, ``dispatch_ns`` when a tracer
    saw its dispatch begin."""

    batch: list
    bucket: int
    entry: _PlanEntry
    x: torch.Tensor
    ready: torch.cuda.Event | None = None
    pinned: torch.Tensor | None = None
    seq: int = 0
    dispatch_ns: int | None = None


@dataclass
class _Dispatched:
    """One staged batch whose forward is queued: its route and breaker,
    when it was dispatched, the logits (in pinned host memory, copied
    ``non_blocking``, when ``pinned``), the guard's report, the event after
    its work (None on the CPU), the typed error of a launch that failed and
    whether an injected fault fired in it."""

    staged: _Staged
    route: str
    breaker: CircuitBreaker | None
    t0: float
    logits: torch.Tensor | None = None
    report: object = None
    done: torch.cuda.Event | None = None
    err: RobustError | None = None
    injected: bool = False
    pinned: bool = False


# absolute floor of the watchdog's expected batch wall: N x a
# sub-millisecond p50 is scheduler noise, not a stuck launch — the watchdog
# exists for launches stuck for 100s of ms
WATCHDOG_FLOOR_MS = 10.0


class ServingEngine:
    """Continuous bucketed batching over one graph's fused-pyramid runner.

    ``submit`` admits (or rejects) requests under the engine lock — safe
    from any thread, host work only; ``drain`` forms buckets and executes
    them with the double-buffered input stage (one drain loop at a time —
    concurrent drains serialize; all CUDA work happens in it); ``summary``
    renders the bucket/SLO table.  Completion listeners
    (:meth:`add_listener`) observe every terminal :class:`RequestResult`.

    ``device`` (``None`` = the CUDA card) is where the engine runs; the
    master ``params`` are placed there.  :attr:`route_batches` counts the
    launched batches by ``(bucket, route)`` — ``fused``, ``eager`` or
    ``reference`` — which is what a run's kernel launch counts follow.
    """

    def __init__(self, graph: Graph, params: Params,
                 config: ServeConfig | None = None, *, device=None) -> None:
        self.graph = graph
        self.config = config or ServeConfig()
        self.device = resolve_device(device)
        self.master_params = {
            k: tuple(t.to(self.device) for t in v) for k, v in params.items()
        }
        self.compute_dtype = canonical_dtype(
            self.config.compute_dtype or graph.compute_dtype
        )
        self.queue: deque[Request] = deque()
        self.results: dict[int, RequestResult] = {}
        self._cache: OrderedDict[tuple, _PlanEntry] = OrderedDict()
        self.cache_counters = {"hits": 0, "misses": 0, "evictions": 0}
        self._stats: dict[int, _BucketStats] = {}
        self._next_id = 0
        self.rejected = 0
        self.resilience = {
            "shed": 0, "expired": 0, "failed": 0,
            "watchdog_trips": 0, "sentinel_trips": 0, "stalls": 0,
        }
        self.route_batches: Counter = Counter()
        self._breakers: dict[tuple, CircuitBreaker] = {}
        self._breaker_emitted: dict[tuple, int] = {}
        self._listeners: list = []
        self._lock = threading.RLock()
        self._drain_lock = threading.Lock()
        self._copy_stream = None  # made by the drain loop, on first use
        self._batches_formed = 0  # the next batch's sequence number

    # -- listeners ----------------------------------------------------------

    def add_listener(self, fn) -> None:
        """Register ``fn(result)`` to be called with every terminal
        :class:`RequestResult` — completions, rejections, sheds, expiries,
        and batch failures alike.  Called under the engine lock, so
        listeners must be cheap and must not re-enter ``drain``."""
        with self._lock:
            self._listeners.append(fn)

    def _notify(self, result: RequestResult) -> None:
        for fn in self._listeners:
            fn(result)

    # -- admission ----------------------------------------------------------

    def submit(self, x, *, deadline_us: float | None = None,
               priority: int = 0) -> int:
        """Admit one request (a ``(H, W, C)`` image or ``(rows, H, W, C)``
        micro-batch, as a host array or a CPU tensor); returns its request
        id.  Thread-safe, and no CUDA work.

        A request that fails admission — on a CUDA device, wrong shape,
        non-finite pixels, more rows than the largest bucket, a full queue,
        or (when ``deadline_aware``) a deadline the modeled queue ETA
        already blows — is *rejected*, not raised: its
        :class:`RequestResult` carries the typed error and the queue keeps
        moving.  Under a tracer the call is one ``serve.admit`` host
        span."""
        tracer = get_tracer()
        if not tracer.enabled:
            return self._admit(x, deadline_us, priority)
        span = tracer.begin("serve.admit")
        rid = None
        try:
            rid = self._admit(x, deadline_us, priority)
            return rid
        finally:
            tracer.end(span, request=rid)

    def _admit(self, x, deadline_us: float | None, priority: int) -> int:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            on_device = isinstance(x, torch.Tensor) and x.device.type != "cpu"
            if not on_device:
                x = np.asarray(x)
                if x.ndim == 3:
                    x = x[None]
            rows = int(x.shape[0]) if x.ndim == 4 else 0
            now = time.perf_counter()
            try:
                if on_device:
                    raise PreflightError(
                        f"requests are host arrays; this one is on"
                        f" {x.device} (admission does no device work)",
                        field="device",
                    )
                if len(self.queue) >= self.config.max_queue:
                    raise PreflightError(
                        f"queue is full ({self.config.max_queue} requests);"
                        " drain before submitting more",
                        max_queue=self.config.max_queue, field="queue",
                    )
                bucket_for(max(rows, 1), self.config.buckets)
                check_request(
                    x, self.graph, require_finite=self.config.require_finite
                )
                if self.config.deadline_aware and deadline_us is not None:
                    eta_us = self._eta_us(rows)
                    if eta_us * self.config.shed_margin > deadline_us:
                        raise DeadlineExceeded(
                            f"request shed at admission: modeled ETA"
                            f" {eta_us:.0f}us blows the {deadline_us:.0f}us"
                            " deadline",
                            request=rid, eta_us=round(eta_us, 1),
                            deadline_us=deadline_us,
                        )
            except RobustError as err:
                self.rejected += 1
                shed = isinstance(err, DeadlineExceeded)
                if shed:
                    self.resilience["shed"] += 1
                result = RequestResult(id=rid, rows=rows, error=err)
                self.results[rid] = result
                tracer = get_tracer()
                if tracer.enabled:
                    tracer.record_event(
                        "serve_shed" if shed else "serve_reject",
                        request=rid, rows=rows,
                        error=type(err).__name__, message=str(err),
                    )
                self._notify(result)
                return rid
            self.queue.append(Request(
                id=rid, x=x, rows=rows, enqueue_s=now,
                deadline_us=deadline_us,
                deadline_s=(
                    now + deadline_us * 1e-6
                    if deadline_us is not None else None
                ),
                priority=priority,
            ))
            return rid

    def submit_many(self, xs) -> list[int]:
        return [self.submit(x) for x in xs]

    # -- deadline math ------------------------------------------------------

    def _calibration(self) -> float:
        """Worst observed measured-vs-modeled wall ratio across buckets
        with traffic (1.0 before any batch lands): the 100 MHz model prices
        launches in microseconds of its own; this ratio maps modeled ETAs
        into the wall-clock domain the deadlines live in."""
        ratios = []
        for b, st in self._stats.items():
            entry = self._cache.get(self._key(b))
            if entry is not None and st.batch_walls_ms:
                ratios.append(
                    percentile(st.batch_walls_ms, 50) * 1e3
                    / max(entry.slo_us, 1e-9)
                )
        return max(ratios) if ratios else 1.0

    def _eta_us(self, rows: int) -> float:
        """Modeled completion ETA for a new ``rows``-row request: the queue
        delay of the work already admitted (costed at the largest bucket's
        steady period, :func:`queue_delay_cycles`) plus the request's own
        bucket SLO, scaled by :meth:`_calibration`."""
        bucket = bucket_for(max(rows, 1), self.config.buckets)
        entry = self._entry(bucket)
        limit = max(self.config.buckets)
        queued_rows = sum(r.rows for r in self.queue)
        wait_us = 0.0
        if queued_rows:
            big = self._entry(limit)
            pending_batches = -(-queued_rows // limit)
            wait_us = queue_delay_cycles(
                pending_batches, big.compute_cycles, big.staging_cycles
            ) / DEFAULT_PARAMS.freq_mhz
        return self._calibration() * (wait_us + entry.slo_us)

    # -- plan cache ---------------------------------------------------------

    def _key(self, bucket: int) -> tuple:
        # the memo key mirrors auto_partition's: identical graph structure,
        # budget, bucket batch, and dtype mean identical plans
        return (self.graph, self.config.budget, bucket,
                self.compute_dtype)

    def _launch_name(self, bucket: int) -> str:
        return f"serve:{self.graph.name}:bucket{bucket}"

    def _entry(self, bucket: int) -> _PlanEntry:
        key = self._key(bucket)
        tracer = get_tracer()
        with self._lock:
            hit = key in self._cache
            if hit:
                self._cache.move_to_end(key)
                self.cache_counters["hits"] += 1
            else:
                self.cache_counters["misses"] += 1
                plan = auto_partition(
                    self.graph,
                    budget=self.config.budget,
                    batch=bucket,
                    prefer_region=self.config.prefer_region,
                    compute_dtype=self.compute_dtype,
                )
                prepared = prepare_network_params(plan, self.master_params)
                in_bytes = DTYPE_BYTES[self.compute_dtype] * bucket * (
                    self.graph.input_size ** 2 * self.graph.in_channels
                )
                self._cache[key] = _PlanEntry(
                    bucket=bucket,
                    plan=plan,
                    prepared=prepared,
                    compute_cycles=plan.modeled_cycles(),
                    staging_cycles=host_staging_cycles(in_bytes),
                )
                while len(self._cache) > self.config.plan_cache_size:
                    self._cache.popitem(last=False)
                    self.cache_counters["evictions"] += 1
            entry = self._cache[key]
        if tracer.enabled:
            tracer.record_event(
                "serve_plan_cache",
                model=self.graph.name, bucket=bucket,
                cache="hit" if hit else "miss",
                compute_dtype=self.compute_dtype,
                launches=entry.plan.n_launches(),
                slo_us=entry.slo_us,
            )
        return entry

    # -- circuit breaker ----------------------------------------------------

    def _breaker(self, bucket: int) -> CircuitBreaker | None:
        if self.config.breaker_threshold is None:
            return None
        key = self._key(bucket)
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = CircuitBreaker(
                    threshold=self.config.breaker_threshold,
                    cooldown_s=self.config.breaker_cooldown_s,
                )
                self._breakers[key] = br
            return br

    def _flush_breaker(self, bucket: int, br: CircuitBreaker) -> None:
        """Emit any breaker transitions not yet traced as ``serve_breaker``
        events."""
        key = self._key(bucket)
        with self._lock:
            seen = self._breaker_emitted.get(key, 0)
            fresh = br.transitions[seen:]
            self._breaker_emitted[key] = len(br.transitions)
        if not fresh:
            return
        tracer = get_tracer()
        if tracer.enabled:
            for t in fresh:
                tracer.record_event(
                    "serve_breaker",
                    model=self.graph.name, bucket=bucket,
                    from_state=t["from"], to_state=t["to"], why=t["why"],
                    pinned_rung=br.pinned_rung,
                )

    @staticmethod
    def _injected(inj, fired: int) -> bool:
        """Did an injected fault fire since the injector's log held
        ``fired`` entries (or is a budget squeeze armed)?  Only such a
        failure may pin a key to a degraded rung or re-serve a batch from
        the reference walk: a genuine one fails its batch typed, and the
        key stays on the kernels."""
        return inj.enabled and (
            len(inj.fired) > fired or inj.vmem_factor < 1.0
        )

    @staticmethod
    def _pin_rung(report, sentinel_tripped: bool) -> str | None:
        """The rung to pin an opening breaker to, from what this launch
        learned: sentinel trips and replan/reference fallbacks need the
        reference walk; eager/heal fallbacks pin the eager path; ``None``
        (no ladder info) keeps the previous pin.  Asked only after an
        injected fault."""
        if sentinel_tripped:
            return "reference"
        if report is not None and report.events:
            rungs = {e.rung for e in report.events}
            if rungs <= {"heal", "eager"}:
                return "eager"
            return "reference"
        return None

    # -- execution ----------------------------------------------------------

    def _form_batch(self) -> list[Request] | None:
        """Pop the next run of requests that fits the largest bucket.

        FIFO by default: strictly in admission order — no peeking past the
        head to fill a bucket with later small requests, so a large request
        is never starved by a stream of singles.  When ``deadline_aware``,
        expired requests are first completed with :class:`DeadlineExceeded`
        (they never occupy a launch), then the same no-skip packing runs
        over EDF order (priority desc, deadline asc, id asc)."""
        with self._lock:
            if not self.config.deadline_aware:
                if not self.queue:
                    return None
                batch, rows = [], 0
                limit = max(self.config.buckets)
                while self.queue and rows + self.queue[0].rows <= limit:
                    req = self.queue.popleft()
                    batch.append(req)
                    rows += req.rows
                return batch
            now = time.perf_counter()
            live = []
            for req in self.queue:
                if req.deadline_s is not None and now > req.deadline_s:
                    self._expire(req, now)
                else:
                    live.append(req)
            if not live:
                self.queue = deque()
                return None
            order = sorted(live, key=lambda r: (
                -r.priority,
                r.deadline_s if r.deadline_s is not None else float("inf"),
                r.id,
            ))
            batch, rows = [], 0
            limit = max(self.config.buckets)
            for req in order:
                if rows + req.rows > limit:
                    break
                batch.append(req)
                rows += req.rows
            taken = {r.id for r in batch}
            self.queue = deque(r for r in live if r.id not in taken)
            return batch

    def _expire(self, req: Request, now: float) -> None:
        late_us = (now - req.deadline_s) * 1e6
        err = DeadlineExceeded(
            f"request {req.id} expired in queue {late_us:.0f}us past its"
            " deadline",
            request=req.id, late_us=round(late_us, 1),
            deadline_us=req.deadline_us,
        )
        result = RequestResult(id=req.id, rows=req.rows, error=err)
        self.results[req.id] = result
        self.resilience["expired"] += 1
        tracer = get_tracer()
        if tracer.enabled:
            tracer.record_event(
                "serve_expired", request=req.id, rows=req.rows,
                late_us=round(late_us, 1),
            )
        self._notify(result)

    def _padded(self, batch: list[Request], bucket: int) -> torch.Tensor:
        """The batch's rows, then zero rows up to ``bucket``, as one
        float32 host tensor written where the copy reads it: pinned memory
        on a card, so a batch costs one host copy of its pixels."""
        shape = (bucket,) + tuple(batch[0].x.shape[1:])
        host = torch.empty(shape, dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")
        buf = host.numpy()
        row = 0
        for req in batch:
            buf[row:row + req.rows] = req.x
            row += req.rows
        buf[row:] = 0
        return host

    def _to_device(self, host: torch.Tensor, seq: int | None = None):
        """Start the host→device copy of one padded float32 batch; returns
        ``(x, ready, pinned)``.  On a card ``host`` is pinned and copied
        ``non_blocking`` on the engine's copy stream, which records
        ``ready``; ``x`` is allocated on that stream.  On the CPU ``x`` is
        the batch itself and ``ready``/``pinned`` are None.  Under a tracer
        the copy's issue is a ``serve.h2d`` host span of batch ``seq``."""
        tracer = get_tracer()
        if tracer.enabled:
            span = tracer.begin("serve.h2d", batch=seq)
        if self.device.type != "cuda":
            x = host.to(self.device)
            if tracer.enabled:
                tracer.end(span)
            return x, None, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            x = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            x.copy_(host, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        if tracer.enabled:
            tracer.end(span)
        return x, ready, host

    def _stage(self, batch: list[Request], seq: int) -> _Staged:
        """Pad batch ``seq`` to its bucket and start its host→device copy —
        called for bucket ``n+1`` while bucket ``n`` computes.  The
        injected ``stage`` fault fires here: a staging failure surfaces
        before any device work, and the caller fails the batch typed.
        Under a tracer everything before the copy is a ``serve.pad`` host
        span."""
        tracer = get_tracer()
        if tracer.enabled:
            span = tracer.begin("serve.pad", batch=seq)
        try:
            rows = sum(r.rows for r in batch)
            bucket = bucket_for(rows, self.config.buckets)
            entry = self._entry(bucket)
            inj = get_injector()
            if inj.enabled:
                inj.fire("stage", self._launch_name(bucket))
            host = self._padded(batch, bucket)
        finally:
            if tracer.enabled:
                tracer.end(span)
        return _Staged(batch, bucket, entry,
                       *self._to_device(host, seq), seq=seq)

    def _next_staged(self) -> _Staged | None:
        """Form and stage the next batch, failing staging-faulted batches
        typed and moving on — a poisoned batch never wedges the loop.  A
        formed batch takes the engine's next sequence number; under a
        tracer the formation is a ``serve.form`` host span."""
        while True:
            tracer = get_tracer()
            if tracer.enabled:
                span = tracer.begin("serve.form")
            batch = self._form_batch()
            seq = None
            if batch is not None:
                seq = self._batches_formed
                self._batches_formed += 1
            if tracer.enabled:
                tracer.end(span, batch=seq)
            if batch is None:
                return None
            try:
                return self._stage(batch, seq)
            except RobustError as err:
                rows = sum(r.rows for r in batch)
                bucket = bucket_for(rows, self.config.buckets)
                self._fail_batch(batch, bucket, err, seq=seq)

    def _await_staging(self, staged: _Staged) -> None:
        """Order the compute (current) stream after the batch's copy."""
        if staged.ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(staged.ready)
        staged.x.record_stream(stream)

    def _run_route(self, route: str, entry: _PlanEntry, x):
        """Execute one staged bucket along ``route``; returns
        ``(logits, report)`` where ``report`` is the guarded
        :class:`~repro_torch.robust.degrade.RunReport` (fused+guarded only).

        Routes: ``fused`` is the normal path (the compiled forward, or
        guarded when configured); ``eager`` runs the same plan with every
        pyramid through its kernel's plain version (the reference's
        ``interpret`` route); ``reference`` is the node-by-node walk from
        the master params — no plan, degraded but correct."""
        if route == "reference":
            return reference_network(x, self.graph, self.master_params), None
        if route == "eager":
            from repro_torch.robust.degrade import run_network_eager

            logits, _ = run_network_eager(
                x, entry.prepared, plan=entry.plan,
                end_skip=self.config.end_skip,
            )
            return logits, None
        if self.config.guarded:
            with guarding(
                GuardConfig(), source_params=self.master_params
            ) as guard:
                logits, _ = run_network(
                    x, entry.prepared, plan=entry.plan,
                    end_skip=self.config.end_skip,
                )
                return logits, guard.last_report
        logits, _ = run_network(
            x, entry.prepared, plan=entry.plan, end_skip=self.config.end_skip,
        )
        return logits, None

    def _watchdog_threshold_ms(self, bucket: int, entry: _PlanEntry):
        """Expected batch wall for the watchdog: the max of the modeled
        SLO, the bucket's measured clean-batch p50, and
        :data:`WATCHDOG_FLOOR_MS`.  ``None`` until the bucket has one
        measured batch — the first launch calibrates."""
        with self._lock:
            st = self._stats.get(bucket)
            walls = list(st.batch_walls_ms) if st is not None else []
        if not walls:
            return None
        return max(
            entry.slo_us / 1e3, percentile(walls, 50), WATCHDOG_FLOOR_MS
        )

    def _fail_batch(
        self, batch: list[Request], bucket: int, err: RobustError,
        wall_ms: float | None = None, *, seq: int | None = None,
        dispatch_ns: int | None = None,
    ) -> None:
        """Complete every request of a failed batch with the typed error —
        the batch is terminal, the queue keeps draining."""
        tracer = get_tracer()
        with self._lock:
            for req in batch:
                result = RequestResult(
                    id=req.id, rows=req.rows, bucket=bucket, error=err,
                )
                self.results[req.id] = result
                self._notify(result)
                if tracer.enabled:
                    self._request_span(tracer, req, seq, dispatch_ns)
            self.resilience["failed"] += len(batch)
        if tracer.enabled:
            tracer.record_event(
                "serve_batch_error",
                model=self.graph.name, bucket=bucket,
                requests=len(batch), error=type(err).__name__,
                message=str(err),
                wall_ms=wall_ms,
            )

    @staticmethod
    def _request_span(tracer, req: Request, seq, dispatch_ns) -> None:
        """A ``serve.request`` host span: from ``req``'s admission to now,
        when its result is delivered."""
        tracer.add_span(
            "serve.request", round(req.enqueue_s * 1e9),
            time.perf_counter_ns(), batch=seq, request=req.id,
            dispatch_ns=dispatch_ns,
        )

    def _record(
        self, batch, bucket, entry, logits, wall_ms, *,
        route: str = "fused", calibrate: bool = True,
        seq: int | None = None, dispatch_ns: int | None = None,
    ) -> None:
        """Deliver a completed batch's results; under a tracer the call is
        a ``serve.record`` host span of batch ``seq`` and each request
        gets its ``serve.request`` span."""
        tracer = get_tracer()
        if tracer.enabled:
            span = tracer.begin("serve.record", batch=seq)
        done_s = time.perf_counter()
        host_logits = logits.float().cpu().numpy()
        with self._lock:
            stats = self._stats.setdefault(bucket, _BucketStats())
            stats.batches += 1
            stats.wall_ms += wall_ms
            if calibrate:
                stats.batch_walls_ms.append(wall_ms)
            row = 0
            for req in batch:
                lat_ms = (done_s - req.enqueue_s) * 1e3
                result = RequestResult(
                    id=req.id,
                    rows=req.rows,
                    bucket=bucket,
                    logits=host_logits[row: row + req.rows],
                    latency_ms=lat_ms,
                )
                self.results[req.id] = result
                row += req.rows
                stats.requests += 1
                stats.images += req.rows
                stats.latencies_ms.append(lat_ms)
                self._notify(result)
                if tracer.enabled:
                    self._request_span(tracer, req, seq, dispatch_ns)
        if tracer.enabled:
            tracer.record_event(
                "serve_batch",
                model=self.graph.name, bucket=bucket,
                requests=len(batch), rows=row,
                wall_ms=wall_ms, slo_us=entry.slo_us,
                route=route,
            )
            tracer.end(span)

    def _launch_done(self):
        """An event after the work just queued on the compute stream (None
        on the CPU, where the work is done)."""
        if self.device.type != "cuda":
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return done

    def _depth(self, inj) -> int:
        """How many batches the drain loop keeps dispatched at once.  Two
        on a card with every resilience hook off: batch ``n+1``'s launches
        queue behind batch ``n``'s, so the host's work between them (the
        wait, the results, the next dispatch) runs under the card's work
        instead of between it.  One otherwise — the breaker, watchdog,
        sentinel, guard and injected faults judge each batch before the
        next is dispatched, and the deadlines are calibrated on batch walls
        that do not wait behind another batch — and on the CPU, where a
        forward is done when it returns."""
        c = self.config
        if (self.device.type != "cuda" or inj.enabled or c.guarded
                or c.deadline_aware or c.output_sentinel
                or c.watchdog_factor is not None
                or c.breaker_threshold is not None):
            return 1
        return 2

    def _dispatch(self, staged: _Staged, inj, depth: int) -> _Dispatched:
        """Queue one staged batch's forward on the compute stream along
        its breaker's route.  With another batch to queue behind it
        (``depth`` 2) the logits' copy to pinned host memory queues too,
        so reading them waits for this batch alone."""
        breaker = self._breaker(staged.bucket)
        route = "fused"
        if breaker is not None and not breaker.allow():
            route = breaker.pinned_rung or "reference"
        d = _Dispatched(staged, route, breaker, time.perf_counter())
        tracer = get_tracer()
        fired = len(inj.fired)
        if tracer.enabled:
            span = tracer.begin("serve.dispatch", batch=staged.seq)
            staged.dispatch_ns = span.start_ns
        try:
            self._await_staging(staged)
            d.logits, d.report = self._run_route(route, staged.entry,
                                                 staged.x)
            if depth > 1 and d.logits.is_cuda:
                host = torch.empty(d.logits.shape, dtype=d.logits.dtype,
                                   pin_memory=True)
                d.logits = host.copy_(d.logits, non_blocking=True)
                d.pinned = True
            d.done = self._launch_done()
        except RobustError as e:
            d.err = e
        if tracer.enabled:
            tracer.end(span)
        # faults fired by this batch's own launch (the next batch's
        # staging fires its own)
        d.injected = self._injected(inj, fired)
        return d

    def _finish(self, d: _Dispatched, inj) -> list[RequestResult]:
        """Wait for a dispatched batch, run the resilience hooks on it and
        deliver its results (or fail it typed)."""
        staged, route, breaker = d.staged, d.route, d.breaker
        batch, bucket, entry, seq = (staged.batch, staged.bucket,
                                     staged.entry, staged.seq)
        tracer = get_tracer()
        logits, report, err, injected = d.logits, d.report, d.err, d.injected
        sentinel_tripped = False
        if err is None:
            if d.done is not None:
                if tracer.enabled:
                    span = tracer.begin("serve.sync", batch=seq)
                d.done.synchronize()
                if tracer.enabled:
                    tracer.end(span)
            if d.pinned:
                logits = logits.clone()  # the pinned buffer goes back
            with self._lock:
                self.route_batches[(bucket, route)] += 1
            if inj.enabled:
                fired = len(inj.fired)
                delay = inj.launch_delay(self._launch_name(bucket))
                if delay:
                    time.sleep(delay)
                if route == "fused":
                    logits = inj.corrupt_output(
                        self._launch_name(bucket), logits
                    )
                injected = injected or self._injected(inj, fired)
            finite = True
            if self.config.output_sentinel:
                if tracer.enabled:
                    span = tracer.begin("serve.sentinel", batch=seq)
                finite = bool(torch.isfinite(logits.float()).all())
                if tracer.enabled:
                    tracer.end(span)
            if not finite:
                sentinel_tripped = True
                with self._lock:
                    self.resilience["sentinel_trips"] += 1
                if tracer.enabled:
                    tracer.record_event(
                        "serve_sentinel",
                        model=self.graph.name, bucket=bucket,
                        route=route,
                        action="reference_retry" if injected else "fail",
                    )
                if injected:
                    logits = self._run_route("reference", entry, staged.x)[0]
                else:
                    err = NumericError(
                        f"bucket {bucket}: non-finite logits on"
                        f" route {route!r}",
                        bucket=bucket, route=route,
                    )
        wall_ms = (time.perf_counter() - d.t0) * 1e3
        wd_tripped = False
        if err is None and self.config.watchdog_factor is not None:
            thresh_ms = self._watchdog_threshold_ms(bucket, entry)
            if (thresh_ms is not None
                    and wall_ms > self.config.watchdog_factor * thresh_ms):
                wd_tripped = True
                limit_ms = self.config.watchdog_factor * thresh_ms
                with self._lock:
                    self.resilience["watchdog_trips"] += 1
                if tracer.enabled:
                    tracer.record_event(
                        "serve_watchdog",
                        model=self.graph.name, bucket=bucket,
                        wall_ms=wall_ms, threshold_ms=limit_ms,
                        route=route,
                    )
                if not injected:
                    err = WatchdogError(
                        f"bucket {bucket}: batch took {wall_ms:.1f}ms,"
                        f" over the watchdog's {limit_ms:.1f}ms",
                        bucket=bucket, route=route,
                        wall_ms=round(wall_ms, 3),
                        threshold_ms=round(limit_ms, 3),
                    )
        if breaker is not None and route == "fused":
            degraded = report is not None and report.degraded
            failed = (err is not None or wd_tripped
                      or sentinel_tripped or degraded)
            if not failed:
                breaker.record_success()
            elif injected:
                breaker.record_failure(
                    rung=self._pin_rung(report, sentinel_tripped)
                )
            elif breaker.state == HALF_OPEN:
                # a probe that failed on its own: re-open with the pin an
                # injected fault set; the batch fails typed
                breaker.record_failure()
            self._flush_breaker(bucket, breaker)
        if err is not None:
            self._fail_batch(batch, bucket, err, wall_ms, seq=seq,
                             dispatch_ns=staged.dispatch_ns)
        else:
            self._record(
                batch, bucket, entry, logits, wall_ms, route=route,
                calibrate=not (wd_tripped or sentinel_tripped),
                seq=seq, dispatch_ns=staged.dispatch_ns,
            )
        return [self.results[r.id] for r in batch]

    def drain(self) -> list[RequestResult]:
        """Execute the queue to empty; returns the drained batches' results
        in completion order (failed batches included, with typed errors).

        The loop is a pipeline: dispatch bucket ``n`` (its launches queue
        on the compute stream), stage bucket ``n+1`` (its copy queues on
        the copy stream, under ``n``'s compute), and — with ``n+1``
        dispatched behind ``n`` when :meth:`_depth` allows two in flight —
        then wait for ``n`` and deliver it.  Around that sit the resilience
        hooks (each a no-op unless configured/armed): injected queue
        stalls, breaker routing, the slow-launch delay, the output
        sentinel, the watchdog, and typed batch failure.

        Under a tracer each stretch of the loop's host work is a host span
        carrying its batch's sequence number: ``serve.form``,
        ``serve.pad`` and ``serve.h2d`` (staging), ``serve.dispatch``
        (ordering after the copy and the forward, whose replay is its
        child ``runner.replay``), ``serve.sync`` (the host waiting on the
        device), ``serve.sentinel`` and ``serve.record``; each request gets
        a ``serve.request`` span stamped with its batch's dispatch."""
        completed: list[RequestResult] = []
        inj = get_injector()
        with self._drain_lock:
            depth = self._depth(inj)
            inflight: deque[_Dispatched] = deque()
            delivered = 0.0  # when the last batch's results went out
            staged = self._next_staged()
            while staged is not None or inflight:
                if staged is not None:
                    if inj.enabled and inj.queue_stalled():
                        with self._lock:
                            self.resilience["stalls"] += 1
                        tracer = get_tracer()
                        if tracer.enabled:
                            tracer.record_event(
                                "serve_stall", model=self.graph.name
                            )
                        time.sleep(0.001)
                        continue
                    inflight.append(self._dispatch(staged, inj, depth))
                    staged = self._next_staged()
                    if staged is not None and len(inflight) < depth:
                        continue
                d = inflight.popleft()
                # a batch queued behind another is timed from that one's
                # delivery, so the bucket's walls add up to the elapsed time
                d.t0 = max(d.t0, delivered)
                completed.extend(self._finish(d, inj))
                delivered = time.perf_counter()
                if staged is None and depth > 1:
                    staged = self._next_staged()
        return completed

    def serve(self, xs) -> list[RequestResult]:
        """Submit + drain in one call; results ordered by request id
        (admission order), rejected requests included with their errors."""
        ids = self.submit_many(xs)
        self.drain()
        return [self.results[i] for i in ids]

    # -- reporting ----------------------------------------------------------

    def cache_info(self) -> dict:
        return {
            **self.cache_counters,
            "currsize": len(self._cache),
            "maxsize": self.config.plan_cache_size,
        }

    def summary(self) -> dict:
        """The bucket/SLO/throughput table as one JSON-safe dict — modeled
        (``slo_us``/``steady_us``/``modeled_cycles``, the 100 MHz model's)
        next to measured (``p50_ms``/``p95_ms``/``imgs_per_s``) per bucket,
        plus the serve and partition cache counters, the compiled-forward
        trace count and the resilience section (shed / expired / failed /
        watchdog / sentinel / stall counts and one breaker snapshot per
        bucket).  The keys are the reference's."""
        with self._lock:
            rows = []
            for bucket in sorted(self._stats):
                st = self._stats[bucket]
                entry = self._cache.get(self._key(bucket))
                row = {
                    "bucket": bucket,
                    "batches": st.batches,
                    "requests": st.requests,
                    "images": st.images,
                    "p50_ms": percentile(st.latencies_ms, 50),
                    "p95_ms": percentile(st.latencies_ms, 95),
                    "imgs_per_s": (
                        st.images / (st.wall_ms / 1e3) if st.wall_ms else 0.0
                    ),
                }
                if entry is not None:  # evicted entries lose model columns
                    row.update(
                        slo_us=entry.slo_us,
                        steady_us=entry.steady_us,
                        modeled_cycles=entry.compute_cycles,
                        staging_cycles=entry.staging_cycles,
                        launches=entry.plan.n_launches(),
                        hbm_bytes=entry.plan.hbm_bytes(),
                    )
                rows.append(row)
            total_images = sum(st.images for st in self._stats.values())
            total_wall_ms = sum(st.wall_ms for st in self._stats.values())
            breakers = {
                str(key[2]): asdict(br.snapshot())
                for key, br in sorted(
                    self._breakers.items(), key=lambda kv: kv[0][2]
                )
            }
            return {
                "model": self.graph.name,
                "compute_dtype": self.compute_dtype,
                "guarded": self.config.guarded,
                "buckets": rows,
                "completed": sum(
                    1 for r in self.results.values() if r.ok
                ),
                "rejected": self.rejected,
                "images": total_images,
                "imgs_per_s": (
                    total_images / (total_wall_ms / 1e3)
                    if total_wall_ms else 0.0
                ),
                "cache": {
                    "serve": self.cache_info(),
                    "partition": partition_cache_info()._asdict(),
                    "jit_traces": jit_trace_count(),
                },
                "resilience": {
                    **self.resilience,
                    "breakers": breakers,
                },
            }


# ---------------------------------------------------------------------------
# CLI: synthetic request stream
# ---------------------------------------------------------------------------


def _synthetic_stream(graph: Graph, n: int, buckets, seed: int):
    """Deterministic request mix: row counts cycle through the bucket range
    so every bucket is exercised; pixels are seeded normals."""
    rng = np.random.default_rng(seed)
    limit = max(buckets)
    sizes = [(i % limit) + 1 for i in range(n)]
    return [
        rng.standard_normal(
            (r, graph.input_size, graph.input_size, graph.in_channels)
        ).astype(np.float32)
        for r in sizes
    ]


def _wave_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _cache_snapshot(engine: ServingEngine) -> dict:
    info = partition_cache_info()
    return {
        "serve_hits": engine.cache_counters["hits"],
        "serve_misses": engine.cache_counters["misses"],
        "partition_hits": info.hits,
        "partition_misses": info.misses,
        "jit_traces": jit_trace_count(),
    }


INJECT_MODES = ("slow_launch", "stage_fail", "poison", "stall")


def _armed_injector(mode: str, seed: int, breaker: int | None):
    """A :class:`FaultInjector` armed for the chosen chaos mode — fired
    during wave 2 only, so wave 1 calibrates the watchdog first."""
    from repro_torch.robust.faults import FaultInjector

    inj = FaultInjector(seed=seed)
    if mode == "slow_launch":
        inj.slow_launch(0.25, times=max(breaker or 1, 1))
    elif mode == "stage_fail":
        inj.raise_at("stage", times=2, message="injected staging failure")
    elif mode == "poison":
        inj.poison_output(times=2)
    elif mode == "stall":
        inj.stall_queue(3)
    return inj


def main(argv=None) -> int:
    from contextlib import nullcontext

    from repro_torch.obs.explain import serve_table
    from repro_torch.robust.faults import inject

    from .graph import MODELS
    from .runner import init_network_params

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.net.serve",
        description="Drive a synthetic request stream through the serving"
        " engine and print the bucket/SLO/throughput table.",
    )
    ap.add_argument("--model", default="lenet", choices=sorted(MODELS))
    ap.add_argument("--requests", type=int, default=32,
                    help="requests per wave (two waves are driven; the"
                    " second demonstrates plan/compile cache reuse)")
    ap.add_argument("--input", type=int, default=None,
                    help="override the model's input size")
    ap.add_argument("--dtype", default=None,
                    help="compute dtype (default: the graph's)")
    ap.add_argument("--buckets", default="1,2,4,8",
                    help="comma-separated ascending batch buckets")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--guarded", action="store_true",
                    help="run buckets under the degradation ladder")
    ap.add_argument("--dry-stream", action="store_true",
                    help="the deterministic in-process stream (the"
                    " reference's flag, which also selects its interpret"
                    " mode; the port has none, so the stream is the same"
                    " with or without it)")
    ap.add_argument("--inject", default=None, choices=INJECT_MODES,
                    help="arm a serving fault for wave 2 (wave 1 stays"
                    " clean to calibrate the watchdog); implies breaker 1,"
                    " watchdog 3, and the output sentinel unless given")
    ap.add_argument("--breaker", type=int, default=None, metavar="K",
                    help="open the per-bucket circuit breaker after K"
                    " consecutive failing launches")
    ap.add_argument("--breaker-cooldown", type=float, default=0.0,
                    metavar="S", help="breaker cooldown seconds before the"
                    " half-open probe (default 0: probe immediately)")
    ap.add_argument("--watchdog", type=float, default=None, metavar="N",
                    help="flag launches exceeding N x the expected batch"
                    " wall (modeled SLO or measured p50)")
    ap.add_argument("--deadline-us", type=float, default=None,
                    help="submit every request with this relative deadline"
                    " (enables deadline-aware EDF admission)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the summary (with per-wave cache deltas)"
                    " as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default cuda: the CUDA"
                    " kernels; cpu runs their plain versions)")
    ap.add_argument("--budget", choices=("card", "reference"),
                    default="card",
                    help="plan every bucket under the card's budget"
                    " (default) or the reference's TPU budget, kept for"
                    " parity")
    args = ap.parse_args(argv)

    kwargs = {"input_size": args.input} if args.input else {}
    graph = MODELS[args.model](**kwargs)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    breaker = args.breaker
    watchdog = args.watchdog
    sentinel = False
    if args.inject is not None:
        breaker = 1 if breaker is None else breaker
        watchdog = 3.0 if watchdog is None else watchdog
        sentinel = args.inject == "poison"
    config = ServeConfig(
        buckets=buckets,
        compute_dtype=args.dtype,
        guarded=args.guarded,
        deadline_aware=args.deadline_us is not None,
        breaker_threshold=breaker,
        breaker_cooldown_s=args.breaker_cooldown,
        watchdog_factor=watchdog,
        output_sentinel=sentinel,
        budget=CARD_BUDGET if args.budget == "card" else REFERENCE_BUDGET,
    )
    device = resolve_device(
        None if args.device == "cuda" else args.device
    )
    params = init_network_params(graph, seed=args.seed, device=device)
    engine = ServingEngine(graph, params, config, device=device)
    stream = _synthetic_stream(graph, args.requests, buckets, args.seed)

    waves = []
    for wave in (1, 2):
        chaos = (
            inject(injector=_armed_injector(
                args.inject, args.seed, breaker
            ))
            if args.inject is not None and wave == 2 else nullcontext()
        )
        before = _cache_snapshot(engine)
        t0 = time.perf_counter()
        with chaos:
            for x in stream:
                engine.submit(x, deadline_us=args.deadline_us)
            engine.drain()
        wall_s = time.perf_counter() - t0
        delta = _wave_delta(before, _cache_snapshot(engine))
        delta["wall_s"] = wall_s
        waves.append(delta)

    summary = engine.summary()
    summary["waves"] = waves
    summary["submitted"] = 2 * len(stream)
    summary["terminal"] = len(engine.results)

    serve_table(summary)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2, default=str)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
