"""The graceful-degradation ladder: guarded ``run_network`` execution.

The port of the reference's ``repro.robust.degrade``.
:func:`run_network_guarded` runs the same plan-driven forward loop as the
unguarded path (``repro_torch.net.runner._forward``) with each fused launch
wrapped in a bounded ladder of fallbacks.  Every rung trades performance
for the guarantee that the forward *finishes with correct logits*; the
bottom rung is the node-by-node reference path, which needs only the graph
and finite params.  The rungs, top to bottom:

1. **fused launch** — the planned kernel launch (A, or B for
   ``c_tiles > 1``), unchanged.
2. **eager retry** — an injected compile/run fault
   (:class:`FaultInjected`) retries the same launch once through the
   kernel's plain PyTorch version (``fused_pyramid(..., plain=True)``).
   It takes the reference's ``interpret=True`` rung: slower, but it shares
   no code with the CUDA kernel.  This rung is the only way the plain
   version runs on a CUDA tensor, and it is always recorded (here as a
   :class:`FallbackEvent`; a serving engine whose breaker pins a key to
   it runs :func:`run_network_eager` and records the route).  A genuine
   build or launch error of the kernel is not a rung: it propagates, so a
   broken kernel fails loudly instead of being hidden behind its plain
   version.
3. **replan** — a :class:`BudgetError` (the planned working set no longer
   fits, e.g. under a simulated budget squeeze) re-cuts the failing pyramid
   under a shrunken budget via
   :func:`repro_torch.net.partition.replan_pyramid` — tighter cuts, a chain
   of smaller launches, each a real kernel launch — up to
   ``GuardConfig.max_replans`` times, each retry shrinking the budget by
   ``budget_shrink``.
4. **reference quarantine** — a numeric-sentinel trip (NaN/Inf or
   magnitude blow-up in a launch output), an injected plan-stage fault, an
   injected fault that repeats on the eager retry, or exhaustion of the
   replans
   quarantines the launch: the covered nodes are recomputed with the
   plain-op reference path, and the sentinel walk localizes the first
   offending level when the fault reproduces there.

A quarantined or replanned launch reports a neutral all-zeros END-skip map
for its pyramid key (shape ``(B, 1, 1, Q)``); the real per-sub-launch skip
fractions ride in the :class:`RunReport` event detail.

Every fallback is recorded twice: as a :class:`FallbackEvent` in the
returned report (stored on ``guard.last_report``) and — when a tracer is
installed — as a ``"degrade"`` trace event.  The sentinels read each launch
output on the host once (one device synchronisation per launch on a card):
that is the guard's cost.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .errors import BudgetError, FaultInjected, NumericError
from .guard import sentinel_stats, sentinel_trips

_FLAT = "_flat/"


@dataclass(frozen=True)
class FallbackEvent:
    """One rung taken: which launch degraded, to what, and why."""

    launch: str
    rung: str  # "heal" | "eager" | "replan" | "reference" | "reference_full"
    reason: str
    detail: dict = field(default_factory=dict)

    def describe(self) -> str:
        extra = ", ".join(f"{k}={v}" for k, v in self.detail.items())
        return (
            f"{self.launch}: -> {self.rung} ({self.reason})"
            + (f" [{extra}]" if extra else "")
        )


@dataclass
class RunReport:
    """What one guarded forward did: rungs taken, launches run clean."""

    model: str = ""
    batch: int = 0
    compute_dtype: str = ""
    launches: int = 0
    clean_launches: int = 0
    events: list = field(default_factory=list)

    @property
    def degraded(self) -> bool:
        return bool(self.events)

    def fallback_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for e in self.events:
            counts[e.rung] = counts.get(e.rung, 0) + 1
        return counts

    def summary(self) -> str:
        head = (
            f"guarded run[{self.model}] batch={self.batch}"
            f" dtype={self.compute_dtype}: {self.clean_launches}/"
            f"{self.launches} launches clean"
        )
        if not self.events:
            return head + ", no fallbacks"
        lines = [head] + [f"  {e.describe()}" for e in self.events]
        return "\n".join(lines)


def _zero_skip(batch: int, q_convs: int, device) -> torch.Tensor:
    # neutral END-skip map for a launch that did not run fused: nothing
    # skipped, one grid cell per level slot
    return torch.zeros((batch, 1, 1, q_convs), dtype=torch.int32,
                       device=device)


def _reference_walk(x_in, pyr, graph, params, tdt, magnitude_limit=None):
    """Recompute a pyramid's covered nodes with the plain-op reference path.

    Returns ``(y, first_bad_level)`` where ``first_bad_level`` is the index
    (within the pyramid's conv levels) whose output first trips the
    sentinel, or ``None`` when the recompute is clean — i.e. the original
    fault did not reproduce and was the kernel execution itself.
    """
    from repro_torch.net.runner import _conv_node, _pool_node

    y = x_in
    level = -1
    first_bad = None
    for nm in pyr.node_names:
        n = graph.node(nm)
        if n.op == "conv":
            level += 1
            w, b = params[nm]
            y = _conv_node(y, n, w.to(tdt), b.to(tdt))
        else:
            y = _pool_node(y, n)
        if first_bad is None:
            if sentinel_trips(sentinel_stats(y), magnitude_limit) is not None:
                first_bad = level
    return y, first_bad


def _run_subplan(x_in, subs, params, graph, cdt, *, end_skip, budget):
    """Execute a replanned pyramid chain: each sub-pyramid as its own fused
    launch, per-level weight tensors (the pre-flattened arrays belong to the
    original plan's pyramids, not these)."""
    from repro_torch.kernels.fused_conv.ops import fused_pyramid

    y = x_in
    sub_skips = {}
    for sp in subs:
        conv_names = [m for m in sp.node_names if graph.node(m).op == "conv"]
        y, sk = fused_pyramid(
            y,
            [params[m][0] for m in conv_names],
            [params[m][1] for m in conv_names],
            spec=sp.spec,
            out_region=sp.launch.out_region,
            streamed=sp.launch.streamed,
            w_slots=sp.launch.w_slots if sp.launch.streamed else None,
            x_slots=sp.launch.x_slots,
            c_tiles=sp.launch.c_tiles,
            relu=sp.relu,
            end_skip=end_skip,
            budget=budget,
            weights_flat=None,
            compute_dtype=cdt,
        )
        sub_skips[sp.name] = sk
    return y, sub_skips


def _skip_fracs(sub_skips: dict) -> dict[str, list[float]]:
    return {
        name: s.double().mean(dim=(0, 1, 2)).tolist()
        for name, s in sub_skips.items()
    }


def _eager(call):
    """The eager rung: re-issue a launch through its kernel's plain
    version (the one place the port asks for it on a CUDA tensor)."""
    return call(plain=True)


def run_network_guarded(
    x,
    params,
    *,
    plan,
    end_skip: bool = True,
    dtype: str | None = None,
    guard=None,
):
    """Guarded twin of :func:`repro_torch.net.runner.run_network`.

    Same return contract ``(logits, skips)``; runs launch by launch with
    preflight validation up front, the fault injector consulted at each
    stage boundary, numeric sentinels on every launch output, and the
    degradation ladder answering failures.  The :class:`RunReport` lands on
    ``guard.last_report``.  ``run_network`` calls this under ``guarding()``
    inside its float32 scope; a direct caller should do the same.
    """
    from repro_torch.core.dtypes import canonical_dtype, torch_dtype
    from repro_torch.net.runner import _forward, prepare_network_params
    from repro_torch.obs.trace import get_tracer

    from .faults import get_injector
    from .guard import get_guard
    from .validate import nonfinite_param_nodes, preflight

    guard = get_guard() if guard is None else guard
    cfg = guard.config
    injector = get_injector()
    tracer = get_tracer()
    graph = plan.graph
    batch = int(x.shape[0])
    report = RunReport(model=graph.name, batch=batch,
                       launches=plan.n_launches())

    def record(event: FallbackEvent) -> None:
        report.events.append(event)
        if tracer.enabled:
            tracer.record_event(
                "degrade", model=graph.name, launch=event.launch,
                rung=event.rung, reason=event.reason, **event.detail,
            )

    # -- preflight (with one bounded healing attempt) -----------------------
    if cfg.preflight:
        try:
            cdt = preflight(x, params, plan=plan, dtype=dtype)
        except NumericError as e:
            if not (cfg.heal_params and guard.source_params is not None):
                raise
            healed = prepare_network_params(plan, guard.source_params, dtype)
            still_bad = nonfinite_param_nodes(healed)
            if still_bad:
                raise NumericError(
                    "params still non-finite after reloading from source;"
                    " the master copy is corrupt too",
                    nodes=still_bad,
                ) from e
            record(FallbackEvent(
                launch="<preflight>", rung="heal",
                reason="non-finite params reloaded from source",
                detail={"nodes": e.context.get("nodes", [])},
            ))
            params = healed
            cdt = preflight(x, params, plan=plan, dtype=dtype)
    else:
        cdt = canonical_dtype(plan.compute_dtype if dtype is None else dtype)
    tdt = torch_dtype(cdt)
    report.compute_dtype = cdt

    # the effective budget a launch must fit at run time: the plan's own
    # budget scaled by any injected squeeze
    effective_budget = plan.budget.scaled(injector.vmem_factor)

    def reference_rung(pyr, x_in, reason, detail=None):
        y, bad_level = _reference_walk(
            x_in, pyr, graph, params, tdt, cfg.magnitude_limit
        )
        d = dict(detail or {})
        d["level"] = bad_level if bad_level is not None else "kernel-only"
        record(FallbackEvent(
            launch=pyr.name, rung="reference", reason=reason, detail=d,
        ))
        if bad_level is not None:
            # the fault reproduces in the reference math: the data/params
            # themselves blow up at that level — not recoverable by any
            # execution path
            raise NumericError(
                f"launch {pyr.name}: level {bad_level} output is non-finite"
                " (or over the magnitude limit) even on the reference path",
                launch=pyr.name, level=bad_level,
            )
        return y, _zero_skip(batch, pyr.q_convs, x_in.device)

    def replan_rung(pyr, x_in, reason):
        from repro_torch.net.partition import replan_pyramid

        budget = effective_budget
        for attempt in range(cfg.max_replans):
            try:
                try:
                    subs = replan_pyramid(
                        graph, pyr, budget=budget, batch=batch,
                        compute_dtype=cdt,
                    )
                except ValueError as e:  # no cut fits this budget
                    raise BudgetError(str(e), launch=pyr.name) from e
                bad = [sp.name for sp in subs
                       if not budget.fits(sp.launch, batch)]
                if bad:
                    raise BudgetError(
                        f"replan of {pyr.name} still exceeds the"
                        f" {budget}", launch=bad[0],
                    )
                y, sub_skips = _run_subplan(
                    x_in, subs, params, graph, cdt, end_skip=end_skip,
                    budget=budget,
                )
                record(FallbackEvent(
                    launch=pyr.name, rung="replan", reason=reason,
                    detail={
                        "attempt": attempt + 1,
                        "budget": budget.nbytes,
                        "sub_launches": [sp.name for sp in subs],
                        "sub_skip_fractions": _skip_fracs(sub_skips),
                    },
                ))
                return y, _zero_skip(batch, pyr.q_convs, x_in.device)
            except BudgetError:
                budget = budget.scaled(cfg.budget_shrink)
        return reference_rung(
            pyr, x_in, f"replan exhausted after {cfg.max_replans} attempts",
            detail={"original_reason": reason},
        )

    def guarded_wrapper(pyr, call, x_in):
        # -- plan stage: injected faults + the run-time budget check -------
        try:
            injector.fire("plan", pyr.name)
            if not effective_budget.fits(pyr.launch, batch):
                need = effective_budget.working_set(pyr.launch, batch)
                raise BudgetError(
                    f"launch {pyr.name} needs {need} bytes under the"
                    f" {effective_budget}",
                    launch=pyr.name, **effective_budget.context(need),
                )
        except BudgetError as e:
            return replan_rung(pyr, x_in, str(e))
        except FaultInjected as e:
            return reference_rung(pyr, x_in, f"plan stage failed: {e}")

        # -- compile/run stages: the kernel launch, one eager retry --------
        # only injected faults take the rung; a real build or launch error
        # of the kernel propagates
        try:
            injector.fire("compile", pyr.name)
            injector.fire("run", pyr.name)
            y, skip = call()
            clean = True
        except BudgetError as e:
            return replan_rung(pyr, x_in, str(e))
        except FaultInjected as first:
            try:
                injector.fire("compile", pyr.name)
                injector.fire("run", pyr.name)
                y, skip = _eager(call)
                record(FallbackEvent(
                    launch=pyr.name, rung="eager",
                    reason=f"launch failed: {first}",
                ))
            except FaultInjected as second:
                return reference_rung(
                    pyr, x_in,
                    f"eager retry failed too: {second}",
                    detail={"first_error": str(first)},
                )
            clean = False

        # -- numeric sentinel on the launch output -------------------------
        y = injector.corrupt_output(pyr.name, y)
        if cfg.sentinel:
            trip = sentinel_trips(sentinel_stats(y), cfg.magnitude_limit)
            if trip is not None:
                return reference_rung(
                    pyr, x_in, f"sentinel tripped: {trip}"
                )
        report.clean_launches += clean
        return y, skip

    logits, skips = _forward(
        x, params, plan=plan, end_skip=end_skip, cdt=cdt,
        launch_wrapper=guarded_wrapper,
    )

    # -- final logits sentinel: faults in the plain-op head ----------------
    if cfg.sentinel:
        trip = sentinel_trips(sentinel_stats(logits), None)
        if trip is not None:
            from repro_torch.net.runner import reference_network

            logits = reference_network(
                x.to(tdt), graph,
                {k: v for k, v in params.items() if not k.startswith(_FLAT)},
            )
            record(FallbackEvent(
                launch="<head>", rung="reference_full",
                reason=f"logits sentinel tripped: {trip}",
            ))
            if sentinel_trips(sentinel_stats(logits), None) is not None:
                raise NumericError(
                    "logits are non-finite even on the full reference path",
                    launch="<head>",
                )

    if tracer.enabled:
        tracer.record_event(
            "guarded_run", model=graph.name, batch=batch, compute_dtype=cdt,
            launches=report.launches, clean_launches=report.clean_launches,
            fallbacks=report.fallback_counts(),
        )
    guard.last_report = report
    return logits, skips


def run_network_eager(x, params, *, plan, end_skip: bool = True,
                      dtype: str | None = None):
    """The plan's forward with every launch on the ``eager`` rung: each
    pyramid through its kernel's plain PyTorch version, on any device —
    the reference's ``run_network(..., interpret=True)``.  Only a serving
    engine whose circuit breaker pinned a key to ``eager`` runs it, and it
    records that route for every batch it serves so."""
    from repro_torch.core.dtypes import canonical_dtype
    from repro_torch.core.executor import full_fp32
    from repro_torch.net.runner import _forward

    cdt = canonical_dtype(plan.compute_dtype if dtype is None else dtype)
    with full_fp32():
        return _forward(
            x, params, plan=plan, end_skip=end_skip, cdt=cdt,
            launch_wrapper=lambda pyr, call, x_in: _eager(call),
        )
