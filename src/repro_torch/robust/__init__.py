"""Guarded inference runtime for the port: typed errors, preflight
validation, numeric sentinels, a graceful-degradation ladder, deterministic
fault injection and a circuit breaker (DESIGN.md §13).

* :mod:`repro_torch.robust.errors` — the typed error hierarchy
  (:class:`PreflightError`, :class:`BudgetError`, :class:`NumericError`,
  ...) every other layer raises instead of bare asserts.
* :mod:`repro_torch.robust.validate` — :func:`preflight` and
  :func:`check_request`: structural checks on graph/params/inputs before
  any launch.
* :mod:`repro_torch.robust.guard` — the process-global guard flag
  (:func:`guarding` mirrors ``repro_torch.obs.tracing``: off by default,
  one attribute check in ``run_network``) plus the per-launch numeric
  sentinels, two reductions on the output's device.
* :mod:`repro_torch.robust.degrade` — :func:`run_network_guarded`: the
  degradation ladder.  An injected build/launch fault retries through the
  kernel's plain version (the ``eager`` rung; a genuine kernel error is
  raised); a budget violation replans the
  pyramid under a shrunken budget; a numeric fault quarantines the launch
  to the node-by-node reference segment.  Every fallback is recorded in
  the returned :class:`RunReport` and as an ``obs`` trace event.
* :mod:`repro_torch.robust.faults` — the seeded fault-injection harness the
  chaos tests use.
* :mod:`repro_torch.robust.breaker` — the per-key circuit breaker a
  serving engine uses to pin a repeatedly failing key to its last good
  rung.

Only :mod:`repro_torch.robust.errors` is imported eagerly (it is
dependency-free and the core raises from it); everything else loads lazily
so ``import repro_torch.core.program`` cannot recurse back through this
package.
"""

from .errors import (
    BudgetError,
    DeadlineExceeded,
    FaultInjected,
    NumericError,
    PlanError,
    PreflightError,
    RobustError,
    WatchdogError,
)

_LAZY = {
    "preflight": "validate",
    "check_request": "validate",
    "GuardConfig": "guard",
    "get_guard": "guard",
    "guarding": "guard",
    "sentinel_stats": "guard",
    "FallbackEvent": "degrade",
    "RunReport": "degrade",
    "run_network_guarded": "degrade",
    "run_network_eager": "degrade",
    "FaultInjector": "faults",
    "corrupt_params": "faults",
    "get_injector": "faults",
    "inject": "faults",
    "CircuitBreaker": "breaker",
    "BreakerSnapshot": "breaker",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BreakerSnapshot",
    "BudgetError",
    "CircuitBreaker",
    "DeadlineExceeded",
    "FallbackEvent",
    "FaultInjected",
    "FaultInjector",
    "GuardConfig",
    "NumericError",
    "PlanError",
    "PreflightError",
    "RobustError",
    "RunReport",
    "WatchdogError",
    "check_request",
    "corrupt_params",
    "get_guard",
    "get_injector",
    "guarding",
    "inject",
    "preflight",
    "run_network_eager",
    "run_network_guarded",
    "sentinel_stats",
]
