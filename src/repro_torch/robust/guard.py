"""Runtime guard flag and numeric sentinels.

The port of the reference's ``repro.robust.guard``.  The guard mirrors the
tracer (:mod:`repro_torch.obs.trace`): a process-global object whose
``enabled`` attribute is the *one* check ``run_network`` makes before
dispatching.  With the default :data:`NULL_GUARD` the forward is the
unguarded one — guards off cost one attribute load per call.  Enable
with::

    from repro_torch.robust import GuardConfig, guarding

    with guarding(GuardConfig()) as guard:
        logits, skips = run_network(x, params, plan=plan)
    print(guard.last_report.summary())

The sentinels (:func:`sentinel_stats`) are two reductions over a launch
output on the tensor's own device — an all-finite flag and the max
magnitude — and :func:`sentinel_trips` reads both on the host with one
copy, so a guarded launch on a card pays one device synchronisation per
launch.  A NaN/Inf is thereby localized to the offending launch (and, via
the reference walk in :mod:`repro_torch.robust.degrade`, to the offending
level) instead of surfacing as poisoned logits launches later.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class GuardConfig:
    """Static knobs of the guarded runtime.

    ``magnitude_limit`` — max ``|value|`` a launch output may carry before
    the numeric sentinel trips (``None`` = finiteness only).

    ``max_replans`` — bounded retry count of the budget rung: each retry
    shrinks the effective budget by ``budget_shrink`` and replans the
    failing pyramid (tighter cuts, chained launches) before giving up to the
    reference path.

    ``preflight`` / ``sentinel`` — toggle the validation pass and the
    per-launch numeric checks independently (both on by default).

    ``heal_params`` — when the preflight finds non-finite params and
    ``guarding(..., source_params=...)`` supplied a clean master copy,
    rebuild the prepared params from it once instead of raising.
    """

    magnitude_limit: float | None = None
    max_replans: int = 2
    budget_shrink: float = 0.5
    preflight: bool = True
    sentinel: bool = True
    heal_params: bool = True


class GuardRuntime:
    """An installed guard: config + the clean param source (for healing)
    + the last run's :class:`~repro_torch.robust.degrade.RunReport`."""

    enabled = True

    def __init__(self, config: GuardConfig | None = None, source_params=None):
        self.config = config if config is not None else GuardConfig()
        self.source_params = source_params
        self.last_report = None


class _NullGuard:
    """Guards off: ``run_network`` sees ``enabled = False`` and runs the
    unguarded forward."""

    enabled = False
    config = GuardConfig()
    source_params = None
    last_report = None


NULL_GUARD = _NullGuard()

_guard = NULL_GUARD


def get_guard():
    """The process-global guard: :data:`NULL_GUARD` unless a
    :class:`GuardRuntime` was installed via :func:`guarding`."""
    return _guard


def set_guard(guard) -> None:
    """Install ``guard`` globally (``None`` restores the off default)."""
    global _guard
    _guard = NULL_GUARD if guard is None else guard


@contextlib.contextmanager
def guarding(config: GuardConfig | None = None, *, source_params=None):
    """Scope a :class:`GuardRuntime` as the process guard; yields it.

    ``source_params`` is the clean (master, f32) params dict used to heal
    corrupted prepared params at preflight.  Nesting restores the previous
    guard on exit, like ``repro_torch.obs.tracing``.
    """
    rt = GuardRuntime(config, source_params)
    prev = get_guard()
    set_guard(rt)
    try:
        yield rt
    finally:
        set_guard(prev)


def sentinel_stats(y: torch.Tensor) -> dict:
    """The per-launch numeric sentinel: ``{"finite": all-finite bool,
    "max_abs": max |y|}`` as 0-d tensors on ``y``'s device — two reductions
    over an output the launch just wrote, with no host transfer."""
    yf = y.float()
    return {
        "finite": torch.isfinite(yf).all(),
        "max_abs": yf.abs().max(),
    }


def sentinel_trips(stats: dict, magnitude_limit: float | None) -> str | None:
    """Classify sentinel stats on the host: ``None`` when clean, else a
    short reason string (``"non-finite"`` / ``"magnitude"``).  Both stats
    come to the host in one copy (one device synchronisation on a card)."""
    finite, max_abs = torch.stack(
        (stats["finite"].float(), stats["max_abs"].float())
    ).tolist()
    if not finite:
        return "non-finite"
    if magnitude_limit is not None and max_abs > magnitude_limit:
        return "magnitude"
    return None
