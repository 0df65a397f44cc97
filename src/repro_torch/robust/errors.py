"""Typed error hierarchy of the fused-pyramid path (stdlib only).

A copy of the reference package's ``repro.robust.errors``: the port's
planner (:mod:`repro_torch.core.program`), kernel wrappers
(:mod:`repro_torch.kernels.fused_conv.ops`) and partitioner raise these
instead of bare asserts, so callers can dispatch on *what went wrong*:

* :class:`PreflightError` — the request itself is malformed: shapes, dtypes,
  missing or mis-prepared params, plan/graph disagreement.  Subclasses
  ``ValueError`` so ``except ValueError`` call sites keep working.
* :class:`PlanError` — a plan-construction contract was violated (a chain
  that does not start with a conv, an output region that does not tile the
  map).  A :class:`PreflightError` subclass: a broken plan is a broken
  request.
* :class:`BudgetError` — a working set does not fit the planning budget (at
  plan time or at launch time).  Also a ``ValueError`` subclass.
* :class:`NumericError` — non-finite or out-of-magnitude values.  Subclasses
  ``FloatingPointError``.
* :class:`DeadlineExceeded` — a serving request missed its deadline.
  Subclasses ``TimeoutError``.
* :class:`FaultInjected` — raised only by a deterministic fault harness;
  never by production code.

The module imports nothing outside the standard library, so every layer of
the port can raise from it without import cycles.
"""

from __future__ import annotations


class RobustError(Exception):
    """Base of every typed error the port raises.

    ``context`` keys (node, launch, stage, ...) ride along machine-readable;
    the message is built once so ``str(e)`` shows them too.
    """

    def __init__(self, message: str, **context):
        self.context = context
        if context:
            detail = ", ".join(f"{k}={v!r}" for k, v in context.items())
            message = f"{message} [{detail}]"
        super().__init__(message)


class PreflightError(RobustError, ValueError):
    """The request is structurally invalid: shape/dtype/param/plan
    disagreement caught before any kernel launch."""


class PlanError(PreflightError):
    """A plan-construction contract was violated (tile-program compiler or
    launch-planner preconditions)."""


class BudgetError(RobustError, ValueError):
    """A working set (or every candidate launch regime) exceeds the planning
    budget; ``context`` names the launch/spec that failed."""


class NumericError(RobustError, FloatingPointError):
    """Non-finite (or out-of-magnitude) values detected in params or in a
    launch output."""


class DeadlineExceeded(RobustError, TimeoutError):
    """A serving request's deadline passed before (or instead of) useful
    work."""


class FaultInjected(RobustError, RuntimeError):
    """An exception planted by a deterministic fault-injection harness;
    ``context['stage']`` names the stage it fired at."""
