"""Typed errors of the port (stdlib only); see :mod:`.errors`."""

from .errors import (
    BudgetError,
    DeadlineExceeded,
    FaultInjected,
    NumericError,
    PlanError,
    PreflightError,
    RobustError,
)

__all__ = [
    "BudgetError",
    "DeadlineExceeded",
    "FaultInjected",
    "NumericError",
    "PlanError",
    "PreflightError",
    "RobustError",
]
