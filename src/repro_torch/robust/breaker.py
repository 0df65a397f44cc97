"""Per-key circuit breaker: stop re-running a path that keeps failing.

The port of the reference's ``repro.robust.breaker`` (stdlib only).  The
degradation ladder (:mod:`repro_torch.robust.degrade`) makes one launch
survive one fault — but it pays the failed fused attempt *every time*.
Under sustained failure, retrying the fused path per batch turns a
degraded-but-correct service into a slow one.  A serving engine therefore
keeps one :class:`CircuitBreaker` per plan-cache key (graph, bucket, dtype)
and routes launches by its state:

* **closed** — healthy: run the normal (fused / guarded) path.  Each
  failure increments a consecutive-failure count; :attr:`threshold`
  consecutive failures open the breaker.  Any success resets the count.
* **open** — failing: skip the fused path and serve from the **pinned
  rung** — the last rung that produced a good result for this key, or the
  reference path when nothing gentler is known.  After :attr:`cooldown_s`
  seconds the next launch moves the breaker to half-open.
* **half-open** — probing: exactly one launch retries the normal path.
  Success closes the breaker (and clears the pin); failure re-opens it and
  restarts the cooldown.

Transitions are appended to :attr:`transitions`.  The clock is injectable
for deterministic tests.  The breaker never runs anything: it only answers
:meth:`allow` ("may the fused path run?") and consumes
:meth:`record_success` / :meth:`record_failure`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: rung order a serving engine degrades through when the breaker pins a
#: key: gentler first.  "fused" is the healthy path, not a pin target.
PIN_RUNGS = ("eager", "reference")


@dataclass(frozen=True)
class BreakerSnapshot:
    """One JSON-safe view of a breaker, for a serving summary."""

    state: str
    failures: int
    threshold: int
    pinned_rung: str | None
    opens: int
    transitions: int


@dataclass
class CircuitBreaker:
    """Consecutive-failure circuit breaker with rung pinning.

    ``threshold`` consecutive failures open the breaker for ``cooldown_s``
    seconds; ``clock`` defaults to ``time.monotonic`` and is injectable so
    tests drive the cooldown without sleeping.
    """

    threshold: int = 3
    cooldown_s: float = 5.0
    clock: callable = time.monotonic
    state: str = CLOSED
    failures: int = 0
    pinned_rung: str | None = None
    opened_at: float | None = None
    opens: int = 0
    transitions: list = field(default_factory=list)

    def __post_init__(self):
        if self.threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {self.threshold}")
        if self.cooldown_s < 0:
            raise ValueError(
                f"cooldown_s must be >= 0, got {self.cooldown_s}"
            )

    # -- queries -------------------------------------------------------------

    def allow(self) -> bool:
        """May the normal (fused) path run now?

        ``True`` when closed, and when an open breaker's cooldown has
        elapsed — in which case the breaker moves to half-open and this
        launch is the probe.  ``False`` while open (serve the pinned rung)
        and while a half-open probe is already outstanding."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self.clock() - self.opened_at >= self.cooldown_s:
                self._transition(HALF_OPEN, "cooldown elapsed")
                return True
            return False
        # HALF_OPEN: the probe was already granted; concurrent launches
        # stay on the pinned rung until record_success/record_failure
        return False

    # -- signals -------------------------------------------------------------

    def record_success(self) -> None:
        """A normal-path launch completed clean: reset, close, unpin."""
        self.failures = 0
        if self.state != CLOSED:
            self._transition(CLOSED, "probe succeeded")
            self.pinned_rung = None

    def record_failure(self, *, rung: str | None = None) -> None:
        """A normal-path launch failed.  ``rung`` names the gentlest rung
        that still produced a good result this launch; it becomes the pin
        when the breaker opens.  ``None`` keeps the previous pin."""
        if rung is not None:
            self.pinned_rung = rung
        if self.state == HALF_OPEN:
            self._reopen("probe failed")
            return
        self.failures += 1
        if self.state == CLOSED and self.failures >= self.threshold:
            self._reopen(f"{self.failures} consecutive failures")

    # -- internals -----------------------------------------------------------

    def _reopen(self, why: str) -> None:
        self.opened_at = self.clock()
        self.opens += 1
        self._transition(OPEN, why)

    def _transition(self, to: str, why: str) -> None:
        self.transitions.append(
            {"from": self.state, "to": to, "why": why, "at_s": self.clock()}
        )
        self.state = to

    def snapshot(self) -> BreakerSnapshot:
        return BreakerSnapshot(
            state=self.state,
            failures=self.failures,
            threshold=self.threshold,
            pinned_rung=self.pinned_rung,
            opens=self.opens,
            transitions=len(self.transitions),
        )
