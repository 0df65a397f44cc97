"""Straggler mitigation: step-time outlier detection + mitigation plan.

Synchronous SPMD training runs at the speed of the slowest participant.  The
detector keeps an EWMA + variance of per-host step times and flags hosts
whose time exceeds ``mean + k * std`` for ``patience`` consecutive steps.
Mitigations, in escalation order:

1. ``rebalance_input``  — shift data-loading work off the slow host (the
   deterministic pipeline makes shard reassignment trivial);
2. ``exclude_next_rescale`` — mark the host so the next elastic event
   (checkpoint boundary) drops it, rather than paying a mid-step stop;
3. ``immediate_restart``  — only when the slowdown exceeds ``hard_ratio``x
   the fleet mean (e.g. a flapping HBM), worth the restart cost.

The port's copy of the reference's ``repro.runtime.straggler``: pure
Python control logic, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StragglerDetector:
    n_hosts: int
    alpha: float = 0.1  # EWMA factor
    k: float = 3.0  # flag threshold in stddevs
    patience: int = 5
    hard_ratio: float = 2.0

    mean: list[float] = field(default_factory=list)
    var: list[float] = field(default_factory=list)
    strikes: list[int] = field(default_factory=list)

    def __post_init__(self):
        self.mean = [0.0] * self.n_hosts
        self.var = [0.0] * self.n_hosts
        self.strikes = [0] * self.n_hosts
        self._warm = [False] * self.n_hosts

    def observe(self, step_times: list[float]) -> dict[int, str]:
        """Feed per-host step times; returns {host: mitigation} decisions."""
        fleet_mean = sum(step_times) / len(step_times)
        decisions: dict[int, str] = {}
        for h, t in enumerate(step_times):
            if not self._warm[h]:
                self.mean[h], self.var[h], self._warm[h] = t, 0.0, True
                continue
            # compare against the PRE-update baseline, and keep flagged
            # samples out of the EWMA — a straggler must not normalize its
            # own slowness into the baseline
            std = max(self.var[h] ** 0.5, 0.02 * self.mean[h], 1e-6)
            slow = t > self.mean[h] + self.k * std and t > fleet_mean * 1.2
            if not slow:
                d = t - self.mean[h]
                self.mean[h] += self.alpha * d
                self.var[h] = (1 - self.alpha) * (self.var[h] + self.alpha * d * d)
            self.strikes[h] = self.strikes[h] + 1 if slow else 0
            if t > fleet_mean * self.hard_ratio and self.strikes[h] >= self.patience:
                decisions[h] = "immediate_restart"
            elif self.strikes[h] >= self.patience:
                decisions[h] = "exclude_next_rescale"
            elif self.strikes[h] == max(self.patience // 2, 1):
                decisions[h] = "rebalance_input"
        return decisions
