"""Deterministic, seeded fault injection for the guarded runtime.

The port of the reference's ``repro.robust.faults``.  The chaos suite must
*prove* the degradation ladder: every fault class terminates at a
successful forward whose logits match the reference.  That needs faults
that are injectable on demand, deterministic under a seed, and scoped to a
named launch — this module is that harness.  Nothing here runs in
production: the injector defaults to :data:`NULL_INJECTOR` (``enabled =
False``) and only the guarded runner consults it.

Corrupted positions are drawn from ``numpy.random.default_rng(seed)``
exactly as the reference draws them, so the index sets equal the
reference's; the poison itself is written on the tensor's own device.

Fault classes (mirroring the ladder's rungs):

* :func:`corrupt_params` — NaN/Inf corruption of a named node's weights at
  seeded positions.  Caught by the preflight finite-params check.
* ``FaultInjector.squeeze_budget`` — a simulated budget squeeze: the
  guarded runner multiplies the plan's budget by this factor, so launches
  that planned clean now violate it → the replan rung fires genuinely.
* ``FaultInjector.raise_at`` — a planted exception at a named stage
  (``plan`` / ``compile`` / ``run``) of a named launch, firing a bounded
  number of times (default once, so the eager retry can succeed; more to
  force the fall-through to the reference path).
* ``FaultInjector.poison_output`` — overwrite seeded positions of a named
  launch's output with NaN/Inf after the kernel ran (models a kernel
  miscompute).  Caught by the runtime numeric sentinel → quarantine.

Serving fault classes (consumed by a serving engine): ``slow_launch``,
``raise_at("stage", ...)`` and ``stall_queue``.

Use::

    from repro_torch.robust import inject

    with inject(seed=0) as inj:
        inj.raise_at("compile", launch="CL1..MPL2")
        inj.squeeze_budget(0.05)
        ... run guarded ...
    print(inj.fired)   # deterministic fire log
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

from .errors import FaultInjected

# "stage" is a serving engine's host->device staging copy; the guarded
# runner itself only consults plan/compile/run
STAGES = ("plan", "compile", "run", "stage")


def _match(pattern: str | None, launch: str) -> bool:
    return pattern is None or pattern == launch or pattern in launch


def _poisoned(t: torch.Tensor, idx: np.ndarray, kind: str) -> torch.Tensor:
    """A copy of ``t`` with flat positions ``idx`` set to NaN or Inf,
    written on ``t``'s device."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    flat = out.view(-1)  # row-major, as the reference's reshape(-1)
    flat[torch.as_tensor(idx, device=t.device)] = (
        float("nan") if kind == "nan" else float("inf")
    )
    return out


def corrupt_params(
    params: dict,
    node: str,
    *,
    kind: str = "nan",
    fraction: float = 0.05,
    seed: int = 0,
) -> dict:
    """A new params dict with ``node``'s weight tensor corrupted at seeded
    positions (``max(1, fraction * size)`` of them) — NaN or Inf per
    ``kind``.  The input dict is not mutated; every other entry is shared.

    Flattened streamed-weight entries (``"_flat/..."``) are rebuilt by
    :func:`repro_torch.net.runner.prepare_network_params`, not here —
    corrupt the master params and re-prepare, or corrupt the prepared dict
    directly to model staging-copy corruption.
    """
    if node not in params:
        raise KeyError(f"no params for node {node!r}; have {sorted(params)}")
    if kind not in ("nan", "inf"):
        raise ValueError(f"kind must be 'nan' or 'inf', got {kind!r}")
    w, b = params[node]
    rng = np.random.default_rng(seed)
    n_bad = max(1, int(fraction * w.numel()))
    idx = rng.choice(w.numel(), size=n_bad, replace=False)
    out = dict(params)
    out[node] = (_poisoned(w, idx, kind), b)
    return out


@dataclass
class _PlannedRaise:
    stage: str
    launch: str | None
    times: int
    message: str


@dataclass
class _PlannedPoison:
    launch: str | None
    kind: str
    times: int


@dataclass
class _PlannedDelay:
    launch: str | None
    delay_s: float
    times: int


@dataclass
class FaultInjector:
    """Armed faults + a deterministic fire log.

    The guarded runner calls :meth:`fire` at each stage boundary and
    :meth:`corrupt_output` on each launch result; with nothing armed both
    are no-ops.  All randomness (poison positions) derives from ``seed``.
    """

    seed: int = 0
    enabled: bool = True
    vmem_factor: float = 1.0
    raises: list = field(default_factory=list)
    poisons: list = field(default_factory=list)
    delays: list = field(default_factory=list)
    stalls: int = 0
    fired: list = field(default_factory=list)

    # -- arming ------------------------------------------------------------

    def raise_at(
        self,
        stage: str,
        *,
        launch: str | None = None,
        times: int = 1,
        message: str = "injected fault",
    ) -> None:
        """Arm an exception at ``stage`` for launches matching ``launch``
        (substring; ``None`` = every launch), firing ``times`` times."""
        if stage not in STAGES:
            raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
        self.raises.append(_PlannedRaise(stage, launch, times, message))

    def poison_output(
        self, *, launch: str | None = None, kind: str = "nan", times: int = 1
    ) -> None:
        """Arm output corruption of matching launches: seeded positions of
        the result tensor become NaN/Inf ``times`` times."""
        if kind not in ("nan", "inf"):
            raise ValueError(f"kind must be 'nan' or 'inf', got {kind!r}")
        self.poisons.append(_PlannedPoison(launch, kind, times))

    def squeeze_budget(self, factor: float) -> None:
        """Simulate budget pressure: the guarded runner scales the plan's
        budget by ``factor`` (0 < factor <= 1) when checking each launch."""
        if not 0 < factor <= 1:
            raise ValueError(f"factor must be in (0, 1], got {factor}")
        self.vmem_factor = factor

    def slow_launch(
        self,
        delay_s: float,
        *,
        launch: str | None = None,
        times: int = 1,
    ) -> None:
        """Arm a stuck launch: matching launches sleep ``delay_s`` seconds
        on the host before their result is consumed, firing ``times``
        times."""
        if delay_s <= 0:
            raise ValueError(f"delay_s must be positive, got {delay_s}")
        self.delays.append(_PlannedDelay(launch, delay_s, times))

    def stall_queue(self, times: int = 1) -> None:
        """Arm ``times`` drain-loop stalls: a serving drain loop skips a
        scheduling turn per stall (work stays queued, nothing is lost)."""
        if times < 1:
            raise ValueError(f"times must be >= 1, got {times}")
        self.stalls += times

    # -- consumption (guarded runner only) ---------------------------------

    def fire(self, stage: str, launch: str) -> None:
        """Raise the armed :class:`FaultInjected` for (stage, launch) if any
        remains, decrementing its fire count."""
        for pr in self.raises:
            if pr.times > 0 and pr.stage == stage and _match(pr.launch, launch):
                pr.times -= 1
                self.fired.append((stage, launch, "raise"))
                raise FaultInjected(pr.message, stage=stage, launch=launch)

    def launch_delay(self, launch: str) -> float:
        """Seconds the armed stuck-launch fault wants ``launch`` delayed
        (0.0 when nothing matches); decrements the fire count."""
        for pd in self.delays:
            if pd.times > 0 and _match(pd.launch, launch):
                pd.times -= 1
                self.fired.append(("slow", launch, f"{pd.delay_s}s"))
                return pd.delay_s
        return 0.0

    def queue_stalled(self) -> bool:
        """Consume one armed drain-loop stall if any remain."""
        if self.stalls > 0:
            self.stalls -= 1
            self.fired.append(("stall", "<queue>", "skip"))
            return True
        return False

    def corrupt_output(self, launch: str, y: torch.Tensor) -> torch.Tensor:
        """Return ``y`` with seeded poison applied (``max(1, size // 64)``
        positions) if armed for ``launch``, else ``y`` unchanged."""
        for pp in self.poisons:
            if pp.times > 0 and _match(pp.launch, launch):
                pp.times -= 1
                self.fired.append(("output", launch, f"poison_{pp.kind}"))
                rng = np.random.default_rng(self.seed)
                idx = rng.choice(y.numel(), size=max(1, y.numel() // 64),
                                 replace=False)
                return _poisoned(y, idx, pp.kind)
        return y


class _NullInjector:
    """No faults armed, nothing recorded — the production default."""

    enabled = False
    vmem_factor = 1.0
    fired: tuple = ()

    def fire(self, stage: str, launch: str) -> None:
        pass

    def launch_delay(self, launch: str) -> float:
        return 0.0

    def queue_stalled(self) -> bool:
        return False

    def corrupt_output(self, launch: str, y):
        return y


NULL_INJECTOR = _NullInjector()

_injector = NULL_INJECTOR


def get_injector():
    """The process-global injector: :data:`NULL_INJECTOR` unless a
    :class:`FaultInjector` is scoped via :func:`inject`."""
    return _injector


def set_injector(injector) -> None:
    """Install ``injector`` globally (``None`` restores the no-op)."""
    global _injector
    _injector = NULL_INJECTOR if injector is None else injector


@contextlib.contextmanager
def inject(seed: int = 0, injector: FaultInjector | None = None):
    """Scope a :class:`FaultInjector` as the process injector; yields it.
    Nesting restores the previous injector on exit."""
    inj = FaultInjector(seed=seed) if injector is None else injector
    prev = get_injector()
    set_injector(inj)
    try:
        yield inj
    finally:
        set_injector(prev)
