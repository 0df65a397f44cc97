"""Continuous-batching serving scheduler (control plane).

Production serving multiplexes many requests over fixed-shape decode slots:
requests arrive with a prompt, occupy a batch slot while decoding, and free
it on completion — the decode step itself stays a single compiled function
(fixed batch, fixed max_seq, per-slot position indices).

The scheduler is pure control logic (device-free, unit-tested):

* slot allocation with admission by prompt length (a prompt must fit in the
  remaining cache);
* per-slot position tracking feeding ``decode_step``'s ``cache_index`` (the
  model supports per-call scalar positions; batched serving drives one step
  per position cohort — slots at the same position batch together);
* preemption policy: when the queue starves, the longest-running request
  past ``preempt_after`` tokens can be evicted to a re-queue (its state is
  recoverable from its token history — deterministic recompute, the same
  trade USEFUSE makes for overlap tiles: recompute beats buffering when
  buffers are the scarce resource);
* fairness: FIFO admission with an anti-starvation bump for requests
  waiting longer than ``max_wait_steps``.

The port's copy of the reference's ``repro.runtime.scheduler``: pure
Python control logic, unchanged.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    arrived_step: int = 0
    generated: int = 0
    slot: int | None = None

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens

    @property
    def position(self) -> int:
        return self.prompt_len + self.generated


@dataclass
class BatchScheduler:
    n_slots: int
    max_seq: int
    preempt_after: int = 1024
    max_wait_steps: int = 64

    queue: deque = field(default_factory=deque)
    active: dict[int, Request] = field(default_factory=dict)  # slot -> req
    step: int = 0
    completed: list[int] = field(default_factory=list)
    preempted: int = 0

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request):
        req.arrived_step = self.step
        if req.prompt_len + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.rid} needs {req.prompt_len + req.max_new_tokens}"
                f" > max_seq {self.max_seq}"
            )
        self.queue.append(req)

    def _free_slots(self) -> list[int]:
        return [s for s in range(self.n_slots) if s not in self.active]

    def admit(self) -> list[Request]:
        """Fill free slots FIFO; anti-starvation: preempt for requests that
        waited beyond max_wait_steps when no slot frees up naturally."""
        admitted = []
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            req.slot = slot
            self.active[slot] = req
            admitted.append(req)
        if self.queue and not self._free_slots():
            head = self.queue[0]
            if self.step - head.arrived_step > self.max_wait_steps:
                victim = max(
                    (r for r in self.active.values()
                     if r.generated >= self.preempt_after),
                    key=lambda r: r.generated,
                    default=None,
                )
                if victim is not None:
                    self._preempt(victim)
                    head = self.queue.popleft()
                    head.slot = victim.slot if victim.slot is not None else (
                        self._free_slots()[0]
                    )
                    # victim.slot was freed by _preempt
                    head.slot = self._free_slots()[0]
                    self.active[head.slot] = head
                    admitted.append(head)
        return admitted

    def _preempt(self, req: Request):
        assert req.slot is not None
        del self.active[req.slot]
        req.slot = None
        req.generated = 0  # deterministic recompute on re-admission
        self.preempted += 1
        self.queue.append(req)

    # -- decode loop ---------------------------------------------------------

    def tick(self) -> dict[int, int]:
        """One decode step: returns {slot: position} for the active cohort,
        advances generation counters, retires finished requests."""
        self.step += 1
        cohort = {s: r.position for s, r in self.active.items()}
        finished = []
        for s, r in self.active.items():
            r.generated += 1
            if r.done:
                finished.append(s)
        for s in finished:
            self.completed.append(self.active[s].rid)
            del self.active[s]
        return cohort

    @property
    def utilization(self) -> float:
        return len(self.active) / self.n_slots if self.n_slots else 0.0
