"""Fault tolerance: heartbeats, failure detection, restart policy, elastic
rescale planning.

On a real multi-host deployment this wraps the process group's launcher +
the cluster scheduler; here the control-plane logic is implemented and unit-tested
against a simulated cluster so the policy is exercised end to end:

* every host heartbeats; a coordinator marks hosts dead after
  ``timeout_s`` without one;
* on failure: pick the restart plan — same-size restart from the newest
  complete checkpoint, or an **elastic downsize** to the largest feasible
  mesh if spares are unavailable (mesh candidates preserve the model axis,
  shrink the data axis — the checkpoint restores onto any of them via the
  restore path in :mod:`repro_torch.checkpoint.checkpointer`);
* deterministic data replay: the pipeline is a pure function of step, so
  the restored run re-consumes exactly the post-checkpoint batches.

The port's copy of the reference's ``repro.runtime.fault_tolerance``: pure
Python control logic, unchanged.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    alive: bool = True


@dataclass
class FaultTolerantCluster:
    n_hosts: int
    timeout_s: float = 30.0
    clock: callable = time.monotonic
    hosts: dict[int, HostState] = field(default_factory=dict)

    def __post_init__(self):
        now = self.clock()
        self.hosts = {
            i: HostState(i, now) for i in range(self.n_hosts)
        }

    def heartbeat(self, host_id: int):
        h = self.hosts[host_id]
        h.last_heartbeat = self.clock()
        h.alive = True

    def check(self) -> list[int]:
        """Mark and return hosts that missed the heartbeat window."""
        now = self.clock()
        dead = []
        for h in self.hosts.values():
            if h.alive and now - h.last_heartbeat > self.timeout_s:
                h.alive = False
            if not h.alive:
                dead.append(h.host_id)
        return dead

    @property
    def alive_count(self) -> int:
        return sum(h.alive for h in self.hosts.values())


@dataclass(frozen=True)
class RestartPlan:
    kind: str  # "same_size" | "elastic_downsize" | "halt"
    mesh_shape: tuple[int, ...]
    restore_step: int | None
    replay_from: int | None  # first data step to re-consume


def plan_restart(
    *,
    alive_hosts: int,
    hosts_per_replica: int,
    base_mesh: tuple[int, ...],  # (data, model) in units of hosts x chips
    spare_hosts: int,
    latest_checkpoint: int | None,
) -> RestartPlan:
    """Decide the post-failure topology.

    The model axis is preserved (param sharding must stay valid);
    the data axis shrinks to the largest power-of-two that the surviving
    hosts support when no spares can backfill.  When the survivors cannot
    hold even one model replica (``capacity < model_ax``) no downsized mesh
    exists: the plan is an explicit ``"halt"`` (empty mesh, checkpoint
    preserved for a later restart) rather than a bogus 1-replica mesh the
    cluster cannot actually place.
    """
    data_ax, model_ax = base_mesh
    needed = data_ax * model_ax // hosts_per_replica
    if alive_hosts + spare_hosts >= needed:
        return RestartPlan(
            kind="same_size",
            mesh_shape=base_mesh,
            restore_step=latest_checkpoint,
            replay_from=None if latest_checkpoint is None else latest_checkpoint + 1,
        )
    capacity = alive_hosts * hosts_per_replica
    if capacity < model_ax:
        # infeasible: not enough surviving chips for one model replica —
        # halt and wait for backfill instead of planning a mesh that the
        # elastic loop below would silently report as (1, model_ax)
        return RestartPlan(
            kind="halt",
            mesh_shape=(0, model_ax),
            restore_step=latest_checkpoint,
            replay_from=None,
        )
    # elastic: shrink data axis to the largest feasible power of two
    new_data = 1
    while new_data * 2 * model_ax <= capacity:
        new_data *= 2
    return RestartPlan(
        kind="elastic_downsize",
        mesh_shape=(new_data, model_ax),
        restore_step=latest_checkpoint,
        replay_from=None if latest_checkpoint is None else latest_checkpoint + 1,
    )
