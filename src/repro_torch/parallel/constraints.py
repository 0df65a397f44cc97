"""Activation sharding constraints via a process-level mesh registry.

The port of the reference's ``repro.parallel.constraints``.  Model code
calls ``constrain(x, "batch", None, "vocab")`` at the few decision points
that matter (the residual stream at each layer, the loss's hidden states
and logits); the launcher registers the active ``(mesh, rules)`` pair
before it traces a step.  Outside a registered mesh, and on a tensor that
is not a DTensor (one GPU, the tests), a constraint is the identity, so
model code stays mesh-agnostic.  On a DTensor it is a ``redistribute`` to
the placements the rules give, the counterpart of
``with_sharding_constraint``.

:func:`split_rows` is the microbatch split of a training batch: a plain
reshape, as the reference's, and on a DTensor sharded along its rows a
split of each device's own rows, which DTensor can express where the
global reshape would need a resharding it refuses.
"""

from __future__ import annotations

from typing import Optional

import torch

from .sharding import ShardingRules, partition_spec, placements

_ACTIVE: list[tuple[object, ShardingRules]] = []


class mesh_rules:
    """Context manager registering ``(mesh, rules)`` for :func:`constrain`."""

    def __init__(self, mesh, rules: ShardingRules):
        self.pair = (mesh, rules)

    def __enter__(self):
        _ACTIVE.append(self.pair)
        return self

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return False


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor" and hasattr(x, "device_mesh")


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Pin activation sharding by logical axis names (the identity with no
    registered mesh or on a tensor that is not a DTensor)."""
    if not _ACTIVE or not _is_dtensor(x):
        return x
    mesh, rules = _ACTIVE[-1]
    spec = partition_spec(tuple(x.shape), tuple(logical), mesh, rules)
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def split_rows(t: torch.Tensor, parts: int) -> torch.Tensor:
    """``t (B, ...)`` as ``(parts, B / parts, ...)``.  A plain tensor is
    reshaped: part ``i`` holds rows ``i * B / parts ..``.  A DTensor whose
    rows are sharded is split on each device: part ``i`` holds the
    ``i``-th slice of every device's rows, so no row moves between
    devices.  The parts then hold other rows than the reshape's, and a
    training step's mean loss and gradient over all of them are the same
    up to the order of the sums."""
    if t.shape[0] % parts:
        raise ValueError(f"{t.shape[0]} rows do not split into {parts}"
                         " parts")
    shape = (parts, t.shape[0] // parts) + tuple(t.shape[1:])
    if not _is_dtensor(t) or not any(
            getattr(p, "dim", None) == 0 for p in t.placements):
        return t.reshape(shape)
    from torch.distributed.tensor import DTensor, Shard

    loc = t.to_local()
    if loc.shape[0] % parts:
        raise ValueError(f"a device's {loc.shape[0]} rows do not split"
                         f" into {parts} parts")
    loc = loc.reshape((parts, loc.shape[0] // parts) + tuple(loc.shape[1:]))
    pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p
          for p in t.placements]
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(loc, t.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)
