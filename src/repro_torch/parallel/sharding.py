"""Logical-axis sharding rules: DP (fsdp) x TP (tensor) x EP (expert) x pods.

The port of the reference's ``repro.parallel.sharding``.  Every parameter
and cache leaf carries a tuple of logical axis names (see
:mod:`repro_torch.models.params`).  Rules map logical names to mesh axes;
:func:`partition_spec` resolves ``(shape, axes, mesh)`` to the reference's
``PartitionSpec`` entries, with its two safety valves:

* divisibility fallback: a dim that does not divide by its mesh-axis
  extent drops that mapping (replicates);
* one mesh axis once: if two logical dims of one tensor resolve to the same
  mesh axis, the later one is dropped.

An entry is ``None`` (replicated), a mesh-axis name, or a tuple of names
(major to minor), and trailing ``None`` entries are dropped, as in a
``PartitionSpec``.  The resolver reads only the mesh's axis names and
sizes, so a ``{name: size}`` mapping serves as well as a ``DeviceMesh``;
:func:`placements` turns the entries into DTensor placements over a
``DeviceMesh``.  Default rules (production mesh ``(pod, data, model)``):

  batch/fsdp      -> ('pod', 'data')   # DP + FSDP parameter sharding
  tensor-ish dims -> ('model',)        # TP: heads / mlp / vocab / experts
  cache_seq       -> ('model',) for decode, ('data', 'model') long-context
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping

from repro_torch.models.params import tree_map

DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # data-parallel / fsdp family
    "batch": ("pod", "data"),
    "embed": ("pod", "data"),  # fsdp shard of the non-TP weight dim
    "layers": (),
    # tensor-parallel family
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "lora": ("model",),
    # serving
    "cache_seq": (),  # overridden for decode (rules_for)
    # activations
    "seq": (),
    "act_embed": (),
}

Entry = Any  # None | str | tuple[str, ...]


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


@dataclass(frozen=True)
class ShardingRules:
    rules: dict[str, tuple[str, ...]] = field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def override(self, **kw: tuple[str, ...]) -> "ShardingRules":
        d = dict(self.rules)
        d.update(kw)
        return ShardingRules(d)

    def mesh_axes_for(self, logical: str | None, mesh) -> tuple[str, ...]:
        if logical is None:
            return ()
        names = mesh_sizes(mesh)
        return tuple(a for a in self.rules.get(logical, ()) if a in names)


def partition_spec(shape: tuple[int, ...], logical_axes, mesh,
                   rules: ShardingRules) -> tuple[Entry, ...]:
    """One tensor's logical axes resolved to the reference's
    ``PartitionSpec`` entries."""
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    entries: list[Entry] = []
    for dim, logical in zip(shape, logical_axes):
        names = tuple(n for n in rules.mesh_axes_for(logical, sizes)
                      if n not in used)
        size = math.prod(sizes[n] for n in names)
        if not names or size <= 1 or dim % size:
            entries.append(None)  # divisibility fallback: replicate
            continue
        used.update(names)
        entries.append(names if len(names) > 1 else names[0])
    while entries and entries[-1] is None:
        entries.pop()  # trailing Nones are implicit
    return tuple(entries)


def placements(spec: tuple[Entry, ...], mesh) -> tuple:
    """DTensor placements, one per mesh dim, of a :func:`partition_spec`:
    ``Shard(d)`` on every mesh dim that tensor dim ``d`` names (a dim over
    two mesh axes is sharded on both, major to minor, as the entries list
    them), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry,) if isinstance(entry, str) else entry:
            out[names.index(name)] = Shard(d)
    return tuple(out)


def local_shape(shape: tuple[int, ...], spec: tuple[Entry, ...],
                mesh) -> tuple[int, ...]:
    """One device's shard of a tensor of ``shape`` under ``spec`` (the
    resolver only shards dims that divide evenly)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            names = (entry,) if isinstance(entry, str) else entry
            out[d] //= math.prod(sizes[n] for n in names)
    return tuple(out)


def spec_shardings(spec_tree, mesh, rules: ShardingRules):
    """P-spec tree -> the tree of each leaf's placements over ``mesh``."""
    return tree_map(
        lambda s: placements(partition_spec(s.shape, s.axes, mesh, rules),
                             mesh), spec_tree)


def batch_sharding(mesh, rules: ShardingRules, ndim: int = 2) -> tuple:
    """Placements of a ``(B, S, ...)`` token batch: batch over DP axes."""
    names = rules.mesh_axes_for("batch", mesh)
    entry = names if len(names) > 1 else (names[0] if names else None)
    return placements((entry,), mesh)


def shard_batch_spec(shape: tuple[int, ...], mesh, rules: ShardingRules,
                     logical: tuple[str | None, ...]) -> tuple:
    return placements(partition_spec(shape, logical, mesh, rules), mesh)


# canonical rule variants -----------------------------------------------------

def rules_for(step: str, *, long_context: bool = False) -> ShardingRules:
    """Rule set per step kind (train / prefill / decode)."""
    r = ShardingRules()
    if step == "decode":
        if long_context:
            # batch=1: shard the cache sequence over data AND model
            # (context parallelism); the pod axis replicates (B=1)
            return r.override(cache_seq=("data", "model"), batch=("pod",))
        # kv_heads rarely divide the model axis; shard the cache sequence
        # over 'model' instead (context-parallel serving): the resolver
        # gives 'model' to cache_seq first, kv_heads then drops
        return r.override(cache_seq=("model",))
    return r


__all__ = ["DEFAULT_RULES", "ShardingRules", "batch_sharding",
           "local_shape", "mesh_sizes", "partition_spec", "placements",
           "rules_for", "shard_batch_spec", "spec_shardings"]
