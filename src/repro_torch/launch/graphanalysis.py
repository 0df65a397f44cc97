"""Per-device cost of a step from its per-rank FX graphs.

The counterpart of the reference's ``repro.launch.hloanalysis``, which
parses compiled post-SPMD HLO text.  There is no HLO here: the dry run
(:mod:`repro_torch.launch.dryrun`) records a step over DTensors into a
per-rank FX graph, whose tensors have local (per-device) shapes and whose
communication is ``_c10d_functional`` collectives (any FX graph of the
same kind serves, an AOTAutograd one included).  So, as in the reference,
every output is a per-device quantity:

* dot FLOPs: ``torch.utils.flop_counter``'s formula registry applied to
  each node's fake arguments (matmuls, convolutions, attention, kernel
  D's custom op ``repro_torch::ssd_scan``, whose formula counts the plain
  chunked SSD's dots, and its backward's ``repro_torch::ssd_scan_bwd``,
  whose formula counts the backward kernel's), so a ``FlopCounterMode``
  on the card and this analysis count alike;
* collective bytes ON WIRE per device, on the reference's ring model with
  group size g and S the collective's result bytes: all-reduce
  ``2*S*(g-1)/g``, all-gather ``S*(g-1)/g``, reduce-scatter ``S*(g-1)``,
  all-to-all ``S*(g-1)/g``, permute ``S`` (:func:`_wire_bytes`, copied);
  each is also filed under the mesh axes its group spans, so the roofline
  can price NVLink and InfiniBand apart;
* an HBM-traffic proxy: the bytes of every materialised node output (views
  and collectives' waits excluded).

The graphs are unrolled Python loops, so there are no trip counts to
recover.  The reference's ``xla_cost_dict`` (XLA's own cost analysis) has
no counterpart: there is no compiler cost model to ask.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


@dataclass
class GraphCost:
    flops: float = 0.0
    collective_bytes: float = 0.0
    traffic_bytes: float = 0.0
    by_collective: dict = field(default_factory=dict)
    n_collectives: int = 0
    # wire bytes of collectives whose group stays inside the given axes
    by_axes: dict = field(default_factory=dict)


def _wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)  # collective-permute


def tensor_bytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(tensor_bytes(x) for x in t)
    return 0


def _val(a):
    if isinstance(a, torch.fx.Node):
        return a.meta.get("val")
    if isinstance(a, (list, tuple)):
        return type(a)(_val(x) for x in a)
    if isinstance(a, dict):
        return {k: _val(v) for k, v in a.items()}
    return a


def _op_name(target) -> str:
    name = getattr(target, "_opname", None) or getattr(target, "__name__", "")
    return str(name).split(".")[0]


def is_view(target) -> bool:
    """Whether an op's outputs alias its inputs (no new buffer)."""
    schema = getattr(target, "_schema", None)
    if schema is None:
        return True  # getitem and other Python helpers
    if _op_name(target) == "wait_tensor":
        return True
    return any(r.alias_info is not None for r in schema.returns)


def _group_of(node: torch.fx.Node) -> str | None:
    """The group name: a collective's last string argument (an all-reduce
    names its reduce op before it)."""
    names = [a for a in list(node.args) + list(node.kwargs.values())
             if isinstance(a, str)]
    return names[-1] if names else None


def group_axes(mesh) -> dict[str, tuple[tuple[str, ...], int]]:
    """``{group name: (mesh axes, size)}`` for each single mesh axis's
    process group of ``mesh``."""
    out = {}
    for i, name in enumerate(mesh.mesh_dim_names):
        grp = mesh.get_group(i)
        out[grp.group_name] = ((name,), int(mesh.size(i)))
    return out


def _group_size(gname: str | None) -> int:
    if gname is None:
        return 1
    from torch.distributed.distributed_c10d import _resolve_process_group

    return int(_resolve_process_group(gname).size())


def analyze_graphs(graphs, groups: dict | None = None) -> GraphCost:
    """Per-device cost of the per-rank FX ``graphs`` (``GraphModule`` or
    ``Graph``) of one step; ``groups`` maps a process-group name to its
    mesh axes and size (:func:`group_axes`; an unknown group is sized by
    its process group and filed under axes ``("?",)``)."""
    from torch.utils.flop_counter import flop_registry

    groups = groups or {}
    cost = GraphCost()
    for g in graphs:
        graph = getattr(g, "graph", g)
        for node in graph.nodes:
            if node.op != "call_function":
                continue
            target = node.target
            packet = getattr(target, "overloadpacket", None)
            out = node.meta.get("val")
            formula = flop_registry.get(packet)
            if formula is not None:
                cost.flops += float(formula(*_val(node.args),
                                            **_val(node.kwargs),
                                            out_val=out))
            kind = _COLLECTIVES.get(_op_name(target))
            if kind is not None:
                gname = _group_of(node)
                axes, size = groups.get(gname, (("?",), _group_size(gname)))
                wire = _wire_bytes(kind, tensor_bytes(out), size)
                cost.collective_bytes += wire
                cost.n_collectives += 1
                key = f"{kind}(g={size})"
                cost.by_collective[key] = cost.by_collective.get(key, 0.0) + wire
                ak = "+".join(axes)
                cost.by_axes[ak] = cost.by_axes.get(ak, 0.0) + wire
                continue
            if not is_view(target):
                cost.traffic_bytes += tensor_bytes(out)
    return cost


def output_bytes(graph) -> int:
    """Bytes of the values ``graph`` returns."""
    graph = getattr(graph, "graph", graph)
    out = next((n for n in graph.nodes if n.op == "output"), None)
    return 0 if out is None else sum(tensor_bytes(_val(a))
                                     for a in out.all_input_nodes)


def scratch_bytes(node) -> int:
    """Bytes a node's kernel allocates for itself and frees before it
    returns, beside its outputs: the float32 workspace of kernel D's
    backward (``repro_torch::ssd_scan_bwd``); 0 for every other node."""
    if node.op != "call_function" or _op_name(node.target) != "ssd_scan_bwd":
        return 0
    from repro_torch.kernels.ssd_scan.ssd_scan import (
        ssd_scan_bwd_workspace_bytes)

    x, B = _val(node.args[0]), _val(node.args[3])
    return ssd_scan_bwd_workspace_bytes(x.shape, B.shape, node.args[8])


def peak_live_bytes(graph) -> int:
    """The most bytes live at once over a walk of ``graph`` in its order:
    each non-view node's output is allocated where it is computed and
    freed after its last use (a view keeps its base alive), and its
    :func:`scratch_bytes` live while it runs; inputs (placeholders) are
    not counted and graph outputs live to the end."""
    graph = getattr(graph, "graph", graph)
    nodes = list(graph.nodes)
    base: dict = {}  # node -> the allocating node it aliases
    size: dict = {}
    for n in nodes:
        if n.op == "placeholder":
            base[n] = None
        elif n.op == "call_function":
            if is_view(n.target):
                src = next((a for a in n.all_input_nodes if a in base), None)
                base[n] = base.get(src) if src is not None else None
            else:
                base[n] = n
                size[n] = tensor_bytes(n.meta.get("val"))
    last: dict = {}
    for i, n in enumerate(nodes):
        for a in n.all_input_nodes:
            b = base.get(a)
            if b is not None:
                last[b] = i if n.op != "output" else len(nodes)
    live = peak = 0
    free_at: dict[int, list] = {}
    for b, i in last.items():
        free_at.setdefault(i, []).append(b)
    for i, n in enumerate(nodes):
        if size.get(n):
            live += size[n]
            peak = max(peak, live + scratch_bytes(n))
            if n not in last:  # never used: freed at once
                live -= size[n]
        for b in free_at.get(i, ()):
            live -= size.get(b, 0)
    return peak
