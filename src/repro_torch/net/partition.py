"""Memory-aware auto-partitioner: where to cut the fusion pyramids.

A copy of the reference package's ``repro.net.partition``: the DP, its
costs and its tie-breaks are unchanged so the port's plans equal the
reference's field by field at the same (parity) budget.

USEFUSE fuses hand-picked layer groups; the whole-network claim — reduced
off-chip communication for CNN deployment — needs the *cut points* chosen by
a memory-aware search (MAFAT's fusing/tiling formulation).  This module runs
that search over the graph IR:

* Legality: pyramids live inside :func:`~repro_torch.net.graph.fusable_segments`
  (linear conv/pool chains).  Residual joins, forks (a block input feeding
  body + shortcut), and head ops terminate segments, so they are cut points
  by construction.  Within a segment the indivisible unit is the *conv
  group* — one conv plus its trailing pools — because a pool executes as its
  conv's epilogue (Fig. 4; ``kernels/fused_conv/ops.conv_groups``).
* Cost: each candidate pyramid is costed by the tile-program compiler's
  :func:`~repro_torch.core.program.plan_launch` hook — exact modeled HBM bytes for
  the launch (reads + writes + weights, re-read per grid cell when the
  VMEM budget forces the streamed-weight regime) and the DS-1 cycle model as
  the latency tiebreaker.  A pyramid no launch regime can fit is illegal.
* Search: per segment, a dynamic program over conv-group cut positions
  minimizing summed (HBM bytes, modeled cycles) lexicographically — optimal
  over the exponential cut space in O(G^2) cost evaluations
  (:func:`partition_segment`; the reference's tests hold it against a
  brute-force oracle).

Baselines built from the same machinery: :func:`layerwise_partition` (every
conv group its own launch — the unfused dataflow) and
:func:`paper_partition` (USEFUSE's hand-picked groups: first two convs for
LeNet/AlexNet, VGG blocks 1-2, ResNet-18 per-block conv pairs).
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass
from typing import NamedTuple

from repro_torch.core.dtypes import canonical_dtype
from repro_torch.core.fusion import FusionSpec
from repro_torch.core.program import VMEM_BUDGET_BYTES, LaunchPlan, plan_launch
from repro_torch.kernels.fused_conv.ops import conv_groups
from repro_torch.obs.trace import get_tracer
from repro_torch.robust.errors import BudgetError

from .graph import Graph, Segment, fusable_segments, infer_shapes

INFEASIBLE = (float("inf"), float("inf"))


@dataclass(frozen=True)
class PyramidPlan:
    """One chosen pyramid: the launch configuration plus the graph nodes it
    covers.  ``relu`` is the chain's uniform fused activation."""

    launch: LaunchPlan
    node_names: tuple[str, ...]
    relu: bool

    @property
    def spec(self) -> FusionSpec:
        return self.launch.spec

    @property
    def name(self) -> str:
        return self.node_names[0] if len(self.node_names) == 1 else (
            f"{self.node_names[0]}..{self.node_names[-1]}"
        )

    @property
    def q_convs(self) -> int:
        return self.spec.q_convs


@dataclass(frozen=True)
class PartitionPlan:
    """A full execution plan: pyramids keyed by their first covered node,
    everything else executed as plain ops by the runner.  Hashable, so the
    memoised :func:`auto_partition` can hand the same object back."""

    graph: Graph
    pyramids: tuple[PyramidPlan, ...]
    vmem_budget: int
    batch: int
    # the compute dtype every pyramid was planned (and will launch) at; the
    # runner casts params/activations to match (DESIGN.md §11)
    compute_dtype: str = "float32"

    def pyramid_at(self, node_name: str) -> PyramidPlan | None:
        for p in self.pyramids:
            if p.node_names[0] == node_name:
                return p
        return None

    def covered(self) -> frozenset[str]:
        return frozenset(n for p in self.pyramids for n in p.node_names)

    def hbm_bytes(self) -> int:
        """Modeled off-chip traffic of all pyramid launches.  Head ops and
        residual adds are identical across partitions, so they are excluded —
        this is the quantity the DP minimizes and the benchmarks compare."""
        return sum(p.launch.hbm_bytes(self.batch) for p in self.pyramids)

    def modeled_cycles(self) -> int:
        return sum(p.launch.modeled_cycles(self.batch) for p in self.pyramids)

    def modeled_us(self) -> float:
        """Whole-plan modeled latency at the cycle model's reference
        frequency — the serving engine's per-bucket SLO seed (DESIGN.md
        §14): launches run back to back, so the plan's modeled time is the
        sum of its launches'."""
        return sum(p.launch.modeled_us(self.batch) for p in self.pyramids)

    def n_launches(self) -> int:
        return len(self.pyramids)

    def summary(self) -> str:
        rows = [
            f"  {p.name:<24} Q={p.q_convs} region={p.launch.out_region}"
            f" {p.launch.regime}"
            f" hbm={p.launch.hbm_bytes(self.batch):,}B"
            for p in self.pyramids
        ]
        return (
            f"PartitionPlan[{self.graph.name}] batch={self.batch} "
            f"dtype={self.compute_dtype} "
            f"launches={self.n_launches()} hbm={self.hbm_bytes():,}B\n"
            + "\n".join(rows)
        )


# ---------------------------------------------------------------------------
# Segment-level dynamic program
# ---------------------------------------------------------------------------


def _group_specs(segment: Segment) -> tuple[list[list], list[int], list[int]]:
    """Conv groups of a segment plus the spatial size / channel count
    entering each group boundary (index g = before group g)."""
    spec = segment.spec()
    groups = conv_groups(spec)
    sizes = spec.feature_sizes()
    bound_sizes, bound_ch = [segment.input_size], [segment.in_channels]
    li = 0
    for g in groups:
        li += len(g)
        bound_sizes.append(sizes[li])
        bound_ch.append(g[0].n_out)
    return groups, bound_sizes, bound_ch


def _span_launch(
    groups: list[list], bound_sizes: list[int], i: int, j: int,
    vmem_budget: int, prefer_region: str = "largest",
    compute_dtype: str = "float32", batch: int = 1,
) -> LaunchPlan | None:
    """Launch plan (or None) for one pyramid covering groups [i, j),
    knob-costed at ``batch`` (the serving bucket's batch reaches all the way
    into the per-launch ladder, not just the DP's span comparison)."""
    levels = tuple(itertools.chain.from_iterable(groups[i:j]))
    spec = FusionSpec(levels=levels, input_size=bound_sizes[i])
    return plan_launch(
        spec, vmem_budget=vmem_budget, batch=batch,
        prefer_region=prefer_region, compute_dtype=compute_dtype,
    )


def partition_segment(
    segment: Segment,
    *,
    vmem_budget: int = VMEM_BUDGET_BYTES,
    batch: int = 1,
    max_convs: int | None = None,
    prefer_region: str = "largest",
    compute_dtype: str = "float32",
) -> list[LaunchPlan]:
    """Optimal cuts of one segment: DP over conv-group boundaries minimizing
    (sum HBM bytes, sum modeled cycles) lexicographically.

    The DP is dtype-aware end to end: each candidate span is costed (and its
    regime laddered) at ``compute_dtype``, so bf16's halved bytes can both
    move cut points and flip regimes relative to the f32 plan.

    ``max_convs`` caps pyramid depth (1 = the layer-by-layer baseline).
    Raises :class:`repro_torch.robust.errors.BudgetError` (a ``ValueError``) when
    some single conv group fits no launch regime even alone — no partition
    can execute that segment.
    """
    groups, bound_sizes, _ = _group_specs(segment)
    n = len(groups)
    launches: dict[tuple[int, int], LaunchPlan] = {}
    cost: dict[tuple[int, int], tuple[float, float]] = {}
    for i in range(n):
        for j in range(i + 1, n + 1):
            convs = sum(1 for g in groups[i:j] for l in g if l.kind == "conv")
            if max_convs is not None and convs > max_convs:
                cost[(i, j)] = INFEASIBLE
                continue
            lp = _span_launch(groups, bound_sizes, i, j, vmem_budget,
                              prefer_region, compute_dtype, batch)
            if lp is None:
                cost[(i, j)] = INFEASIBLE
                continue
            launches[(i, j)] = lp
            cost[(i, j)] = (
                float(lp.hbm_bytes(batch)), float(lp.modeled_cycles(batch))
            )

    best: list[tuple[float, float]] = [(0.0, 0.0)] + [INFEASIBLE] * n
    back: list[int] = [0] * (n + 1)
    for j in range(1, n + 1):
        for i in range(j):
            if best[i] == INFEASIBLE or cost[(i, j)] == INFEASIBLE:
                continue
            cand = (best[i][0] + cost[(i, j)][0], best[i][1] + cost[(i, j)][1])
            if cand < best[j]:
                best[j] = cand
                back[j] = i
    if best[n] == INFEASIBLE:
        bad = next(
            g for k, g in enumerate(groups) if cost[(k, k + 1)] == INFEASIBLE
        )
        raise BudgetError(
            f"conv group [{bad[0].name or bad[0]}] fits no launch regime under"
            f" the {vmem_budget}-byte VMEM budget; no partition can run it",
            node=bad[0].name, vmem_budget=vmem_budget,
        )
    cuts, j = [], n
    while j > 0:
        i = back[j]
        cuts.append(launches[(i, j)])
        j = i
    return list(reversed(cuts))


# ---------------------------------------------------------------------------
# Whole-graph partitions
# ---------------------------------------------------------------------------


def _segment_pyramids(
    segment: Segment, launches: list[LaunchPlan]
) -> list[PyramidPlan]:
    """Attach covered node names to each launch, walking the chain."""
    out, li = [], 0
    for lp in launches:
        n_levels = len(lp.spec.levels)
        names = tuple(n.name for n in segment.nodes[li : li + n_levels])
        out.append(PyramidPlan(launch=lp, node_names=names, relu=segment.relu))
        li += n_levels
    assert li == len(segment.nodes), "launches must tile the segment"
    return out


def replan_pyramid(
    graph: Graph,
    pyr: PyramidPlan,
    *,
    vmem_budget: int,
    batch: int = 1,
    compute_dtype: str = "float32",
) -> list[PyramidPlan]:
    """Re-cut one planned pyramid under a (smaller) VMEM budget.

    The degradation ladder's replan rung (DESIGN.md §13): when a launch's
    working set no longer fits at run time, its covered chain is rebuilt as
    a :class:`~repro_torch.net.graph.Segment` and re-run through the same DP —
    tighter cuts, a chain of smaller launches, each individually under the
    new budget.  Raises :class:`repro_torch.robust.errors.BudgetError` when even
    single conv groups cannot fit, i.e. this rung is exhausted.
    """
    shapes = infer_shapes(graph)
    src = graph.node(pyr.node_names[0]).inputs[0]
    seg = Segment(
        nodes=tuple(graph.node(m) for m in pyr.node_names),
        input_size=shapes[src].size,
        in_channels=shapes[src].channels,
        relu=pyr.relu,
    )
    launches = partition_segment(
        seg, vmem_budget=vmem_budget, batch=batch,
        compute_dtype=compute_dtype,
    )
    return _segment_pyramids(seg, launches)


@functools.lru_cache(maxsize=128)
def _auto_partition_cached(
    graph: Graph,
    vmem_budget: int,
    batch: int,
    max_convs: int | None,
    prefer_region: str,
    compute_dtype: str,
) -> PartitionPlan:
    pyramids: list[PyramidPlan] = []
    for seg in fusable_segments(graph):
        launches = partition_segment(
            seg, vmem_budget=vmem_budget, batch=batch, max_convs=max_convs,
            prefer_region=prefer_region, compute_dtype=compute_dtype,
        )
        pyramids.extend(_segment_pyramids(seg, launches))
    return PartitionPlan(
        graph=graph, pyramids=tuple(pyramids), vmem_budget=vmem_budget,
        batch=batch, compute_dtype=compute_dtype,
    )


def auto_partition(
    graph: Graph,
    *,
    vmem_budget: int = VMEM_BUDGET_BYTES,
    batch: int = 1,
    max_convs: int | None = None,
    prefer_region: str = "largest",
    compute_dtype: str | None = None,
) -> PartitionPlan:
    """Machine-chosen fusion boundaries for the whole network.
    ``prefer_region="smallest"`` trades grid overhead for maximal tile grids
    (finest END-skip granularity) — the paper's smallest-tile preference.
    ``compute_dtype`` overrides the graph's default value width
    (``None`` = ``graph.compute_dtype``); the f32 and bf16 plans for the
    same graph are distinct cache entries.

    Memoized on (graph structure, VMEM budget, batch, depth cap, region
    preference, compute dtype): the DP is pure over static shapes, and
    ``run_model`` / the benchmark loop re-request identical plans every call
    — they hit the cache and reuse the same :class:`PartitionPlan`
    object.  Inspect or reset via :func:`partition_cache_info` /
    :func:`clear_partition_cache`."""
    cdt = canonical_dtype(
        graph.compute_dtype if compute_dtype is None else compute_dtype
    )
    before = _auto_partition_cached.cache_info()
    plan = _auto_partition_cached(
        graph, vmem_budget, batch, max_convs, prefer_region, cdt
    )
    after = _auto_partition_cached.cache_info()
    hit = after.misses == before.misses
    # an lru miss always inserts; when the insert did not grow the cache,
    # an older plan was evicted (thrash under many serve-bucket keys)
    evicted = (not hit) and after.currsize == before.currsize
    _CACHE_COUNTERS["hits" if hit else "misses"] += 1
    if evicted:
        _CACHE_COUNTERS["evictions"] += 1
    tracer = get_tracer()
    if tracer.enabled:
        tracer.bump("partition_cache_hit" if hit else "partition_cache_miss")
        if evicted:
            tracer.bump("partition_cache_eviction")
        tracer.record_event(
            "auto_partition",
            model=graph.name,
            cache="hit" if hit else "miss",
            batch=batch,
            compute_dtype=cdt,
            vmem_budget=vmem_budget,
            launches=plan.n_launches(),
            hbm_bytes=plan.hbm_bytes(),
            modeled_cycles=plan.modeled_cycles(),
        )
    return plan


class PartitionCacheInfo(NamedTuple):
    """Hit/miss statistics of the memoized :func:`auto_partition`.

    ``hits``/``misses`` count :func:`auto_partition` *calls* (not raw
    ``lru_cache`` probes) and — unlike the ``functools`` counters this
    module previously exposed directly — are reset by
    :func:`clear_partition_cache`, so repeated benchmark runs that clear
    between configs report per-run statistics instead of a process-lifetime
    accumulation.  ``evictions`` counts plans the bounded lru dropped to
    admit a new key: the serving engine multiplies keys per (model, bucket,
    dtype), so a rising eviction count is the cache-thrash signal traces
    surface via the ``partition_cache_eviction`` counter."""

    hits: int
    misses: int
    evictions: int
    currsize: int
    maxsize: int | None


# auto_partition call counters; cleared alongside the plan cache so a
# cleared cache never reports stale hit/miss history (the trace events and
# partition_cache_info read the same numbers)
_CACHE_COUNTERS = {"hits": 0, "misses": 0, "evictions": 0}


def partition_cache_info() -> PartitionCacheInfo:
    """Cache statistics of the memoized :func:`auto_partition` — counters
    that reset with :func:`clear_partition_cache` (see
    :class:`PartitionCacheInfo`)."""
    lru = _auto_partition_cached.cache_info()
    return PartitionCacheInfo(
        hits=_CACHE_COUNTERS["hits"],
        misses=_CACHE_COUNTERS["misses"],
        evictions=_CACHE_COUNTERS["evictions"],
        currsize=lru.currsize,
        maxsize=lru.maxsize,
    )


def clear_partition_cache() -> None:
    """Drop all memoized partition plans (e.g. between benchmark configs)
    and reset the hit/miss/eviction counters with them."""
    _auto_partition_cached.cache_clear()
    for k in _CACHE_COUNTERS:
        _CACHE_COUNTERS[k] = 0
    tracer = get_tracer()
    if tracer.enabled:
        tracer.record_event("partition_cache_clear")


def min_vmem_budget(graph: Graph, *, compute_dtype: str | None = None) -> int:
    """Smallest VMEM budget under which every conv group of the graph still
    has some launch regime — the floor below which no partition exists
    (dtype-aware: a bf16 graph's floor is roughly half the f32 one).
    Partitioning under this budget forces minimal output regions (maximal
    tile grids), which is also how the example script provokes the END
    cascade at reduced scale."""
    from repro_torch.core.program import compile_program

    cdt = canonical_dtype(
        graph.compute_dtype if compute_dtype is None else compute_dtype
    )
    worst = 0
    for seg in fusable_segments(graph):
        groups, bound_sizes, _ = _group_specs(seg)
        for i in range(len(groups)):
            spec = FusionSpec(levels=tuple(groups[i]), input_size=bound_sizes[i])
            out_size = spec.feature_sizes()[-1]

            def _cheapest_regime(prog) -> int:
                # the floor now includes the channel-tiled streamed rung:
                # a finely sliced last level can undercut even the blocking
                # single-slot regime when one level's weights dominate
                tiled = min(
                    (
                        prog.vmem_stream_bytes(2, 1, ct)
                        for ct in prog.c_tile_options()
                    ),
                    default=prog.vmem_stream_bytes(),
                )
                return min(prog.vmem_bytes(), prog.vmem_stream_bytes(), tiled)

            cheapest = min(
                _cheapest_regime(compile_program(spec, r, compute_dtype=cdt))
                for r in range(1, out_size + 1)
                if out_size % r == 0
            )
            worst = max(worst, cheapest)
    return worst


def layerwise_partition(
    graph: Graph, *, vmem_budget: int = VMEM_BUDGET_BYTES, batch: int = 1,
    compute_dtype: str | None = None,
) -> PartitionPlan:
    """The unfused baseline: every conv group is its own launch, every
    intermediate map round-trips HBM."""
    return auto_partition(
        graph, vmem_budget=vmem_budget, batch=batch, max_convs=1,
        compute_dtype=compute_dtype,
    )


# USEFUSE's hand-picked fusion depth per leading segment: LeNet-5 / AlexNet
# fuse the first two convs (+pools); VGG-16 fuses blocks 1-2 (four convs).
_PAPER_HEAD_CONVS = {"lenet": 2, "alexnet": 2, "vgg16": 4}


def paper_partition(
    graph: Graph, *, vmem_budget: int = VMEM_BUDGET_BYTES, batch: int = 1,
    compute_dtype: str | None = None,
) -> PartitionPlan:
    """The paper's hand-picked fusion choices, expressed as a partition:
    the leading segment fuses the quoted conv count and leaves the rest
    layer-by-layer; ResNet-18 fuses each residual block's conv pair (§4.3),
    which is exactly per-segment maximal fusion — shortcuts and the stem stay
    single launches."""
    cdt = canonical_dtype(
        graph.compute_dtype if compute_dtype is None else compute_dtype
    )
    pyramids: list[PyramidPlan] = []
    head_convs = _PAPER_HEAD_CONVS.get(graph.name)
    for si, seg in enumerate(fusable_segments(graph)):
        groups, bound_sizes, _ = _group_specs(seg)
        if graph.name == "resnet18":
            spans = [(0, len(groups))]  # whole segment: block pair / stem
        elif si == 0 and head_convs is not None:
            convs = head = 0
            for gi, g in enumerate(groups):
                convs += sum(1 for l in g if l.kind == "conv")
                if convs == head_convs:
                    head = gi + 1
                    break
            spans = [(0, head)] + [(k, k + 1) for k in range(head, len(groups))]
        else:
            spans = [(k, k + 1) for k in range(len(groups))]
        launches = []
        for i, j in spans:
            lp = _span_launch(groups, bound_sizes, i, j, vmem_budget,
                              compute_dtype=cdt)
            if lp is None:
                raise BudgetError(
                    f"paper fusion group {i}:{j} of segment {si} does not fit"
                    f" the {vmem_budget}-byte VMEM budget",
                    vmem_budget=vmem_budget,
                )
            launches.append(lp)
        pyramids.extend(_segment_pyramids(seg, launches))
    return PartitionPlan(
        graph=graph, pyramids=tuple(pyramids), vmem_budget=vmem_budget,
        batch=batch, compute_dtype=cdt,
    )
