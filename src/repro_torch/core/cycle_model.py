"""USEFUSE cycle / performance models (paper §4.2, Eqs. (2)-(4)).

The port of the reference package's ``repro.core.cycle_model``, minus its
serving-stage models (ROADMAP queue 1 item 11).  The cycles model the
paper's 100 MHz digit-serial accelerator, not the H100.

* Eq. (3) DS-1 spatial and Eq. (4) DS-2 temporal per-movement cycles; the
  launch planner's :meth:`~repro_torch.core.program.LaunchPlan.modeled_cycles`
  composes the DS-1 cycles with the weight/input DMA overlap models below,
  and the partition DP breaks ties on the result, so every formula here
  must match the reference exactly for the port to pick the same plans.
* The conventional bit-serial baselines (spatial, Fig. 8; temporal,
  Fig. 9), under the reference's documented assumptions: an n-cycle
  serial-parallel multiplier, pipelined adder trees at one cycle per level,
  no cross-layer digit overlap (n paid per level); temporal WPUs re-use one
  multiplier per window, ``K*K * (n + acc)`` cycles.
* Eq. (2): :func:`evaluate_design` and :func:`single_layer_result`, the
  duration and performance rows of the paper's Tables 1-2.
* The launch-timeline twins (:func:`grid_pipeline_timeline`,
  :func:`channel_tiled_body_timeline`): the same schedules as bars, ending
  exactly at the cycle totals, for the Chrome-trace export
  (:mod:`repro_torch.obs.timeline`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .dtypes import mxu_throughput
from .fusion import FusionPlan, FusionSpec


def _log2c(x: int) -> int:
    return math.ceil(math.log2(x)) if x > 1 else 0


@dataclass(frozen=True)
class ArithParams:
    """Arithmetic/unit parameters (paper's symbols)."""

    n: int = 8  # input precision (bits)
    delta_olm: int = 2  # online multiplier delay
    delta_ola: int = 2  # online adder delay
    acc: int = 1  # accumulator cycles per add (DS-2, Eq. 4)
    mp_cycles: int = 2  # cycles per maxpool stage (MP term)
    freq_mhz: float = 100.0


DEFAULT_PARAMS = ArithParams()


def _levels_with_pools(spec: FusionSpec):
    """Group conv levels with their trailing pool (for the MP term)."""
    groups = []
    for lvl in spec.levels:
        if lvl.kind == "conv":
            groups.append([lvl, None])
        else:
            if groups and groups[-1][1] is None:
                groups[-1][1] = lvl
            else:  # leading pool (not in the paper's configs)
                groups.append([None, lvl])
    return groups


def ds1_cycles_per_movement(spec: FusionSpec, p: ArithParams = DEFAULT_PARAMS,
                            *, include_pool: bool = True) -> int:
    """Per-movement cycles of Eq. (3), without the alpha^2 factor.

    Per conv level q: delta_OLM + delta_OLA*ceil(log2 K_q^2)
    + delta_OLA*ceil(log2 N_q) + ceil(log2 K_q^2) + ceil(log2 N_q) + MP_q,
    then a single trailing ``n`` — the digit stream is pipelined across the
    whole fusion pyramid, so working precision is paid once.
    """
    total = 0
    for conv, pool in _levels_with_pools(spec):
        if conv is None:
            total += p.mp_cycles if include_pool else 0
            continue
        lk = _log2c(conv.K * conv.K)
        ln = _log2c(conv.n_in)
        total += p.delta_olm + p.delta_ola * lk + p.delta_ola * ln + lk + ln
        if pool is not None and include_pool:
            total += p.mp_cycles
    return total + p.n


def ds2_cycles_per_movement(spec: FusionSpec, p: ArithParams = DEFAULT_PARAMS,
                            *, include_pool: bool = True) -> int:
    """Per-movement cycles of Eq. (4) (temporal design, one OLM per window).

    Per conv level: (delta_OLM + (n-1) + Acc) * K^2  — the single online
    multiplier is drained K^2 times into the accumulation buffer — plus the
    channel adder tree terms and MP; single trailing ``n``.
    """
    total = 0
    for conv, pool in _levels_with_pools(spec):
        if conv is None:
            total += p.mp_cycles if include_pool else 0
            continue
        ln = _log2c(conv.n_in)
        total += (p.delta_olm + (p.n - 1) + p.acc) * conv.K * conv.K
        total += p.delta_ola * ln + ln
        if pool is not None and include_pool:
            total += p.mp_cycles
    return total + p.n


def ds1_split_cycles_per_movement(
    spec: FusionSpec, p: ArithParams = DEFAULT_PARAMS
) -> tuple[int, int]:
    """Eq. (3) per-movement cycles split at the last conv group:
    ``(mid, last)`` with ``mid`` the levels before the final conv (+ its
    trailing pool) and ``last`` the final conv group plus the single
    trailing ``n`` (working precision is paid once, at the pyramid's end, so
    it belongs to the last level's share).  ``mid + last`` equals
    :func:`ds1_cycles_per_movement`; ``mid == 0`` for Q=1 chains.

    This is the compute split the channel-tiled cost model needs: the mid
    share runs once per grid cell (``k == 0``), the last share is divided
    across the ``c_tiles`` output-channel steps."""
    groups = _levels_with_pools(spec)
    terms = []
    for conv, pool in groups:
        if conv is None:
            terms.append(p.mp_cycles)
            continue
        lk = _log2c(conv.K * conv.K)
        ln = _log2c(conv.n_in)
        t = p.delta_olm + p.delta_ola * lk + p.delta_ola * ln + lk + ln
        if pool is not None:
            t += p.mp_cycles
        terms.append(t)
    last_conv = max(
        (gi for gi, (conv, _) in enumerate(groups) if conv is not None),
        default=0,
    )
    mid = sum(terms[:last_conv])
    last = sum(terms[last_conv:]) + p.n
    return mid, last


def mxu_scaled_cycles(cycles: int, compute_dtype) -> int:
    """Compute cycles at ``compute_dtype``: an Eq. (3)/(4) cycle count —
    calibrated at the float32 rate — divided by the dtype's relative MXU
    throughput (:func:`repro_torch.core.dtypes.mxu_throughput`; bf16 operands
    double the systolic array's effective rate, int8 quadruples it), ceil'd
    so a movement never rounds to free.  The compute side of the dtype-aware
    overlap model: DMA terms scale with ``bytes_per_val``, compute divides
    by this factor."""
    return -(-cycles // mxu_throughput(compute_dtype))


def channel_tiled_body_cycles(
    compute_mid: int,
    compute_last: int,
    dma_mid: int,
    dma_slice: int,
    c_tiles: int,
    *,
    pipelined: bool,
) -> int:
    """Per-grid-cell cycles of the channel-tiled schedule (``c_tiles`` > 1).

    ``compute_mid`` / ``dma_mid`` are the once-per-cell (``k == 0``) mid
    pyramid's compute and blocking weight-DMA cycles; ``compute_last`` is
    the whole last level's compute, split evenly over the ``c_tiles`` steps;
    ``dma_slice`` is one ``(Cin, Cout / c_tiles)`` weight slice's DMA.

    Blocking (``w_slots=1``): every slice fetch is exposed —
    ``dma_mid + compute_mid + c_tiles * (dma_slice + ck)``.

    Pipelined (``w_slots=2``): slice 0's fetch starts at the top of the
    kernel body and fills behind the mid pyramid
    (``max(compute_mid, dma_slice)`` exposed), each later slice's fetch
    hides behind the previous slice's MXU pass (steady state
    ``max(ck, dma_slice)``), and the final slice's compute drains exposed:
    ``dma_mid + max(compute_mid, dma_slice) + ck
    + (c_tiles - 1) * max(ck, dma_slice)``.  The saving over blocking is
    ``min(compute_mid, dma_slice) + (c_tiles - 1) * min(ck, dma_slice)``
    >= 0 — never worse.
    """
    ck = -(-compute_last // c_tiles)
    if not pipelined:
        return dma_mid + compute_mid + c_tiles * (dma_slice + ck)
    return (
        dma_mid
        + max(compute_mid, dma_slice)
        + ck
        + (c_tiles - 1) * max(ck, dma_slice)
    )


def grid_pipeline_cycles(
    cells: int, body: int, input_dma: int, *, pipelined: bool
) -> int:
    """Latency of one batch element's ``alpha^2``-cell movement grid given
    per-cell compute(+weight-DMA) cycles ``body`` and per-cell input
    halo-tile DMA cycles ``input_dma``.

    Serial (``pipelined=False``): every cell blocks on its own input fetch —
    ``(input_dma + body) * cells``.

    Pipelined (``x_slots=2``, the revolving cross-cell landing buffer): cell
    ``n`` starts cell ``n+1``'s fetch before its own pyramid, so the timeline
    is warm-up fill, then ``cells - 1`` steady-state steps where the fetch
    hides behind compute, then the drain cell's exposed compute:
    ``input_dma + body + (cells - 1) * max(body, input_dma)``.  The saving
    over serial is exactly ``(cells - 1) * min(body, input_dma)`` >= 0, zero
    at ``cells == 1`` (a 1x1 grid has no successor to prefetch).
    """
    if not pipelined or cells <= 1:
        return cells * (body + input_dma)
    return input_dma + body + (cells - 1) * max(body, input_dma)


@dataclass(frozen=True)
class TimelineSegment:
    """One bar of a modeled launch timeline: ``lane`` is ``"mxu"`` (compute)
    or ``"dma"`` (HBM transfer), ``start``/``duration`` are cycles from
    launch start.  Segments are produced by the ``*_timeline`` twins of the
    cycle formulas above; the end of the last segment always equals the
    corresponding ``*_cycles`` total, so a rendered timeline can never
    disagree with the cost the planner optimized."""

    lane: str
    label: str
    start: int
    duration: int

    @property
    def end(self) -> int:
        return self.start + self.duration


def timeline_end(segments: list[TimelineSegment]) -> int:
    """Cycle at which the last segment of a timeline finishes."""
    return max((s.end for s in segments), default=0)


def channel_tiled_body_timeline(
    compute_mid: int,
    compute_last: int,
    dma_mid: int,
    dma_slice: int,
    c_tiles: int,
    *,
    pipelined: bool,
) -> list[TimelineSegment]:
    """The DMA-vs-MXU bars of one channel-tiled grid cell — the timeline twin
    of :func:`channel_tiled_body_cycles` (same arguments, and the timeline
    ends exactly at that cycle count).

    Blocking: every slice fetch is exposed before its MXU pass.  Pipelined:
    slice 0's fetch fills behind the mid pyramid, slice ``k+1``'s fetch hides
    behind slice ``k``'s pass, the last slice's compute drains exposed.
    """
    ck = -(-compute_last // c_tiles)
    segs: list[TimelineSegment] = []
    if dma_mid:
        segs.append(TimelineSegment("dma", "mid weights", 0, dma_mid))
    if not pipelined:
        t = dma_mid
        if compute_mid:
            segs.append(TimelineSegment("mxu", "mid pyramid", t, compute_mid))
            t += compute_mid
        for k in range(c_tiles):
            segs.append(TimelineSegment("dma", f"w slice {k}", t, dma_slice))
            segs.append(
                TimelineSegment("mxu", f"last conv k={k}", t + dma_slice, ck)
            )
            t += dma_slice + ck
        return segs
    if compute_mid:
        segs.append(TimelineSegment("mxu", "mid pyramid", dma_mid, compute_mid))
    segs.append(TimelineSegment("dma", "w slice 0 (fill)", dma_mid, dma_slice))
    s = dma_mid + max(compute_mid, dma_slice)
    for k in range(c_tiles):
        segs.append(TimelineSegment("mxu", f"last conv k={k}", s, ck))
        if k + 1 < c_tiles:
            segs.append(TimelineSegment("dma", f"w slice {k + 1}", s, dma_slice))
            s += max(ck, dma_slice)
    return segs


def grid_pipeline_timeline(
    cells: int,
    body: int,
    input_dma: int,
    *,
    pipelined: bool,
    max_cells: int = 64,
) -> list[TimelineSegment]:
    """The DMA-vs-MXU bars of one batch element's movement grid — the
    timeline twin of :func:`grid_pipeline_cycles` (same arguments; the
    timeline ends exactly at that cycle count).

    Serial: each cell's halo fetch is exposed before its pyramid.  Pipelined
    (the revolving ``x_slots=2`` landing buffer): cell 0's fetch is the
    warm-up fill, cell ``n`` starts cell ``n+1``'s fetch alongside its own
    pyramid, the last cell's compute drains exposed.  Grids beyond
    ``max_cells`` render the leading cells individually and fold the steady-
    state remainder into one labelled segment so a VGG-scale ``alpha^2``
    never explodes the trace — the elided segment keeps the end exact.
    """
    segs: list[TimelineSegment] = []
    shown = cells if cells <= max_cells else max(1, max_cells - 1)
    if not pipelined or cells <= 1:
        t = 0
        for n in range(shown):
            segs.append(TimelineSegment("dma", f"halo tile {n}", t, input_dma))
            segs.append(
                TimelineSegment("mxu", f"pyramid cell {n}", t + input_dma, body)
            )
            t += input_dma + body
        if shown < cells:
            rest = cells - shown
            segs.append(
                TimelineSegment(
                    "mxu",
                    f"cells {shown}..{cells - 1} x{rest} (elided)",
                    t,
                    rest * (input_dma + body),
                )
            )
        return segs
    step = max(body, input_dma)
    segs.append(TimelineSegment("dma", "halo tile 0 (fill)", 0, input_dma))
    s = input_dma
    for n in range(shown):
        segs.append(TimelineSegment("mxu", f"pyramid cell {n}", s, body))
        if n + 1 < cells:
            segs.append(TimelineSegment("dma", f"halo tile {n + 1}", s, input_dma))
        if n + 1 < shown:
            s += step
    if shown < cells:
        rest = cells - shown  # steady-state cells folded into one bar
        segs.append(
            TimelineSegment(
                "mxu",
                f"cells {shown}..{cells - 1} x{rest} (elided)",
                s + step,
                (rest - 1) * step + body,
            )
        )
    return segs


# Modeled host->device staging rate of the serving input stage, in bytes per
# cycle of the 100 MHz model (1.6 GB/s, a quarter of
# program.HBM_BYTES_PER_CYCLE).  Only the ratio to compute matters: it sets
# how large a bucket's host->device input copy is relative to the pyramid
# cycles the double-buffered stage hides it behind.  A model, not the H100's
# PCIe rate.
HOST_BYTES_PER_CYCLE = 16


def host_staging_cycles(nbytes: int) -> int:
    """Cycles one bucket's host->device input copy occupies the staging
    interface (:data:`HOST_BYTES_PER_CYCLE`) — the quantity the serving
    engine's double-buffered input stage overlaps with the previous
    bucket's compute."""
    return -(-nbytes // HOST_BYTES_PER_CYCLE)


def serve_stream_cycles(
    batches: int, compute: int, staging: int, *, double_buffered: bool
) -> int:
    """Latency of a stream of ``batches`` equal buckets through the serving
    engine given per-bucket ``compute`` cycles and host->device input
    ``staging`` cycles — the serving-level twin of
    :func:`grid_pipeline_cycles`.

    Serial (``double_buffered=False``): every bucket blocks on its own input
    copy — ``(staging + compute) * batches``.

    Double-buffered: bucket ``n+1``'s copy is issued (on a side stream)
    while bucket ``n`` computes, so after bucket 0's exposed fill the stream
    runs at the steady-state period ``max(compute, staging)``:
    ``staging + compute + (batches - 1) * max(compute, staging)``.  The
    saving over serial is ``(batches - 1) * min(compute, staging)`` >= 0.
    """
    if batches <= 0:
        return 0
    if not double_buffered or batches == 1:
        return batches * (staging + compute)
    return staging + compute + (batches - 1) * max(compute, staging)


def queue_delay_cycles(batches: int, compute: int, staging: int) -> int:
    """Modeled cycles a newly admitted request waits behind ``batches``
    already-queued bucket executions before its own bucket can start.

    Under the double-buffered steady state each queued bucket occupies the
    engine for ``max(compute, staging)`` cycles (the stream period of
    :func:`serve_stream_cycles`), so the wait is ``batches`` periods.  The
    serving engine's admission control compares this (plus the request's
    own bucket SLO) against the request's deadline: when the modeled wait
    already blows the deadline, admitting the request only wastes a launch
    on a result nobody can use — it is shed at the door instead.
    """
    if batches <= 0:
        return 0
    return batches * max(compute, staging)


# ---------------------------------------------------------------------------
# Baseline models (documented assumptions in module docstring)
# ---------------------------------------------------------------------------


def conv_baseline_spatial_cycles_per_movement(
    spec: FusionSpec, p: ArithParams = DEFAULT_PARAMS, *, include_pool: bool = True
) -> int:
    """Conventional bit-serial, spatial WPU (Fig. 8): n paid per level."""
    total = 0
    for conv, pool in _levels_with_pools(spec):
        if conv is None:
            total += p.mp_cycles if include_pool else 0
            continue
        lk = _log2c(conv.K * conv.K)
        ln = _log2c(conv.n_in)
        total += p.n + lk + ln
        if pool is not None and include_pool:
            total += p.mp_cycles
    return total


def conv_baseline_temporal_cycles_per_movement(
    spec: FusionSpec, p: ArithParams = DEFAULT_PARAMS, *, include_pool: bool = True
) -> int:
    """Conventional bit-serial, temporal WPU (Fig. 9)."""
    total = 0
    for conv, pool in _levels_with_pools(spec):
        if conv is None:
            total += p.mp_cycles if include_pool else 0
            continue
        ln = _log2c(conv.n_in)
        total += (p.n + p.acc) * conv.K * conv.K + ln
        if pool is not None and include_pool:
            total += p.mp_cycles
    return total


# ---------------------------------------------------------------------------
# End-to-end duration / performance (Eq. (2))
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DesignResult:
    name: str
    cycles: int
    duration_us: float
    ops: int
    gops: float
    alpha: int


_PER_MOVEMENT = {
    "ds1": ds1_cycles_per_movement,
    "ds2": ds2_cycles_per_movement,
    "baseline_spatial": conv_baseline_spatial_cycles_per_movement,
    "baseline_temporal": conv_baseline_temporal_cycles_per_movement,
}


def naive_alpha(plan: FusionPlan) -> int:
    """Movements when the tile stride equals the conv stride (Baselines 1-2).

    The fusion tile of the FIRST level advances by that level's conv stride,
    so the pyramid is evaluated once per first-level output position that the
    tile plan must cover; this is the paper's "tile stride matching the
    convolution stride" configuration (massively overlapping tiles).
    """
    first = plan.spec.levels[0]
    lvl = plan.levels[0]
    span = lvl.ifm - lvl.tile
    return math.ceil(span / first.S) + 1


def evaluate_design(
    design: str,
    spec: FusionSpec,
    plan: FusionPlan,
    ops: int,
    p: ArithParams = DEFAULT_PARAMS,
    *,
    uniform_stride: bool = True,
) -> DesignResult:
    """Duration & performance for a design over a fusion plan (Eq. (2))."""
    per_mv = _PER_MOVEMENT[design](spec, p)
    alpha = plan.alpha if uniform_stride else naive_alpha(plan)
    cycles = alpha * alpha * per_mv
    dur_us = cycles / p.freq_mhz
    return DesignResult(
        name=design,
        cycles=cycles,
        duration_us=dur_us,
        ops=ops,
        gops=ops / (dur_us * 1e3) if dur_us else float("inf"),
        alpha=alpha,
    )


def single_layer_result(
    design: str,
    spec: FusionSpec,
    plan: FusionPlan,
    conv_index: int,
    ops: int,
    p: ArithParams = DEFAULT_PARAMS,
) -> DesignResult:
    """Per-layer rows of Tables 1-2: one conv level evaluated standalone
    (no pooling epilogue — validated against the paper's CONV1 rows), still
    executed with the fusion plan's alpha movements.
    """
    convs = [l for l in spec.levels if l.kind == "conv"]
    conv = convs[conv_index]
    sub = FusionSpec(levels=(conv,), input_size=spec.input_size)
    per_mv = _PER_MOVEMENT[design](sub, p, include_pool=False)
    cycles = plan.alpha * plan.alpha * per_mv
    dur_us = cycles / p.freq_mhz
    return DesignResult(
        name=f"{design}/conv{conv_index + 1}",
        cycles=cycles,
        duration_us=dur_us,
        ops=ops,
        gops=ops / (dur_us * 1e3) if dur_us else float("inf"),
        alpha=plan.alpha,
    )
