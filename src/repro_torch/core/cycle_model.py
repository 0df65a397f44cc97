"""USEFUSE cycle model of one fused launch (paper §4.2, Eq. (3)).

The part of the reference package's ``repro.core.cycle_model`` that the
launch planner uses: :meth:`~repro_torch.core.program.LaunchPlan.modeled_cycles`
composes these per-movement DS-1 cycles with the weight/input DMA overlap
models, and the partition DP breaks ties on the result, so every formula
here must match the reference exactly for the port to pick the same plans.
The cycles model the paper's 100 MHz digit-serial accelerator, not the
H100.  The reference's DS-2, baseline and Eq. (2) design models, the
serving-stage models and the timeline twins are not ported yet (ROADMAP
queue 1 items 7, 9 and 11).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .dtypes import mxu_throughput
from .fusion import FusionSpec


def _log2c(x: int) -> int:
    return math.ceil(math.log2(x)) if x > 1 else 0


@dataclass(frozen=True)
class ArithParams:
    """Arithmetic/unit parameters (paper's symbols)."""

    n: int = 8  # input precision (bits)
    delta_olm: int = 2  # online multiplier delay
    delta_ola: int = 2  # online adder delay
    acc: int = 1  # accumulator cycles per add (DS-2, Eq. 4; kept for parity)
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
