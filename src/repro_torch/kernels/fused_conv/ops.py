"""Public wrappers for the fused conv-pyramid kernel.

The port of the reference's ``repro.kernels.fused_conv.ops``.  All
window/offset math comes from the tile-program compiler
(:mod:`repro_torch.core.program`); this module only pads inputs, resolves
the launch knobs, checks the planning budget, and launches:

* :func:`fused_pyramid` — any Q >= 1 conv levels as **one** kernel launch;
* :func:`fused_conv2` — the historical 2-conv entry point (returns the old
  ``(B, alpha, alpha)`` skip map);
* :func:`fused_pyramid_chain` — chunks a chain into several launches only
  when the budget forces it (or an explicit per-chunk conv cap is given).

The budget is a :class:`~repro_torch.core.program.Budget`: the card's
(:data:`~repro_torch.core.program.CARD_BUDGET`) unless the caller passes
the reference's (:data:`~repro_torch.core.program.REFERENCE_BUDGET`),
under which every knob and every ``BudgetError`` matches the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.dtypes import canonical_dtype, torch_dtype
from repro_torch.core.fusion import FusionSpec
from repro_torch.core.program import (
    CARD_BUDGET,
    Budget,
    LaunchPlan,
    compile_program,
    plan_launch,
)
from repro_torch.robust.errors import BudgetError, PreflightError

from .fused_conv import fused_pyramid_kernel


def flatten_weights(weights: list, dtype="float32") -> torch.Tensor:
    """Concatenate per-level weight tensors into the flat compute-dtype HWIO
    array a streamed launch reads.  Plan-driven callers (the network
    runner) call this once per model instead of once per launch."""
    dt = torch_dtype(dtype)
    return torch.cat([w.to(dt).reshape(-1) for w in weights])


def fused_pyramid(
    x: torch.Tensor,
    weights: list | None,
    biases: list,
    *,
    spec: FusionSpec,
    out_region: int | None = None,
    streamed: bool | None = None,
    w_slots: int | None = None,
    x_slots: int | None = None,
    c_tiles: int | None = None,
    relu: bool = True,
    end_skip: bool = True,
    budget: Budget = CARD_BUDGET,
    weights_flat: torch.Tensor | None = None,
    compute_dtype: str = "float32",
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Q-conv pyramid forward as a single kernel launch.

    ``x``: (B, H, W, C) NHWC; ``weights[l]``: (K, K, Cin, Cout) and
    ``biases[l]``: (Cout,) per conv level, in chain order.  ``out_region``
    must tile the final output exactly; ``None`` picks the plan
    :func:`~repro_torch.core.program.plan_launch` picks.  ``streamed`` /
    ``w_slots`` / ``x_slots`` / ``c_tiles`` pin the launch knobs (the
    plan-driven entry used by :mod:`repro_torch.net.runner`); ``None``
    derives them from ``budget``: on the card one resident slot, untiled;
    under the reference's budget exactly as the reference does.  The
    launch must fit ``budget`` at the batch of ``x``.
    ``weights_flat`` optionally supplies the pre-flattened weights
    (:func:`flatten_weights`); streamed callers holding only the flat form
    may pass ``weights=None``.  ``compute_dtype`` is the value width of every
    tile and weight; activations and weights are cast on entry (the input
    before it is padded) and accumulation stays float32 in the kernel.

    Runs on the device of ``x``: the CUDA kernel on a CUDA tensor, its plain
    PyTorch version on a CPU tensor.  ``plain=True`` takes the plain
    version on any device; only the guarded runner's ``eager`` rung passes
    it.  Returns ``(out, skip)`` with ``skip``:
    (B, alpha, alpha, Q) int32 END-cascade flags (level 0 never skips).
    """
    compute_dtype = canonical_dtype(compute_dtype)
    cdt = torch_dtype(compute_dtype)
    batch = int(x.shape[0])
    if out_region is None:
        lp = plan_launch(
            spec, budget, batch=batch, compute_dtype=compute_dtype
        )
        if lp is None:
            raise BudgetError(
                f"no output region fits the {budget}; chunk via"
                " fused_pyramid_chain",
                **budget.context(),
            )
        out_region = lp.out_region
        if streamed is None:
            streamed = lp.streamed
            if w_slots is None:
                w_slots = lp.w_slots
                if c_tiles is None:
                    c_tiles = lp.c_tiles
        if x_slots is None:
            x_slots = lp.x_slots
    prog = compile_program(spec, out_region, compute_dtype=compute_dtype)
    stream, w_slots, x_slots, c_tiles = budget.launch_knobs(
        prog, streamed, w_slots, x_slots, c_tiles
    )
    launch = LaunchPlan(program=prog, streamed=stream, w_slots=w_slots,
                        x_slots=x_slots, c_tiles=c_tiles)
    if not budget.fits(launch, batch):
        need = budget.working_set(launch, batch)
        raise BudgetError(
            f"working set {need} at batch {batch} exceeds the {budget}"
            + budget.retry_hint(stream)
            + " chunk via fused_pyramid_chain",
            **budget.context(need),
        )
    xp = F.pad(
        x.to(cdt),
        (0, 0, prog.pad_lo, prog.pad_hi, prog.pad_lo, prog.pad_hi),
    ).contiguous()
    return fused_pyramid_kernel(
        xp,
        None if weights is None else [w.to(cdt) for w in weights],
        [b.to(cdt) for b in biases],
        program=prog,
        relu=relu,
        end_skip=end_skip,
        stream_weights=stream,
        w_slots=w_slots,
        x_slots=x_slots,
        c_tiles=c_tiles,
        weights_flat=weights_flat,
        plain=plain,
    )


def fused_conv2(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    spec: FusionSpec,
    out_region: int,
    relu: bool = True,
    end_skip: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused 2-conv pyramid forward — compatibility wrapper.

    Returns (output map, skip map) with ``skip``: (B, alpha, alpha) int32 —
    1 where the END cascade skipped the second conv.
    """
    out, skip = fused_pyramid(
        x, [w1, w2], [b1, b2], spec=spec, out_region=out_region, relu=relu,
        end_skip=end_skip,
    )
    return out, skip[..., 1]


def conv_groups(spec: FusionSpec) -> list[list]:
    """Split the level chain into [conv + trailing pools] groups — the
    indivisible units of chunking (a pool executes as its conv's epilogue)."""
    if not (spec.levels and spec.levels[0].kind == "conv"):
        raise PreflightError(
            "chain must start with a conv level",
            levels=[lvl.kind for lvl in spec.levels],
        )
    groups: list[list] = []
    for lvl in spec.levels:
        if lvl.kind == "conv":
            groups.append([lvl])
        else:
            groups[-1].append(lvl)
    return groups


def plan_chunks(
    spec: FusionSpec,
    *,
    budget: Budget = CARD_BUDGET,
    max_convs_per_chunk: int | None = None,
    compute_dtype: str = "float32",
    batch: int = 1,
) -> list[FusionSpec]:
    """Greedy chunking: grow each chunk conv-group by conv-group until the
    budget (or an explicit conv cap) forces a split.  A chain that fits
    returns a single chunk.  Raises :class:`BudgetError` when even a lone
    conv group cannot fit the budget (on the card only past the kernel's
    limits: a lone group needs no budget there).  ``batch`` is the batch
    the chunks will launch at, which the card's working set grows with."""
    groups = conv_groups(spec)
    chunks: list[FusionSpec] = []
    size = spec.input_size

    def fits(levels: list) -> bool:
        sub = FusionSpec(levels=tuple(levels), input_size=size)
        return (
            plan_launch(sub, budget, batch=batch,
                        compute_dtype=compute_dtype) is not None
        )

    cur: list = []
    for g in groups:
        if cur:
            convs = sum(l.kind == "conv" for l in cur)
            capped = max_convs_per_chunk is not None and convs >= max_convs_per_chunk
            if capped or not fits(cur + g):
                chunks.append(FusionSpec(levels=tuple(cur), input_size=size))
                size = chunks[-1].feature_sizes()[-1]
                cur = []
        if not cur and not fits(g):
            name = g[0].name or f"conv K={g[0].K} {g[0].n_in}->{g[0].n_out}"
            raise BudgetError(
                f"conv group [{name}] does not fit the {budget} even alone"
                + budget.refusal(batch)
                + "; chunking cannot help",
                node=g[0].name, **budget.context(),
            )
        cur = cur + g
    chunks.append(FusionSpec(levels=tuple(cur), input_size=size))
    return chunks


def fused_pyramid_chain(
    x: torch.Tensor,
    weights: list,
    biases: list,
    *,
    spec: FusionSpec,
    out_regions: list[int] | None = None,
    relu: bool = True,
    end_skip: bool = True,
    budget: Budget = CARD_BUDGET,
    max_convs_per_chunk: int | None = None,
    compute_dtype: str = "float32",
):
    """Execute a fusion chain in as few kernel launches as the budget
    allows; only chunk boundaries materialize a feature map.

    Returns ``(y, skips)`` — ``skips[c]`` is chunk ``c``'s (B, alpha, alpha,
    Q_c) END-cascade flag map.
    """
    chunks = plan_chunks(
        spec,
        budget=budget,
        max_convs_per_chunk=max_convs_per_chunk,
        compute_dtype=compute_dtype,
        batch=int(x.shape[0]),
    )
    if out_regions is not None and len(out_regions) != len(chunks):
        raise PreflightError(
            f"{len(out_regions)} out_regions for {len(chunks)} chunks",
            out_regions=list(out_regions), chunks=len(chunks),
        )
    y = x
    skips = []
    wi = 0
    for ci, sub in enumerate(chunks):
        q = sub.q_convs
        y, skip = fused_pyramid(
            y,
            list(weights[wi : wi + q]),
            list(biases[wi : wi + q]),
            spec=sub,
            out_region=out_regions[ci] if out_regions is not None else None,
            relu=relu,
            end_skip=end_skip,
            budget=budget,
            compute_dtype=compute_dtype,
        )
        skips.append(skip)
        wi += q
    return y, skips
