"""Operational-intensity model (paper Figs. 10-11, roofline x-axis).

The port of the reference package's ``repro.core.intensity``.  Off-chip
traffic accounting, at the paper's n=8-bit SOP precision (one byte per
value, :data:`PAPER_BYTES_PER_VAL`) unless a caller passes another width:

* ``unfused``  — layer-by-layer dataflow: every level reads its input map
  from off-chip and writes its output map back, plus weights once.
* ``fused_naive`` — fusion pyramid whose tile stride equals the convolution
  stride (Baselines 1-2): the first-level tile is re-read per movement with
  massive overlap: ``alpha_naive^2 * H1^2 * C_in`` input bytes.
* ``fused_uniform`` — the proposed uniform tile stride (and Baseline-3):
  ``alpha^2 * H1^2 * C_in`` input bytes — overlap bounded by the planner's
  maximal-stride selection.

Both fused variants write only the final output map off-chip and load weights
once (input/output channel tiling, §3.3.1).  These are the paper's model
bytes, not the H100's: the port's kernels are measured by ``chip_smoke.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .cycle_model import naive_alpha
from .dtypes import DTYPE_BYTES
from .fusion import FusionPlan, FusionSpec

# the paper's figures account one byte per value (n=8-bit SOP precision);
# pass bytes_per_val=DTYPE_BYTES[...] explicitly to account other dtypes
PAPER_BYTES_PER_VAL = DTYPE_BYTES["int8"]


def weight_bytes(
    spec: FusionSpec, bytes_per_val: int = PAPER_BYTES_PER_VAL
) -> int:
    return sum(
        lvl.K * lvl.K * lvl.n_in * lvl.n_out * bytes_per_val
        for lvl in spec.levels
        if lvl.kind == "conv"
    )


def unfused_bytes(
    spec: FusionSpec, bytes_per_val: int = PAPER_BYTES_PER_VAL
) -> int:
    sizes = spec.feature_sizes()
    total = 0
    for l, lvl in enumerate(spec.levels):
        total += sizes[l] ** 2 * lvl.n_in * bytes_per_val  # read input map
        total += sizes[l + 1] ** 2 * lvl.n_out * bytes_per_val  # write output
    return total + weight_bytes(spec, bytes_per_val)


def fused_bytes(
    spec: FusionSpec,
    plan: FusionPlan,
    *,
    uniform: bool = True,
    bytes_per_val: int = PAPER_BYTES_PER_VAL,
) -> int:
    sizes = spec.feature_sizes()
    h1 = plan.levels[0].tile
    alpha = plan.alpha if uniform else naive_alpha(plan)
    in_bytes = alpha * alpha * h1 * h1 * spec.levels[0].n_in * bytes_per_val
    out_bytes = sizes[-1] ** 2 * spec.levels[-1].n_out * bytes_per_val
    return in_bytes + out_bytes + weight_bytes(spec, bytes_per_val)


@dataclass(frozen=True)
class IntensityPoint:
    """One point of the performance-vs-OI plots (Figs. 10-11)."""

    design: str
    ops: int
    bytes_offchip: int
    duration_us: float

    @property
    def intensity(self) -> float:  # ops / byte
        return self.ops / self.bytes_offchip

    @property
    def gops(self) -> float:
        return self.ops / (self.duration_us * 1e3)


def intensity_improvement(spec: FusionSpec, plan: FusionPlan) -> float:
    """OI(proposed uniform-stride fusion) / OI(naive-stride fusion)."""
    return fused_bytes(spec, plan, uniform=False) / fused_bytes(spec, plan)


def launch_dataflow(program, batch: int = 1, *, streamed: bool = False) -> dict:
    """Per-launch HBM byte breakdown of one kernel launch, in the tile
    program's byte model.

    The bridge between the paper-level OI accounting above and the
    :class:`~repro_torch.core.program.TileProgram` model: the same halo-tile
    input term (``alpha^2 * tile0^2 * C``, Algorithm 4's uniform minimal
    movement) that :meth:`TileProgram.hbm_bytes` charges and the partitioner
    DP minimizes.  ``input_bytes_whole_image`` is the retired
    whole-image-resident dataflow (every grid cell re-read the padded image).
    Input, weight, and output bytes are charged at the program's
    ``compute_dtype`` width; skip flags stay int32 regardless.  The
    components sum to ``program.hbm_bytes(batch, streamed=streamed)``.
    """
    a2 = batch * program.alpha ** 2
    bpv = program.bytes_per_val
    return {
        "input_bytes_whole_image": program.input_hbm_bytes(
            batch, whole_image=True
        ),
        "input_bytes_halo": program.input_hbm_bytes(batch),
        "weight_bytes": bpv * (a2 if streamed else 1) * program.weight_floats(),
        "output_bytes": bpv * batch * program.out_size ** 2 * program.n_out,
        "skip_bytes": DTYPE_BYTES["int32"] * a2 * program.q_convs,
    }
