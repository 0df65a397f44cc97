"""Tile-program compiler: one lowering pass shared by planner, executor, and
the hand-written fused-pyramid kernel.

A jax-free copy of ``repro.core.program`` (the reference package's
``core/__init__`` imports jax, so even its pure-Python modules cannot be
imported from here).  Every dataclass field, byte model and cycle model is
kept identical on purpose: the port runs exactly the reference's plans, so
the plan-parity tests compare the two field by field.  ``VMEM_BUDGET_BYTES``
is the *parity budget* (the TPU core's VMEM), not a Hopper constraint: the
CUDA kernel stages inter-level tiles in a global scratch and can run any
plan the reference can.

``FusionSpec`` + a chosen output region lower to a static *tile program*:

* **Eq. (1) windows** — the per-level receptive windows of an output tile,
  expressed affinely in the tile's final-output start coordinate
  (:class:`LevelWindow`: ``lo(start) = base + step * start``, constant
  ``size``).  This is the only place window/offset math is derived; the
  executor (:mod:`repro_torch.core.executor`) and the kernel wrapper
  (:mod:`repro_torch.kernels.fused_conv.ops`) both consume it.
* **Uniform-stride grid** — Algorithm 4 realized as an ``alpha x alpha``
  movement grid: every level moves the same number of times, the level-0 tile
  stride is ``stride0`` (:class:`TileProgram`).
* **Validity-mask ranges** — per conv level, the affine global output
  coordinate (``o_base + i * o_step``) and the valid extent used to zero
  rows that fall in a level's padding; ditto for the pool epilogue
  (:class:`ConvLevelProg`).
* **Pool epilogues** — each pool level is folded into the preceding conv
  level's program (the paper's Fig. 4 pooling block is slaved to the conv
  tile; see DESIGN.md §3).
* **VMEM-budget accounting** — :meth:`TileProgram.vmem_bytes` models the
  kernel's resident working set; :func:`pick_out_region` scans output regions
  against the budget and :meth:`TileProgram.hbm_bytes` models the per-launch
  off-chip traffic (the quantity fusion minimizes).

The compiler is pure Python over static shapes: programs are frozen,
hashable dataclasses (usable as cache keys).
"""

from __future__ import annotations

from dataclasses import dataclass

from .dtypes import DTYPE_BYTES, canonical_dtype
from .fusion import FusionSpec, receptive_window

VMEM_BUDGET_BYTES = 16 * 1024 * 1024  # v5e per-core VMEM

# Modeled HBM service rate of the cycle model's 100 MHz accelerator, in bytes
# per cycle (6.4 GB/s).  Only ratios matter: the constant sets how expensive a
# streamed-weight DMA is relative to the DS-1 compute cycles it overlaps with.
HBM_BYTES_PER_CYCLE = 64


# ---------------------------------------------------------------------------
# Eq. (1) windows, affine in the output start coordinate
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LevelWindow:
    """Eq. (1) window of one spec level, affine in the final-output start.

    A final-output interval ``[s, s + out_region)`` needs this level's padded
    input rows ``[base + step * s, base + step * s + size)``; ``step`` is the
    cumulative stride of this level and everything below it.
    """

    base: int
    step: int
    size: int

    def at(self, start: int) -> tuple[int, int]:
        return (self.base + self.step * start, self.size)


@dataclass(frozen=True)
class WindowProgram:
    """Per-level Eq. (1) windows plus output geometry.

    The contract consumed by the value-level executor: it needs windows for
    *arbitrary* (possibly ragged/clamped) output starts, so offsets stay
    affine in the start coordinate rather than in a grid index.
    """

    spec: FusionSpec
    out_region: int
    windows: tuple[LevelWindow, ...]
    out_size: int
    n_out: int

    def level_windows(self, start: int) -> list[tuple[int, int]]:
        """Per-level ``(lo, size)`` in padded input coords for one start."""
        return [w.at(start) for w in self.windows]


def chain_channels(spec: FusionSpec) -> int:
    """Channel count leaving the chain (pools are channel-preserving)."""
    c = spec.levels[0].n_in
    for lvl in spec.levels:
        if lvl.kind == "conv":
            c = lvl.n_out
    return c


def compile_windows(spec: FusionSpec, out_region: int) -> WindowProgram:
    """Lower the Eq. (1) receptive-window chain to affine per-level windows.

    ``receptive_window`` is exact but pointwise; every level's window start is
    affine in the output start (each level applies ``lo -> lo * S`` and a
    constant pad shift), so two evaluations recover ``(base, step)``.
    """
    wins0 = receptive_window(spec, 0, out_region)
    wins1 = receptive_window(spec, 1, out_region)
    windows = tuple(
        LevelWindow(base=w0[0], step=w1[0] - w0[0], size=w0[1])
        for w0, w1 in zip(wins0, wins1)
    )
    return WindowProgram(
        spec=spec,
        out_region=out_region,
        windows=windows,
        out_size=spec.feature_sizes()[-1],
        n_out=chain_channels(spec),
    )


# ---------------------------------------------------------------------------
# Kernel-level program: per-conv-level static offsets + the uniform grid
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvLevelProg:
    """Static per-conv-level kernel program (offsets affine in tile index).

    ``o_base + i * o_step`` is the global output coordinate of tile row 0 at
    grid index ``i``; rows outside ``[0, valid)`` are this level's padding and
    get masked to zero.  A trailing pool level is folded in as an epilogue
    with its own offset/valid triple.
    """

    K: int
    S: int
    n_in: int
    n_out: int
    in_size: int  # tile spatial size entering this level
    out_size: int  # tile spatial size leaving the conv
    o_base: int  # global output coord of tile row 0 at tile index 0
    o_step: int  # global output coord step per tile index
    valid: int  # level's valid output extent (mask range)
    pool: tuple[int, int] | None  # (K, S) of trailing pool, if any
    pool_out: int  # tile spatial size after pool (== out_size if no pool)
    pool_o_base: int = 0
    pool_o_step: int = 0
    pool_valid: int = 0


@dataclass(frozen=True)
class TileProgram:
    """Complete static program for one variadic fusion-pyramid launch.

    ``levels`` holds one :class:`ConvLevelProg` per conv level (any Q >= 1),
    pools folded in.  ``tile0``/``stride0`` cut level-0 tiles out of the
    pre-padded input; the grid is ``(batch, alpha, alpha)``.
    """

    spec: FusionSpec
    out_region: int
    alpha: int
    levels: tuple[ConvLevelProg, ...]
    tile0: int
    stride0: int
    pad_lo: int
    pad_hi: int
    out_size: int
    n_out: int
    # canonical dtype name of activations/weights moving through the launch
    # (a string keeps the program hashable); mid-level dot products
    # always accumulate float32 regardless — see DESIGN.md §11
    compute_dtype: str = "float32"

    @property
    def q_convs(self) -> int:
        return len(self.levels)

    @property
    def bytes_per_val(self) -> int:
        """Bytes per activation/weight value, from the one DTYPE_BYTES
        table — every byte quantity below scales with this."""
        return DTYPE_BYTES[self.compute_dtype]

    @property
    def padded_input(self) -> int:
        return self.pad_lo + self.spec.input_size + self.pad_hi

    def weight_floats(self) -> int:
        return sum(p.K * p.K * p.n_in * p.n_out + p.n_out for p in self.levels)

    def level_weight_counts(self) -> tuple[int, ...]:
        """Flattened float count of each level's weight tensor (bias excluded)
        — the slice table for streamed-weight launches."""
        return tuple(p.K * p.K * p.n_in * p.n_out for p in self.levels)

    def c_tile_options(self) -> tuple[int, ...]:
        """Legal output-channel tile counts of the last level, ascending and
        excluding the untiled 1: the divisors of the final conv's ``n_out``
        (a ``Cout`` block must tile the channel axis exactly so the per-``k``
        out BlockSpec stays uniform) that keep at least **two** channels per
        slice.  Single-channel slices are excluded on principle (they waste
        the 128-lane MXU) and on contract: XLA lowers the degenerate
        ``(P, Cin) @ (Cin, 1)`` dot through its matrix-vector special case,
        whose contraction order differs from the sliced-out column of the
        full dot — breaking the bitwise-parity guarantee every other slice
        width keeps."""
        m = self.levels[-1].n_out
        return tuple(c for c in range(2, m // 2 + 1) if m % c == 0)

    def _tile_floats(self, x_slots: int = 1, c_tiles: int = 1) -> int:
        """Per-grid-cell pyramid tile buffers: ``x_slots`` level-0 halo-tile
        landing buffers (DMA destinations; 2 = the revolving cross-cell
        prefetch pipeline), the live level-0 tile value, and every level's
        conv/pool output tile.  With ``c_tiles > 1`` the last level's
        conv/pool tiles hold one ``Cout / c_tiles`` channel block at a time
        (the per-``k`` working tile of the channel-tiled grid), and a Q > 1
        chain additionally carries the *persistent* mid-pyramid scratch the
        kernel re-reads at ``k > 0`` — live alongside the transient mid
        tiles at ``k == 0``, so it is counted on top of them."""
        c0 = self.levels[0].n_in
        floats = (1 + x_slots) * self.tile0 ** 2 * c0
        for li, p in enumerate(self.levels):
            n_out = p.n_out
            if li == len(self.levels) - 1:
                n_out = -(-n_out // c_tiles)
            floats += p.out_size ** 2 * n_out
            if p.pool is not None:
                floats += p.pool_out ** 2 * n_out
        if c_tiles > 1 and len(self.levels) > 1:
            last = self.levels[-1]
            floats += last.in_size ** 2 * last.n_in  # mid_scratch carry
        return floats

    def vmem_bytes(self, x_slots: int = 1, c_tiles: int = 1) -> int:
        """Resident working set of one kernel instance, in bytes.

        The input stays in HBM; only the level-0 halo tile (``tile0 x tile0``,
        DMA'd per grid cell into one of ``x_slots`` landing slots) is
        VMEM-resident, plus all weights ("filters are loaded into the kernel
        buffers only once", §3.3.1) and the per-level tile buffers of the
        pyramid.  ``c_tiles`` only shrinks the last level's working tile —
        resident weights stay whole, so channel tiling is a streamed-regime
        tool (the planner never picks it resident); the resident kernel still
        accepts it for parity testing.  Every buffer holds ``compute_dtype``
        values (the per-level f32 dot accumulator is compiler-managed vector
        state, not declared scratch), so the whole set scales with
        ``bytes_per_val`` — halving it is what flips streamed plans back to
        resident under bf16.
        """
        return self.bytes_per_val * (
            self._tile_floats(x_slots, c_tiles) + self.weight_floats()
        )

    def vmem_stream_bytes(
        self, slots: int = 1, x_slots: int = 1, c_tiles: int = 1
    ) -> int:
        """Working set with per-level weight streaming: only ``slots`` copies
        of the largest single level's weights are VMEM-resident at once
        (DMA'd from HBM level by level; ``slots=2`` is the double-buffered
        pipeline that overlaps level ``l+1``'s fetch with level ``l``'s
        compute); biases stay resident.  The fallback when
        :meth:`vmem_bytes` busts the budget — e.g. ResNet-18's last block,
        whose two 512x512 3x3 weight tensors alone exceed 16 MiB.
        ``x_slots`` counts input landing buffers as in :meth:`vmem_bytes`.

        With ``c_tiles > 1`` (the channel-tiled grid) the last level streams
        per-``k`` ``(Cin, Cout / c_tiles)`` slices through ``slots`` scratch
        slots while the mid levels fall back to one blocking slot sized for
        the largest mid level — streamed slices shrink by ``c_tiles``, which
        is what lets ResNet-18 b7 afford the double-buffered ``slots=2``
        regime its untiled weights bust."""
        cnts = self.level_weight_counts()
        floats = self._tile_floats(x_slots, c_tiles)
        if c_tiles > 1:
            if len(cnts) > 1:
                floats += max(cnts[:-1])  # one blocking mid-level slot
            floats += slots * -(-cnts[-1] // c_tiles)  # per-k slice slots
        else:
            floats += slots * max(cnts)
        floats += sum(p.n_out for p in self.levels)  # biases
        return self.bytes_per_val * floats

    def resolve_stream_regime(
        self,
        vmem_budget: int,
        x_slots: int = 1,
        w_slots: int | None = None,
        c_tiles: int | None = None,
    ) -> tuple[int, int]:
        """Resolve ``(w_slots, c_tiles)`` for a streamed launch along
        :func:`plan_launch`'s rung order — double-buffered untiled >
        channel-tiled double-buffered (smallest feasible ``c_tiles``) >
        blocking single slot — honouring whichever knobs the caller already
        pinned.  The kernel-entry fallback used by
        :func:`repro_torch.kernels.fused_conv.ops.fused_pyramid`, so the single
        rung order lives here and in :func:`plan_launch` only.  Never
        raises: a jointly-infeasible pin surfaces at the caller's VMEM
        assert."""
        if w_slots is None and c_tiles is None:
            if self.vmem_stream_bytes(2, x_slots) <= vmem_budget:
                return 2, 1
            for ct in self.c_tile_options():
                if self.vmem_stream_bytes(2, x_slots, ct) <= vmem_budget:
                    return 2, ct
            return 1, 1
        if w_slots is None:
            fits2 = self.vmem_stream_bytes(2, x_slots, c_tiles) <= vmem_budget
            return (2 if fits2 else 1), c_tiles
        if c_tiles is None:
            if (
                w_slots > 1
                and self.vmem_stream_bytes(w_slots, x_slots) > vmem_budget
            ):
                for ct in self.c_tile_options():
                    if (
                        self.vmem_stream_bytes(w_slots, x_slots, ct)
                        <= vmem_budget
                    ):
                        return w_slots, ct
            return w_slots, 1
        return w_slots, c_tiles

    def input_dma_cycles(self) -> int:
        """Cycles one grid cell's halo-tile DMA occupies the HBM interface
        (``tile0^2 * C`` floats at :data:`HBM_BYTES_PER_CYCLE`) — the
        quantity the cross-cell prefetch pipeline hides behind compute."""
        c0 = self.levels[0].n_in
        return -(
            -self.bytes_per_val * self.tile0 ** 2 * c0 // HBM_BYTES_PER_CYCLE
        )

    def input_hbm_bytes(self, batch: int = 1, *, whole_image: bool = False) -> int:
        """Per-launch input read traffic.  The halo-tile dataflow fetches one
        ``tile0 x tile0`` tile per grid cell — ``alpha^2 * tile0^2 * C`` total,
        overlap bounded by the pyramid halo (the uniform-stride minimum of
        Algorithm 4).  ``whole_image=True`` is the retired whole-image-resident
        model (every grid cell re-reads the padded image: ``alpha^2 * Hp * Wp *
        C``), kept for before/after benchmark comparisons."""
        c0 = self.levels[0].n_in
        tile = self.padded_input ** 2 if whole_image else self.tile0 ** 2
        return self.bytes_per_val * batch * self.alpha ** 2 * tile * c0

    def hbm_bytes(
        self, batch: int = 1, *, streamed: bool = False, c_tiles: int = 1
    ) -> int:
        """Off-chip traffic of one launch: read halo tiles + weights, write
        output map + skip flags.  Chained launches pay this per chunk — the
        intermediate maps crossing HBM are exactly what fusion removes.
        Streamed-weight launches re-read the weights once per grid cell.

        ``c_tiles`` is accepted for symmetry with the VMEM models but leaves
        the total unchanged: the channel-tiled grid reads ``1 / c_tiles`` of
        the last level's weights per ``k`` step across ``c_tiles`` steps
        (same per-cell total), writes each output channel block exactly once,
        and emits one flag vector per cell — channel tiling re-schedules the
        movement, it does not add traffic."""
        del c_tiles  # traffic-invariant; see docstring
        w_reads = batch * self.alpha ** 2 if streamed else 1
        vals = w_reads * self.weight_floats() + batch * self.out_size ** 2 * self.n_out
        # skip flags stay int32 whatever the compute dtype
        flag_bytes = (
            DTYPE_BYTES["int32"] * batch * self.alpha ** 2 * self.q_convs
        )
        return (
            self.input_hbm_bytes(batch)
            + self.bytes_per_val * vals
            + flag_bytes
        )


def compile_program(
    spec: FusionSpec, out_region: int, *, compute_dtype="float32"
) -> TileProgram:
    """Lower a fusion spec + output region to the kernel's static program.

    Requires the final output to be exactly tiled by ``out_region`` (the
    uniform-stride grid — every level moves ``alpha`` times per dim).  Every
    pool level must directly follow a conv level: pools execute as epilogues
    of the preceding conv tile (Fig. 4), so a leading or doubled pool has no
    conv program to fold into.  ``compute_dtype`` (name string or torch dtype)
    sets the byte width of every activation/weight the program accounts —
    window math is dtype-invariant, the byte and cycle models are not.
    """
    from repro_torch.robust.errors import PlanError

    levels = spec.levels
    if not (levels and levels[0].kind == "conv"):
        raise PlanError(
            "chain must start with a conv level",
            levels=[lvl.kind for lvl in levels],
        )
    for l, lvl in enumerate(levels):
        if lvl.kind == "pool" and levels[l - 1].kind != "conv":
            raise PlanError(
                "each pool level must directly follow a conv level",
                level=l, node=lvl.name,
            )
    sizes = spec.feature_sizes()
    out_size = sizes[-1]
    if out_size % out_region != 0:
        raise PlanError(
            f"out_region {out_region} must tile the {out_size} output"
            " exactly",
            out_region=out_region, out_size=out_size,
        )
    alpha = out_size // out_region

    win = compile_windows(spec, out_region).windows
    progs = []
    for l, lvl in enumerate(levels):
        if lvl.kind != "conv":
            continue
        in_size = win[l].size
        out_sz = (in_size - lvl.K) // lvl.S + 1
        pool = None
        pool_out = out_sz
        pool_ob = pool_os = pool_valid = 0
        if l + 1 < len(levels) and levels[l + 1].kind == "pool":
            pk, ps = levels[l + 1].K, levels[l + 1].S
            pool = (pk, ps)
            pool_out = (out_sz - pk) // ps + 1
            pool_ob = win[l + 1].base // ps
            pool_os = (win[l + 1].step * out_region) // ps
            pool_valid = sizes[l + 2]
        progs.append(
            ConvLevelProg(
                K=lvl.K,
                S=lvl.S,
                n_in=lvl.n_in,
                n_out=lvl.n_out,
                in_size=in_size,
                out_size=out_sz,
                o_base=win[l].base // lvl.S,
                o_step=(win[l].step * out_region) // lvl.S,
                valid=sizes[l + 1],
                pool=pool,
                pool_out=pool_out,
                pool_o_base=pool_ob,
                pool_o_step=pool_os,
                pool_valid=pool_valid,
            )
        )
    for prev, cur in zip(progs, progs[1:]):
        assert prev.pool_out == cur.in_size, "window chain is inconsistent"

    tile0 = win[0].size
    lo0 = win[0].base - levels[0].pad  # unpadded coords; <= 0 by construction
    assert lo0 <= 0, "level-0 window cannot start inside the image"
    stride0 = win[0].step * out_region
    pad_lo = -lo0
    last_end = lo0 + (alpha - 1) * stride0 + tile0
    pad_hi = max(0, last_end - spec.input_size)
    return TileProgram(
        spec=spec,
        out_region=out_region,
        alpha=alpha,
        levels=tuple(progs),
        tile0=tile0,
        stride0=stride0,
        pad_lo=pad_lo,
        pad_hi=pad_hi,
        out_size=out_size,
        n_out=chain_channels(spec),
        compute_dtype=canonical_dtype(compute_dtype),
    )


@dataclass(frozen=True)
class LaunchPlan:
    """A costed, VMEM-feasible single-launch configuration of one pyramid.

    The plan-costing hook consumed by the auto-partitioner
    (:mod:`repro_torch.net.partition`) and the kernel wrapper
    (:mod:`repro_torch.kernels.fused_conv.ops`): region choice *and* weight regime
    (resident vs streamed, and with how many stream slots) are decided here,
    once, so planner cost and launched kernel can never disagree.

    ``w_slots`` only matters when ``streamed``: 2 is the double-buffered
    weight pipeline (level ``l+1``'s DMA overlaps level ``l``'s compute), 1
    the blocking start();wait() fallback when two copies of the largest
    level's weights bust VMEM.

    ``x_slots`` is the input landing-buffer count: 2 is the revolving
    cross-cell prefetch pipeline (grid cell ``n`` starts cell ``n+1``'s
    halo-tile DMA before running its own pyramid, so after the per-image
    warm-up fill the input DMA hides behind the MXU cascade), 1 the serial
    start();wait() path.  The chain is confined to one batch element — the
    batch grid axis is declared ``parallel`` and may be partitioned across
    TensorCores, so a prefetch must never cross a batch boundary.

    ``c_tiles > 1`` is the channel-tiled grid: a fourth sequential grid axis
    ``k`` over ``Cout / c_tiles`` output-channel tiles of the *last* level
    (the column-parallel axis of the paper's Fig. 5 WPU array).  Levels
    ``0..Q-2`` are computed once per cell at ``k == 0`` into a persistent
    VMEM scratch and reused for ``k > 0``; level ``Q-1`` runs per ``k`` on a
    ``(Cin, Cout / c_tiles)`` streamed weight slice, so with ``w_slots=2``
    the next slice's DMA overlaps the current slice's MXU pass — the regime
    that restores pipelining to ``alpha == 1`` launches the cross-cell input
    prefetch cannot touch (no successor cell).
    """

    program: TileProgram
    streamed: bool
    w_slots: int = 1
    x_slots: int = 2
    c_tiles: int = 1

    @property
    def spec(self) -> FusionSpec:
        return self.program.spec

    @property
    def out_region(self) -> int:
        return self.program.out_region

    @property
    def regime(self) -> str:
        """Display label: ``resident``, ``streamed_w<slots>``, with a
        ``_c<tiles>`` suffix on channel-tiled launches."""
        if not self.streamed:
            return "resident"
        label = f"streamed_w{self.w_slots}"
        if self.c_tiles > 1:
            label += f"_c{self.c_tiles}"
        return label

    def vmem_bytes(self) -> int:
        if self.streamed:
            return self.program.vmem_stream_bytes(
                self.w_slots, self.x_slots, self.c_tiles
            )
        return self.program.vmem_bytes(self.x_slots, self.c_tiles)

    def hbm_bytes(self, batch: int = 1) -> int:
        return self.program.hbm_bytes(
            batch, streamed=self.streamed, c_tiles=self.c_tiles
        )

    def slice_bytes(self) -> int:
        """Bytes of one per-``k`` streamed weight slice of the last level —
        the DMA granule the channel-tiled pipeline hides behind the MXU
        (0 for resident launches, the whole last level at ``c_tiles == 1``)."""
        if not self.streamed:
            return 0
        cnt = self.program.level_weight_counts()[-1]
        return self.program.bytes_per_val * -(-cnt // self.c_tiles)

    def body_cycles(self) -> int:
        """Per-grid-cell compute(+weight-DMA) cycles — the ``body`` argument
        of :func:`~repro_torch.core.cycle_model.grid_pipeline_cycles`, shared by
        :meth:`modeled_cycles` and :meth:`modeled_timeline` so cost and
        rendering can never disagree.

        Per movement: DS-1 compute cycles (Eq. 3), plus the streamed-weight
        DMA cost at :data:`HBM_BYTES_PER_CYCLE`.  With a double-buffered
        weight pipeline (``w_slots=2``) only level 0's DMA (the pipeline
        ``fill``) is exposed and the rest hides behind compute —
        ``fill + max(compute, dma - fill)``, never worse than the
        single-slot fallback's serialized ``compute + dma``.  Resident
        weights pay no per-movement DMA.

        With the channel-tiled grid (``c_tiles > 1``, streamed) the body is
        :func:`~repro_torch.core.cycle_model.channel_tiled_body_cycles`: blocking
        mid-level weight DMA + mid compute, then the k-axis pipeline — slice
        0's fetch overlaps the mid pyramid (fill), each later slice's fetch
        overlaps the previous slice's MXU pass (steady), the last slice's
        compute drains exposed.

        Both sides of the overlap are dtype-aware: every weight-DMA term
        scales with the program's ``bytes_per_val``, and the MXU compute
        cycles divide by :func:`~repro_torch.core.dtypes.mxu_throughput` (bf16
        operands double the systolic rate) — so narrowing the dtype shrinks
        the DMA *and* the compute it hides behind."""
        from .cycle_model import channel_tiled_body_cycles

        compute, stream = self._body_terms()
        if stream is None:
            return compute
        kind = stream["kind"]
        if kind == "channel_tiled":
            return channel_tiled_body_cycles(
                stream["compute_mid"],
                stream["compute_last"],
                stream["dma_mid"],
                stream["dma_slice"],
                self.c_tiles,
                pipelined=self.w_slots > 1,
            )
        if kind == "pipelined":
            fill, dma = stream["fill"], stream["dma"]
            return fill + max(compute, dma - fill)
        return compute + stream["dma"]

    def _body_terms(self) -> tuple[int, dict | None]:
        """The raw compute/DMA cycle terms of one grid cell: ``(compute,
        stream)`` with ``stream`` None for resident launches, else a dict
        naming the weight-DMA regime and its terms — consumed by both
        :meth:`body_cycles` and :meth:`body_detail_timeline`."""
        from .cycle_model import (
            ds1_cycles_per_movement,
            ds1_split_cycles_per_movement,
            mxu_scaled_cycles,
        )

        bpv = self.program.bytes_per_val
        cdt = self.program.compute_dtype
        compute = mxu_scaled_cycles(ds1_cycles_per_movement(self.spec), cdt)
        if not self.streamed:
            return compute, None
        cnts = self.program.level_weight_counts()
        if self.c_tiles > 1:
            compute_mid, compute_last = ds1_split_cycles_per_movement(self.spec)
            return compute, {
                "kind": "channel_tiled",
                "compute_mid": mxu_scaled_cycles(compute_mid, cdt),
                "compute_last": mxu_scaled_cycles(compute_last, cdt),
                "dma_mid": -(-bpv * sum(cnts[:-1]) // HBM_BYTES_PER_CYCLE),
                "dma_slice": -(
                    -bpv * -(-cnts[-1] // self.c_tiles) // HBM_BYTES_PER_CYCLE
                ),
            }
        dma = -(-bpv * sum(cnts) // HBM_BYTES_PER_CYCLE)
        if self.w_slots > 1:
            fill = -(-bpv * cnts[0] // HBM_BYTES_PER_CYCLE)
            return compute, {"kind": "pipelined", "dma": dma, "fill": fill}
        return compute, {"kind": "blocking", "dma": dma}

    def body_detail_timeline(self):
        """DMA-vs-MXU bars *inside* one grid cell — weight movement against
        the conv cascade (:class:`~repro_torch.core.cycle_model.TimelineSegment`
        list ending exactly at :meth:`body_cycles`): a single compute bar for
        resident launches, exposed-then-compute for blocking streams, the
        fill-overlap shape for the double-buffered weight pipeline, and the
        k-axis fill/steady/drain for channel-tiled launches."""
        from .cycle_model import TimelineSegment, channel_tiled_body_timeline

        compute, stream = self._body_terms()
        if stream is None:
            return [TimelineSegment("mxu", "pyramid (resident)", 0, compute)]
        kind = stream["kind"]
        if kind == "channel_tiled":
            return channel_tiled_body_timeline(
                stream["compute_mid"],
                stream["compute_last"],
                stream["dma_mid"],
                stream["dma_slice"],
                self.c_tiles,
                pipelined=self.w_slots > 1,
            )
        dma = stream["dma"]
        segs = [TimelineSegment("dma", "weights", 0, dma)]
        if kind == "pipelined":
            # compute starts once level 0's weights (the fill) have landed;
            # later levels' DMA hides behind the cascade
            segs.append(
                TimelineSegment("mxu", "pyramid", stream["fill"], compute)
            )
        else:
            segs.append(TimelineSegment("mxu", "pyramid", dma, compute))
        return segs

    def modeled_timeline(self, *, max_cells: int = 64):
        """The launch's modeled DMA-vs-MXU timeline for one batch element
        (:class:`~repro_torch.core.cycle_model.TimelineSegment` list): the
        uniform-stride grid's input halo-tile stream against the per-cell
        pyramid bodies, serial or software-pipelined per ``x_slots``, ending
        exactly at ``modeled_cycles(batch=1)``.  The Chrome-trace exporter
        (:mod:`repro_torch.obs.timeline`) renders this next to measured
        spans."""
        from .cycle_model import grid_pipeline_timeline

        return grid_pipeline_timeline(
            self.program.alpha ** 2,
            self.body_cycles(),
            self.program.input_dma_cycles(),
            pipelined=self.x_slots > 1,
            max_cells=max_cells,
        )

    def describe(
        self, batch: int = 1, vmem_budget: int | None = None
    ) -> dict:
        """The launch as one observability row: every plan knob plus the
        modeled byte/cycle quantities the planner optimized, in one flat
        JSON-safe dict (the span schema of DESIGN.md §12 and the row format
        of :mod:`repro_torch.obs.explain`).  ``vmem_budget`` adds the
        headroom column (budget minus modeled working set)."""
        prog = self.program
        row = {
            "q_convs": prog.q_convs,
            "out_region": self.out_region,
            "alpha": prog.alpha,
            "regime": self.regime,
            "streamed": self.streamed,
            "x_slots": self.x_slots,
            "w_slots": self.w_slots,
            "c_tiles": self.c_tiles,
            "compute_dtype": prog.compute_dtype,
            "batch": batch,
            "hbm_bytes": self.hbm_bytes(batch),
            "vmem_bytes": self.vmem_bytes(),
            "slice_bytes": self.slice_bytes(),
            "modeled_cycles": self.modeled_cycles(batch),
            "body_cycles": self.body_cycles(),
            "input_dma_cycles": prog.input_dma_cycles(),
        }
        if vmem_budget is not None:
            row["vmem_headroom_bytes"] = vmem_budget - row["vmem_bytes"]
        return row

    def modeled_cycles(self, batch: int = 1) -> int:
        """Pipeline-aware cycle cost of the whole launch — the latency
        tiebreaker of the partitioner's dynamic program.

        The per-cell :meth:`body_cycles` is composed per batch element by
        :func:`~repro_torch.core.cycle_model.grid_pipeline_cycles`: serial
        (``x_slots=1``) pays ``(input_dma + body) * cells``; the revolving
        cross-cell prefetch (``x_slots=2``) pays
        ``warmup_fill + body + (cells - 1) * max(body, input_dma)`` — never
        worse than serial, equal at ``alpha == 1`` (no successor cell).

        ``batch`` multiplies the per-image grid (the batch grid axis is
        ``parallel`` across cores but sequential within one, and the
        prefetch chain resets at batch boundaries, so each element pays its
        own warm-up fill).  The byte models scale differently in batch —
        resident weights are read once per launch, streamed weights once per
        cell per element — which is why the partitioner's cut points shift
        with the serving bucket (see :func:`plan_launch` and DESIGN.md §14).
        """
        from .cycle_model import grid_pipeline_cycles

        per_image = grid_pipeline_cycles(
            self.program.alpha ** 2,
            self.body_cycles(),
            self.program.input_dma_cycles(),
            pipelined=self.x_slots > 1,
        )
        return batch * per_image

    def modeled_us(self, batch: int = 1) -> float:
        """:meth:`modeled_cycles` at the cycle model's reference frequency —
        the per-launch share of a serving bucket's latency SLO estimate."""
        from .cycle_model import DEFAULT_PARAMS

        return self.modeled_cycles(batch) / DEFAULT_PARAMS.freq_mhz


def plan_launch(
    spec: FusionSpec,
    vmem_budget: int = VMEM_BUDGET_BYTES,
    *,
    batch: int = 1,
    allow_stream: bool = True,
    prefer_region: str = "largest",
    compute_dtype="float32",
) -> LaunchPlan | None:
    """Pick the launch configuration for one pyramid: an exactly-tiling
    output region whose program fits the VMEM budget, preferring
    fully-resident weights over per-level streaming (which re-reads weights
    once per grid cell), and double-buffered streaming (DMA overlapped with
    compute) over the blocking single-slot fallback.  Between those two
    streamed rungs sits the **channel-tiled** regime: when two whole copies
    of the largest level's weights bust VMEM, tiling the last level's Cout
    across a fourth sequential grid axis shrinks the streamed slice by
    ``c_tiles`` so the double-buffered pipeline fits after all — the ladder
    is resident > streamed x2 > channel-tiled streamed x2 > streamed x1,
    with the smallest (coarsest-slice) feasible ``c_tiles`` preferred.
    Within each weight regime the two-slot input landing buffer (cross-cell
    halo prefetch, ``x_slots=2``) is preferred over the serial single slot;
    a 1x1 grid has no successor cell to prefetch, so ``alpha == 1`` pins
    ``x_slots=1``.  ``prefer_region="largest"`` (default) minimizes grid
    overhead; ``"smallest"`` is the paper's smallest-tile preference —
    maximal tile grids, i.e. END skipping at its finest granularity.
    ``compute_dtype`` re-tiers the whole ladder: the rungs are walked with
    that dtype's byte widths, so a chain that busts VMEM resident at float32
    may climb back to resident (or from channel-tiled to plain streamed x2)
    at bfloat16 — the launched kernel then moves that dtype end to end.

    ``batch`` is the costing scale: within a rung the plan knobs are chosen
    by ``modeled_cycles(batch)`` at the batch the launch will actually run
    (the serving engine plans per bucket).  The rung *order* needs no batch
    argument — resident weights are read once per launch while streamed
    re-reads scale with ``batch * alpha^2``, so the ladder is cost-monotone
    at every batch — but the batch still decides plans globally through the
    partitioner, which compares whole cut points at the bucket batch and
    shifts toward fewer, weight-resident launches as batch grows (weight
    loads amortize across the batch; activation traffic does not).
    Returns ``None`` when no single launch fits."""
    if prefer_region not in ("largest", "smallest"):
        from repro_torch.robust.errors import PreflightError

        raise PreflightError(
            f"prefer_region must be 'largest' or 'smallest',"
            f" got {prefer_region!r}"
        )
    compute_dtype = canonical_dtype(compute_dtype)
    out_size = spec.feature_sizes()[-1]
    regions = [r for r in range(out_size, 0, -1) if out_size % r == 0]
    if prefer_region == "smallest":
        regions.reverse()

    def x_options(prog: TileProgram) -> tuple[int, ...]:
        return (1,) if prog.alpha == 1 else (2, 1)

    def pick_x(prog: TileProgram, build) -> LaunchPlan | None:
        """Cheapest feasible input-buffer knob of one rung, costed at
        ``batch``: ``build(xs)`` returns the rung's plan at ``x_slots=xs``
        or None when it busts VMEM.  The prefetch pipeline is never modeled
        slower than serial at any batch; on a tie keep the extra landing
        slot (the historical ladder's preference)."""
        cands = [p for p in (build(xs) for xs in x_options(prog)) if p]
        if not cands:
            return None
        return min(cands, key=lambda p: (p.modeled_cycles(batch), -p.x_slots))

    def feasible(plan: LaunchPlan) -> LaunchPlan | None:
        return plan if plan.vmem_bytes() <= vmem_budget else None

    for r in regions:
        prog = compile_program(spec, r, compute_dtype=compute_dtype)
        plan = pick_x(
            prog,
            lambda xs, prog=prog: feasible(
                LaunchPlan(program=prog, streamed=False, x_slots=xs)
            ),
        )
        if plan is not None:
            return plan
    if allow_stream:
        # region preference stays primary (a smaller region multiplies the
        # alpha^2 streamed weight re-reads); within a region prefer the
        # double-buffered two-slot weight pipeline over channel-tiled
        # double buffering over the blocking single slot, and within a
        # weight regime the cheapest feasible input buffer at ``batch``
        for r in regions:
            prog = compile_program(spec, r, compute_dtype=compute_dtype)
            rungs = [dict(w_slots=2)]
            rungs += [dict(w_slots=2, c_tiles=ct) for ct in prog.c_tile_options()]
            rungs += [dict(w_slots=1)]
            for knobs in rungs:
                plan = pick_x(
                    prog,
                    lambda xs, prog=prog, knobs=knobs: feasible(
                        LaunchPlan(
                            program=prog, streamed=True, x_slots=xs, **knobs
                        )
                    ),
                )
                if plan is not None:
                    return plan
    return None


def pick_out_region(
    spec: FusionSpec,
    vmem_budget: int = VMEM_BUDGET_BYTES,
    *,
    allow_stream: bool = True,
    compute_dtype="float32",
) -> int | None:
    """Largest output region that tiles the output exactly and whose program
    fits the VMEM budget — the TPU analogue of the paper's ``H <= IFM``
    feasibility bound (DESIGN.md §2 assumption change #2).

    Fully-resident weights are preferred; when no region fits that way and
    ``allow_stream``, regions feasible under per-level weight streaming are
    considered.  Returns ``None`` when nothing fits (the chain must then be
    chunked).
    """
    plan = plan_launch(
        spec, vmem_budget, allow_stream=allow_stream,
        compute_dtype=compute_dtype,
    )
    return None if plan is None else plan.out_region
