"""USEFUSE fusion-pyramid planning.

A copy of the reference package's ``repro.core.fusion`` (pure Python; kept
identical so every spec, window and plan matches the reference).

Implements the paper's layer-fusion math:

* Eq. (1): ``D_l = (D_o - 1) * S_l + K_l`` — receptive-field recurrence used to
  derive per-level tile sizes from a chosen output region (Algorithm 3).
* Algorithm 4: *uniform tile stride* — per level, enumerate integer movement
  counts ``alpha = (IFM - H)/p + 1`` and intersect across levels so every level
  of the pyramid moves the same number of times (no synchronization stalls,
  no ragged execution rounds).

Two layers of fidelity are provided (see DESIGN.md §2):

``tile_sizes`` / ``uniform_tile_stride`` / ``plan_fusion``
    The paper's algorithms, literally.  These reproduce the paper's alpha
    values (LeNet-5 -> 5, AlexNet -> 9, VGG-16 first two blocks -> 3).

``lockstep_plan``
    The physically-exact tile schedule used by the executor / Pallas kernel:
    tiles at every level move in lockstep (movement at level l is the final
    output-region stride times the cumulative downsampling), with exact ragged
    edge tiles.  Algorithm 4 as printed guarantees *per-level* coverage but not
    inter-level lockstep when inner layers are padded; the executor must be
    exact, so it uses this plan.
"""

from __future__ import annotations

from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Layer / network description
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FusedLevel:
    """One level of the fusion pyramid: a conv or pooling stage.

    Attributes mirror the paper's symbols: kernel ``K``, stride ``S``; ``pad``
    is symmetric spatial padding (the paper's examples are pad-0; AlexNet /
    VGG need it).  ``kind`` is ``"conv"`` or ``"pool"``.  ``n_in``/``n_out``
    are channel counts (N and M in the paper) used by cycle/intensity models.
    """

    kind: str
    K: int
    S: int
    pad: int = 0
    n_in: int = 1
    n_out: int = 1
    name: str = ""

    def out_size(self, in_size: int) -> int:
        """Spatial output size for a (padded) input of ``in_size``."""
        return (in_size + 2 * self.pad - self.K) // self.S + 1


@dataclass(frozen=True)
class FusionSpec:
    """A chain of levels to fuse plus the network input size.

    Construction validates the channel chain (level *l+1* must consume what
    level *l* produces; pools preserve channels) so that a malformed chain
    fails here with a named level instead of deep inside the kernel wrapper
    with a shape error.
    """

    levels: tuple[FusedLevel, ...]
    input_size: int  # unpadded spatial size of the first level's input

    def __post_init__(self) -> None:
        if not self.levels:
            raise ValueError("FusionSpec needs at least one level")
        carried: int | None = None
        for l, lvl in enumerate(self.levels):
            label = lvl.name or f"level {l} ({lvl.kind})"
            if lvl.kind not in ("conv", "pool"):
                raise ValueError(f"{label}: unknown level kind {lvl.kind!r}")
            if lvl.kind == "pool" and lvl.n_in != lvl.n_out:
                raise ValueError(
                    f"{label}: pools preserve channels, got "
                    f"n_in={lvl.n_in} != n_out={lvl.n_out}"
                )
            if carried is not None and lvl.n_in != carried:
                raise ValueError(
                    f"{label}: n_in={lvl.n_in} does not chain with the "
                    f"{carried} channels produced by the previous level"
                )
            carried = lvl.n_out

    @property
    def q_convs(self) -> int:
        return sum(1 for l in self.levels if l.kind == "conv")

    def feature_sizes(self) -> list[int]:
        """Unpadded input spatial size of every level, plus the final output.

        ``sizes[l]`` is the *unpadded* input to level ``l``;  ``sizes[-1]`` is
        the final output size of the fused chain.
        """
        sizes = [self.input_size]
        cur = self.input_size
        for lvl in self.levels:
            cur = lvl.out_size(cur)
            sizes.append(cur)
        return sizes


# ---------------------------------------------------------------------------
# Algorithm 3 — tile sizes from Eq. (1)
# ---------------------------------------------------------------------------


def tile_sizes(spec: FusionSpec, out_region: int) -> list[int]:
    """Eq. (1) chained from the last level to the first (Algorithm 3).

    Returns ``T`` with ``T[l]`` = tile size in level ``l``'s input coordinates
    (``T[-1] == out_region``, the selected square region of the final output
    feature map).  ``len(T) == len(levels) + 1``.
    """
    T = [out_region]
    cur = out_region
    for lvl in reversed(spec.levels):
        cur = (cur - 1) * lvl.S + lvl.K  # Eq. (1)
        T.append(cur)
    T.reverse()
    return T


def all_tile_configs(spec: FusionSpec) -> dict[int, list[int]]:
    """Algorithm 3's full H matrix: tile sizes for every feasible out_region.

    Bounded by ``H <= IFM`` (padded input size) per the paper's Ensure clause.
    """
    sizes = spec.feature_sizes()
    configs: dict[int, list[int]] = {}
    for r in range(1, sizes[-1] + 1):
        T = tile_sizes(spec, r)
        ok = all(
            T[l] <= sizes[l] + 2 * spec.levels[l].pad for l in range(len(spec.levels))
        )
        if ok:
            configs[r] = T
    return configs


# ---------------------------------------------------------------------------
# Algorithm 4 — uniform tile stride
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LevelStride:
    """Chosen tile stride for one level (paper's S^T) and its movement count."""

    tile: int  # H_l, tile size in this level's (padded) input coords
    stride: int  # S^T_l
    alpha: int  # movements per spatial dim; uniform across levels
    ifm: int  # padded input size this level tiles over


@dataclass(frozen=True)
class FusionPlan:
    """Result of the paper's planning pipeline (Fig. 2)."""

    spec: FusionSpec
    out_region: int
    alpha: int
    levels: tuple[LevelStride, ...]

    @property
    def movements(self) -> int:
        """Total tile executions: alpha^2 (square maps, square tiles)."""
        return self.alpha * self.alpha


def _level_candidates(
    ifm: int, tile: int, K: int, S: int, *, require_alignment: bool
) -> dict[int, int]:
    """Feasible {alpha: max stride} for one level (inner loop of Algorithm 4).

    A stride ``p`` is feasible when:
      * ``alpha = (ifm - tile)/p + 1`` is a positive integer (exact coverage,
        the paper's ``alpha in Z`` test);
      * ``p <= tile - K + S`` so consecutive tiles leave no uncomputed output
        between them (the paper's "do not skip computation of some regions");
      * optionally ``p % S == 0`` so every tile start lands on the conv/pool
        grid.  The paper does not state this check (its examples are stride-1
        convs where it is vacuous); default off for fidelity.
    """
    span = ifm - tile
    out: dict[int, int] = {}
    if span == 0:
        return {1: 0}  # single tile covers the level
    noskip = tile - K + S
    for p in range(1, tile + 1):
        if span % p != 0:
            continue
        if p > noskip:
            continue
        if require_alignment and p % S != 0:
            continue
        alpha = span // p + 1
        # max stride per alpha (larger stride == less overlap, paper's pick)
        if alpha not in out or p > out[alpha]:
            out[alpha] = p
    return out


def uniform_tile_stride(
    spec: FusionSpec,
    out_region: int,
    *,
    require_alignment: bool = False,
) -> FusionPlan | None:
    """Algorithm 4 + the paper's selection rule.

    Intersects each *conv* level's feasible alpha set and picks the minimum
    uniform alpha (fewest movements -> largest strides -> least overlap
    growth), then the maximum stride per level for that alpha.

    Pooling levels contribute to the Eq.(1) tile-size chain but are excluded
    from the stride constraints: in the paper's architecture (Fig. 4) pooling
    is an epilogue block applied to each conv tile's output region, so its
    traversal is slaved to the conv tile rather than independently strided.
    (This is the only reading under which the paper's own alpha values —
    LeNet-5: 5, AlexNet: 9, VGG blocks 1-2: 3 — are reproducible; validated
    in tests/test_fusion.py.)

    Returns ``None`` when no uniform integer alpha exists for this region.
    """
    T = tile_sizes(spec, out_region)
    sizes = spec.feature_sizes()
    per_level: list[dict[int, int] | None] = []
    for l, lvl in enumerate(spec.levels):
        ifm = sizes[l] + 2 * lvl.pad
        if T[l] > ifm:
            return None
        if lvl.kind != "conv":
            per_level.append(None)  # slaved to the preceding conv level
            continue
        per_level.append(
            _level_candidates(
                ifm, T[l], lvl.K, lvl.S, require_alignment=require_alignment
            )
        )
    conv_cands = [c for c in per_level if c is not None]
    if not conv_cands:
        # degenerate chain with no conv levels: constrain on every level
        per_level = [
            _level_candidates(
                sizes[l] + 2 * lvl.pad, T[l], lvl.K, lvl.S,
                require_alignment=require_alignment,
            )
            for l, lvl in enumerate(spec.levels)
        ]
        conv_cands = per_level
    common = set(conv_cands[0])
    for cand in conv_cands[1:]:
        common &= set(cand)
    if not common:
        return None
    alpha = min(common)
    chosen = []
    for l, lvl in enumerate(spec.levels):
        ifm = sizes[l] + 2 * lvl.pad
        if per_level[l] is not None:
            stride = per_level[l][alpha]
        else:
            # slaved pool level: exact movement if the span divides, else the
            # executor handles it with ragged/clamped windows (stride 0 flag).
            span = ifm - T[l]
            stride = span // (alpha - 1) if alpha > 1 and span % (alpha - 1) == 0 else 0
        chosen.append(LevelStride(tile=T[l], stride=stride, alpha=alpha, ifm=ifm))
    return FusionPlan(
        spec=spec, out_region=out_region, alpha=alpha, levels=tuple(chosen)
    )


def plan_fusion(
    spec: FusionSpec,
    *,
    out_region: int | None = None,
    require_alignment: bool = False,
) -> FusionPlan:
    """The paper's design pipeline (Fig. 2): pick the smallest output region
    admitting a uniform integer alpha, then the minimum such alpha.

    ``out_region`` pins the region explicitly (used when matching a paper
    configuration); otherwise regions are scanned smallest-first, per the
    paper's goal of "the smallest possible tile sizes ... maintaining a
    uniform tile movement".
    """
    if out_region is not None:
        plan = uniform_tile_stride(
            spec, out_region, require_alignment=require_alignment
        )
        if plan is None:
            raise ValueError(
                f"no uniform tile stride exists for out_region={out_region}"
            )
        return plan
    last = spec.feature_sizes()[-1]
    for r in range(1, last + 1):
        plan = uniform_tile_stride(spec, r, require_alignment=require_alignment)
        if plan is not None:
            return plan
    raise ValueError("no uniform tile stride exists for any output region")


# ---------------------------------------------------------------------------
# Lockstep (executor-exact) plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LockstepPlan:
    """Exact tile schedule: all levels move together.

    ``starts`` are the final-output region start indices (1-D; the 2-D grid is
    the cross product).  The executor derives every level's window from these
    via the receptive-field chain, clamping at the edges (ragged tiles), so
    composition is exact regardless of inner padding.
    """

    spec: FusionSpec
    out_region: int
    out_stride: int
    starts: tuple[int, ...]

    @property
    def alpha(self) -> int:
        return len(self.starts)


def lockstep_plan(
    spec: FusionSpec, out_region: int, out_stride: int | None = None
) -> LockstepPlan:
    """Build the exact schedule for a chosen output region and stride.

    Defaults to ``out_stride = out_region`` (non-overlapping output tiles —
    every output pixel computed exactly once, overlap exists only in inputs).
    The last start is clamped so the union of regions covers the output.
    """
    out_size = spec.feature_sizes()[-1]
    s = out_region if out_stride is None else out_stride
    if out_region >= out_size:
        return LockstepPlan(spec, out_size, s, (0,))
    starts = list(range(0, out_size - out_region, s))
    starts.append(out_size - out_region)  # clamp final tile
    return LockstepPlan(spec, out_region, s, tuple(starts))


def receptive_window(
    spec: FusionSpec, start: int, size: int
) -> list[tuple[int, int]]:
    """Map a final-output interval [start, start+size) back through the chain.

    Returns per-level ``(start, size)`` in each level's *padded* input
    coordinates, first level first; the paper's Fig. 2 "start and end indices
    of the feature maps intended for each layer".
    """
    windows: list[tuple[int, int]] = []
    lo, hi = start, start + size - 1  # inclusive range, this level's OUTPUT coords
    for lvl in reversed(spec.levels):
        lo_in = lo * lvl.S  # this level's PADDED input coords
        hi_in = hi * lvl.S + lvl.K - 1
        windows.append((lo_in, hi_in - lo_in + 1))
        # previous level's output coords = this level's unpadded input coords
        lo = lo_in - lvl.pad
        hi = hi_in - lvl.pad
    windows.reverse()
    return windows
