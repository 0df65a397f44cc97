"""The fused conv-pyramid kernel: CUDA launch wrapper and plain version.

:func:`fused_pyramid_kernel` is the port of the reference's
``fused_pyramid_pallas`` (``src/repro/kernels/fused_conv/fused_conv.py``),
with the same signature minus ``interpret``.  It launches one of two
hand-written CUDA kernels from ``src/repro_torch/csrc/fused_pyramid.cu``:

* :data:`PYRAMID` (C entry ``fused_pyramid``) replaces ``_pyramid_kernel``;
* :data:`PYRAMID_KTILED` (C entry ``fused_pyramid_ktiled``) replaces
  ``_ktiled_kernel``, for launches whose last level is split into
  ``c_tiles > 1`` output-channel blocks.

Each carries a plain integer ``launches`` count that its wrapper bumps
where it launches the kernel, and nowhere else
(:func:`repro_torch.kernels.build.reset_launch_counts` zeroes the counts of
every kernel of the port).  The source file's header
says what the kernel computes, what bounds it on the H100 and how its
design answers that.

:func:`fused_pyramid_plain` is the same per-cell algorithm in plain
PyTorch: the halo tiles of all grid cells gathered into one batch
dimension, each level as an ``F.conv2d`` on the tiles plus the bias, ReLU,
validity masks and pool epilogue, the END cascade as a ``torch.where``
against the closed form, and the same skip map.  The wrapper takes it
for tensors on the CPU, and on a CUDA tensor only when the caller passes
``plain=True`` (the guarded runner's recorded ``eager`` rung); otherwise a
CUDA tensor launches the kernel or raises.

Value contract (as in the reference, DESIGN.md §11): operands arrive in
``program.compute_dtype``; every conv accumulates in float32; the epilogue
runs in float32 and is cast to the compute dtype once per level, so every
inter-level tile and the output are compute-dtype values.  The int32 skip
map is dtype-invariant.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.dtypes import EXEC_DTYPES, torch_dtype
from repro_torch.core.executor import full_fp32
from repro_torch.core.program import (
    CONV_TILE_M,
    CONV_TILE_N,
    MAX_LEVELS,
    ConvLevelProg,
    TileProgram,
    card_layout,
    conv_tile,
)
from repro_torch.kernels import build

# int64 descriptor layout shared with csrc/fused_pyramid.cu (kHeader,
# kPerLevel); the CUDA side rejects a descriptor of any other length.  The
# conv tiles, K-splits and scratch capacity come from the planner's
# card_layout, which the card budget counts too.
_HEADER = 12
_PER_LEVEL = 19
_DTYPE_CODES = {"float32": 0, "bfloat16": 1}


class PyramidKernel(build.CudaKernel):
    """One entry point of the ``fused_pyramid`` library: the untiled or the
    channel-tiled pyramid, with the library's occupancy query."""

    def __init__(self, symbol: str, ktiled: bool, replaces: str):
        # dtype, descriptor, its length, then x, w, b, out, skip, scratch,
        # partial sums, live flags, barrier and the stream
        super().__init__(
            "fused_pyramid", symbol,
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 10,
            replaces,
        )
        self.ktiled = ktiled
        self._resident: dict[tuple[int, int], int] = {}

    def resident_blocks(self, dtype_code: int, device: torch.device) -> int:
        """Blocks of this kernel that fit on ``device`` at once — the grid
        of its cooperative launch (cached per device and dtype)."""
        key = (device.index, dtype_code)
        if key not in self._resident:
            query = self.lib().fused_pyramid_resident_blocks
            query.restype = ctypes.c_int
            query.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            blocks = ctypes.c_int(0)
            with torch.cuda.device(device):
                rc = query(dtype_code, int(self.ktiled), ctypes.byref(blocks))
            self.check(rc, "occupancy query")
            self._resident[key] = blocks.value
        return self._resident[key]

    def launch(self, dtype_code: int, desc: list[int], *tensors: torch.Tensor,
               stream: int) -> None:
        """Launch on ``stream`` with ``tensors`` = (x, w, b, out, skip,
        scratch, partial, live, barrier); raises if the launch is refused."""
        arr = (ctypes.c_longlong * len(desc))(*desc)
        self.call(dtype_code, arr, len(desc),
                  *(t.data_ptr() for t in tensors), stream)


PYRAMID = PyramidKernel(
    "fused_pyramid", False, "src/repro/kernels/fused_conv/fused_conv.py:154",
)
PYRAMID_KTILED = PyramidKernel(
    "fused_pyramid_ktiled", True,
    "src/repro/kernels/fused_conv/fused_conv.py:319",
)
KERNELS = (PYRAMID, PYRAMID_KTILED)


def _check_args(x_padded, weights, biases, program, stream_weights, x_slots,
                c_tiles, weights_flat) -> torch.dtype:
    """The reference wrapper's argument contract, as raising checks."""
    q = program.q_convs
    if program.compute_dtype not in EXEC_DTYPES:
        raise NotImplementedError(
            f"compute dtype {program.compute_dtype!r} is modeled but not"
            f" executable; the kernels run {EXEC_DTYPES}"
        )
    cdt = torch_dtype(program.compute_dtype)
    if x_padded.dtype != cdt:
        raise TypeError(
            f"x_padded dtype {x_padded.dtype} != program compute dtype {cdt}"
        )
    if any(b.dtype != cdt for b in biases):
        raise TypeError(f"bias dtypes must match the program compute dtype {cdt}")
    if weights is not None and any(w.dtype != cdt for w in weights):
        raise TypeError(
            f"weight dtypes must match the program compute dtype {cdt}"
        )
    if weights_flat is not None and weights_flat.dtype != cdt:
        raise TypeError(
            f"weights_flat dtype {weights_flat.dtype} != compute dtype {cdt}"
        )
    if x_slots not in (1, 2):
        raise ValueError("x_slots: 1 (serial) or 2 (revolving pipeline)")
    if len(biases) != q:
        raise ValueError("one bias per conv level")
    if not stream_weights and weights_flat is not None:
        raise ValueError(
            "weights_flat was passed with stream_weights=False: the resident"
            " kernel reads per-level weight tensors and would silently"
            " ignore it — pass stream_weights=True (or drop weights_flat)"
        )
    if weights is None:
        if not (stream_weights and weights_flat is not None):
            raise ValueError(
                "weights=None requires stream_weights=True and weights_flat"
            )
    elif weights_flat is None and len(weights) != q:
        raise ValueError("one weight tensor per conv level")
    if weights_flat is not None and weights_flat.numel() != sum(
        program.level_weight_counts()
    ):
        raise ValueError(
            "weights_flat does not match the program's level weight counts"
        )
    n_last = program.levels[-1].n_out
    if c_tiles < 1 or n_last % c_tiles != 0:
        raise ValueError(
            f"c_tiles {c_tiles} must divide the last level's Cout {n_last}"
        )
    if c_tiles > 1 and n_last // c_tiles < 2:
        raise ValueError(
            "channel slices must keep >= 2 channels (the reference's"
            " TileProgram.c_tile_options contract)"
        )
    if not (
        x_padded.dim() == 4
        and x_padded.shape[1] == x_padded.shape[2] == program.padded_input
        and x_padded.shape[3] == program.levels[0].n_in
    ):
        raise ValueError(
            f"x_padded must be (B, {program.padded_input},"
            f" {program.padded_input}, {program.levels[0].n_in}); got"
            f" {tuple(x_padded.shape)}"
        )
    return cdt


def _level_weights(weights, weights_flat, program: TileProgram) -> list:
    """Per-level (K, K, Cin, Cout) weight tensors, from the list or sliced
    out of the flat HWIO concatenation."""
    if weights is not None and weights_flat is None:
        return list(weights)
    out, off = [], 0
    for p, cnt in zip(program.levels, program.level_weight_counts()):
        out.append(
            weights_flat[off : off + cnt].view(p.K, p.K, p.n_in, p.n_out)
        )
        off += cnt
    return out


def fused_pyramid_kernel(
    x_padded: torch.Tensor,  # (B, Hp, Wp, C) pre-padded input
    weights: list[torch.Tensor] | None,
    biases: list[torch.Tensor],
    *,
    program: TileProgram,
    relu: bool = True,
    end_skip: bool = True,
    stream_weights: bool = False,
    w_slots: int = 2,
    x_slots: int = 2,
    c_tiles: int = 1,
    weights_flat: torch.Tensor | None = None,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the fused pyramid over the ``(B, alpha, alpha)`` grid.

    Arguments and results are those of the reference's
    ``fused_pyramid_pallas``: per-level HWIO ``weights`` (or, when
    ``stream_weights``, the flat concatenation ``weights_flat`` with
    ``weights=None`` allowed), per-level ``biases``, all in
    ``program.compute_dtype``.  ``x_slots``, ``w_slots`` and
    ``stream_weights`` are schedule knobs of the TPU kernel that never
    change values; they are validated and otherwise ignored.  ``c_tiles > 1``
    runs the channel-tiled kernel.  Returns ``(out, skip)``: out is
    ``(B, alpha * r, alpha * r, Cout)`` in the compute dtype and skip the
    ``(B, alpha, alpha, Q)`` int32 END flags (level 0 never skips).

    A tensor on the CPU runs :func:`fused_pyramid_plain`; a CUDA tensor
    launches the CUDA kernel or raises.  ``plain=True`` runs the plain
    version on any device: only the guarded runner's ``eager`` rung
    (:mod:`repro_torch.robust.degrade`) passes it, and that rung records a
    ``FallbackEvent`` each time.
    """
    del w_slots  # schedule-only on the TPU; one flat weight read here
    cdt = _check_args(x_padded, weights, biases, program, stream_weights,
                      x_slots, c_tiles, weights_flat)
    if plain or x_padded.device.type == "cpu":
        return fused_pyramid_plain(
            x_padded, weights, biases, program=program, relu=relu,
            end_skip=end_skip, weights_flat=weights_flat,
        )
    if x_padded.device.type != "cuda":
        raise RuntimeError(
            f"fused_pyramid_kernel runs on CUDA (or the CPU plain version),"
            f" not on {x_padded.device}"
        )
    return _launch(x_padded, weights, biases, program, relu, end_skip,
                   c_tiles, weights_flat, cdt)


def level_tiles(program: TileProgram) -> list[str]:
    """Each conv level's tile as ``"<pixels>x<channels>"``."""
    return [f"{CONV_TILE_M[conv_tile(p.out_size ** 2)]}x{CONV_TILE_N}"
            for p in program.levels]


def _descriptor(program: TileProgram, relu: bool, end_skip: bool,
                c_tiles: int, batch: int, grid: int
                ) -> tuple[list[int], int, int]:
    """The int64 launch descriptor (layout in csrc/fused_pyramid.cu), the
    per-cell scratch capacity in compute-dtype values, and the floats of
    split partial sums the launch needs, all from the program's
    :func:`~repro_torch.core.program.card_layout` on ``grid`` blocks.
    Each level's tile (the last field) sets its tile count, hence its
    K-split."""
    if program.q_convs > MAX_LEVELS:
        raise ValueError(
            f"the CUDA kernel takes at most {MAX_LEVELS} conv levels,"
            f" got {program.q_convs}"
        )
    lay = card_layout(program, batch, grid)
    desc = [
        batch, program.alpha, program.tile0, program.stride0,
        program.padded_input, program.levels[0].n_in, program.q_convs,
        int(relu), int(end_skip), c_tiles, lay.cap, grid,
    ]
    w_off = b_off = 0
    for p, cnt, split, tile in zip(program.levels,
                                   program.level_weight_counts(),
                                   lay.splits, lay.tiles):
        pk, ps = p.pool if p.pool is not None else (0, 0)
        desc += [
            p.K, p.S, p.n_in, p.n_out, p.in_size, p.out_size,
            p.o_base, p.o_step, p.valid,
            pk, ps, p.pool_out if p.pool is not None else 0,
            p.pool_o_base, p.pool_o_step, p.pool_valid,
            w_off, b_off, split, tile,
        ]
        w_off += cnt
        b_off += p.n_out
    assert len(desc) == _HEADER + _PER_LEVEL * program.q_convs
    if not lay.within_index_limit():
        raise ValueError(
            f"the launch needs {lay.scratch_vals} scratch values and"
            f" {lay.partial} partial sums; the kernel indexes them in 32"
            " bits: lower the batch"
        )
    return desc, lay.cap, lay.partial


def _launch(x_padded, weights, biases, program, relu, end_skip, c_tiles,
            weights_flat, cdt):
    kernel, code, desc, bufs = prepare_launch(
        x_padded, weights, biases, program, relu, end_skip, c_tiles,
        weights_flat, cdt,
    )
    dev = x_padded.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel.launch(code, desc, *bufs, stream=stream)
    return bufs[3], bufs[4]


def prepare_launch(x_padded, weights, biases, program, relu, end_skip,
                   c_tiles, weights_flat, cdt):
    """Everything one launch needs but the launch itself: ``(kernel,
    dtype code, descriptor, buffers)`` with buffers = (x, w, b, out, skip,
    scratch, partial sums, live flags, barrier).  The live flags and the
    barrier must be zero when the kernel starts."""
    dev = x_padded.device
    if weights_flat is None:
        weights_flat = torch.cat([w.reshape(-1) for w in weights])
    for name, t in (("weights", weights_flat), *(
        (f"bias {l}", b) for l, b in enumerate(biases)
    )):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x_padded on {dev}")
    w = weights_flat.contiguous()
    b = torch.cat([t.reshape(-1) for t in biases]).contiguous()
    x = x_padded.contiguous()
    B, q, alpha = x.shape[0], program.q_convs, program.alpha
    cells = B * alpha * alpha
    kernel = PYRAMID_KTILED if c_tiles > 1 else PYRAMID
    code = _DTYPE_CODES[program.compute_dtype]
    # one persistent block per co-resident slot: the cooperative grid
    grid = kernel.resident_blocks(code, dev)
    desc, cap, partial = _descriptor(program, relu, end_skip, c_tiles, B,
                                     grid)
    region = program.out_region
    out = torch.empty(
        (B, alpha * region, alpha * region, program.n_out), dtype=cdt,
        device=dev,
    )
    skip = torch.empty((B, alpha, alpha, q), dtype=torch.int32, device=dev)
    scratch = torch.empty(3 * cells * cap, dtype=cdt, device=dev)
    part = torch.empty(max(partial, 1), dtype=torch.float32, device=dev)
    live = torch.zeros(cells * q, dtype=torch.int32, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    return kernel, code, desc, (x, w, b, out, skip, scratch, part, live, bar)


# ---------------------------------------------------------------------------
# plain PyTorch version of the same per-cell algorithm
# ---------------------------------------------------------------------------


def _mask(t: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor, o_base: int,
          o_step: int, valid: int) -> torch.Tensor:
    """Zero rows/cols of every cell's (N, C, h, w) tile whose global
    coordinate lies outside ``[0, valid)``; cell n sits at grid (ii[n],
    jj[n])."""
    h, w = t.shape[2], t.shape[3]
    rows = torch.arange(h, device=t.device)[None, :] + (o_base + ii * o_step)[:, None]
    cols = torch.arange(w, device=t.device)[None, :] + (o_base + jj * o_step)[:, None]
    mrow = (rows >= 0) & (rows < valid)
    mcol = (cols >= 0) & (cols < valid)
    return t * (mrow[:, None, :, None] & mcol[:, None, None, :])


def _epilogue(t, ii, jj, p: ConvLevelProg) -> torch.Tensor:
    """Mask the conv output to its valid range, pool, mask the pool output
    (all in float32, as the reference's ``_level_epilogue``)."""
    t = _mask(t, ii, jj, p.o_base, p.o_step, p.valid)
    if p.pool is not None:
        t = F.max_pool2d(t, p.pool[0], p.pool[1])
        t = _mask(t, ii, jj, p.pool_o_base, p.pool_o_step, p.pool_valid)
    return t


def fused_pyramid_plain(
    x_padded: torch.Tensor,
    weights: list[torch.Tensor] | None,
    biases: list[torch.Tensor],
    *,
    program: TileProgram,
    relu: bool = True,
    end_skip: bool = True,
    weights_flat: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in plain PyTorch, on any device.

    Gathers every grid cell's ``tile0 x tile0`` halo tile into a batch of
    ``B * alpha^2`` NCHW tiles (cells ordered ``(b, i, j)``), runs each conv
    level as a valid ``F.conv2d`` on the float32 values of the
    compute-dtype tiles (float32 accumulation), adds the bias, applies
    ReLU, the masks and the pool, casts once to the compute dtype, and
    replaces dead cells (``max == 0`` input at a level >= 1) with the
    closed form ``epilogue(relu(b))``.  It takes no ``c_tiles``: splitting
    the last level into channel blocks changes no value.  Returns ``(out,
    skip)`` like :func:`fused_pyramid_kernel`."""
    cdt = torch_dtype(program.compute_dtype)
    ws = _level_weights(weights, weights_flat, program)
    B, C = x_padded.shape[0], x_padded.shape[3]
    alpha, t0, s0 = program.alpha, program.tile0, program.stride0
    n = B * alpha * alpha
    dev = x_padded.device
    tiles = (
        x_padded.permute(0, 3, 1, 2)
        .unfold(2, t0, s0)
        .unfold(3, t0, s0)[:, :, :alpha, :alpha]  # (B, C, a, a, t0, t0)
        .permute(0, 2, 3, 1, 4, 5)
        .reshape(n, C, t0, t0)
    )
    cell = torch.arange(alpha * alpha, device=dev).repeat(B)
    ii, jj = cell // alpha, cell % alpha
    t = tiles
    skips = []
    q = program.q_convs
    with full_fp32():
        for l, p in enumerate(program.levels):
            w = ws[l].float().permute(3, 2, 0, 1)  # OIHW
            b = biases[l].float()
            conv = F.conv2d(t.float(), w, stride=p.S) + b.view(1, -1, 1, 1)
            if relu:
                conv = torch.relu(conv)
            t_live = _epilogue(conv, ii, jj, p).to(cdt)
            if l == 0 or not (relu and end_skip):
                skips.append(torch.zeros(n, dtype=torch.int32, device=dev))
                t = t_live
                continue
            live = t.flatten(1).amax(dim=1) > 0
            const = torch.relu(b).view(1, -1, 1, 1).expand(
                n, -1, p.out_size, p.out_size
            )
            t_const = _epilogue(const, ii, jj, p).to(cdt)
            t = torch.where(live.view(-1, 1, 1, 1), t_live, t_const)
            skips.append((~live).to(torch.int32))
    r = program.out_region
    out = (
        t.view(B, alpha, alpha, program.n_out, r, r)
        .permute(0, 1, 4, 2, 5, 3)
        .reshape(B, alpha * r, alpha * r, program.n_out)
    )
    skip = torch.stack(skips, dim=-1).view(B, alpha, alpha, q)
    return out, skip
