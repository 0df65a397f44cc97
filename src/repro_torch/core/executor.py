"""Fused-pyramid executor: value-level PyTorch execution of a fusion plan.

The port of the reference package's ``repro.core.executor`` and the port's
own in-package oracle for the kernel.  :func:`reference_forward`
materializes every intermediate map layer by layer; :func:`fused_forward`
computes every output tile of the fused chain **only from tile-local
buffers**, traced back through the compiled Eq. (1) windows
(:func:`repro_torch.core.program.compile_windows`), and must match it — the
correctness contract for the fusion-plan math (windows, lockstep movement,
edge handling).

Layout: NHWC activations, HWIO ``(K, K, Cin, Cout)`` conv weights and
``(Cout,)`` biases, as in the reference; the convolutions run as NCHW
``F.conv2d`` between permutes.  Conv levels apply ReLU.

On a CUDA device cuDNN runs float32 convolutions in TF32 unless told not
to, which keeps about three decimal digits; every oracle here runs under
:func:`full_fp32` so float32 means IEEE float32.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import resolve_device
from .fusion import FusionSpec, LockstepPlan, lockstep_plan
from .program import compile_windows


@contextlib.contextmanager
def full_fp32():
    """Run float32 convolutions and matmuls in IEEE float32 (TF32 off) for
    the scope, restoring the caller's settings on exit."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


@dataclass
class PyramidParams:
    """Weights for the conv levels of a fusion spec (index-aligned to convs)."""

    weights: list[torch.Tensor]
    biases: list[torch.Tensor]


def init_pyramid_params(
    spec: FusionSpec, *, seed: int = 0, scale: float = 1.0, device=None
) -> PyramidParams:
    """He-initialized float32 params for every conv level of ``spec``, drawn
    from a ``torch.Generator`` seeded with ``seed`` (on the CPU, so the
    numbers do not depend on the device) and placed on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    ws, bs = [], []
    for lvl in spec.levels:
        if lvl.kind != "conv":
            continue
        fan_in = lvl.K * lvl.K * lvl.n_in
        w = torch.randn(
            (lvl.K, lvl.K, lvl.n_in, lvl.n_out), generator=gen
        ) * (scale * (2.0 / fan_in) ** 0.5)
        b = torch.randn((lvl.n_out,), generator=gen) * 0.01
        ws.append(w.to(dev))
        bs.append(b.to(dev))
    return PyramidParams(ws, bs)


def conv2d_nhwc(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, stride: int,
    pad: int,
) -> torch.Tensor:
    """NHWC x HWIO convolution with symmetric zero padding, plus bias."""
    out = F.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride,
        padding=pad,
    ).permute(0, 2, 3, 1)
    return out if b is None else out + b


def maxpool_nhwc(x: torch.Tensor, k: int, s: int, pad: int = 0) -> torch.Tensor:
    """NHWC max pool; padding (if any) never wins the max."""
    return F.max_pool2d(
        x.permute(0, 3, 1, 2), k, s, padding=pad
    ).permute(0, 2, 3, 1)


def reference_forward(
    x: torch.Tensor, spec: FusionSpec, params: PyramidParams, *,
    relu: bool = True,
) -> torch.Tensor:
    """Layer-by-layer execution with full intermediate maps (the baseline
    dataflow whose off-chip traffic fusion eliminates)."""
    ci = 0
    with full_fp32():
        for lvl in spec.levels:
            if lvl.kind == "conv":
                x = conv2d_nhwc(
                    x, params.weights[ci], params.biases[ci], lvl.S, lvl.pad
                )
                if relu:
                    x = torch.relu(x)
                ci += 1
            else:
                x = maxpool_nhwc(x, lvl.K, lvl.S)
    return x.contiguous()


def fused_forward(
    x: torch.Tensor,
    spec: FusionSpec,
    params: PyramidParams,
    plan: LockstepPlan | None = None,
    *,
    out_region: int | None = None,
    relu: bool = True,
) -> torch.Tensor:
    """Execute the fused pyramid tile by tile per the lockstep plan.

    The ``alpha x alpha`` tile grid covers the final output; each tile's
    chain is traced back through the compiled Eq. (1) windows and computed
    from tile-local data only."""
    if plan is None:
        plan = lockstep_plan(spec, out_region or 1)
    wprog = compile_windows(spec, plan.out_region)
    out = torch.zeros(
        (x.shape[0], wprog.out_size, wprog.out_size, wprog.n_out),
        dtype=torch.float32, device=x.device,
    )
    p0 = spec.levels[0].pad
    with full_fp32():
        for si in plan.starts:
            wins_i = wprog.level_windows(si)
            for sj in plan.starts:
                wins_j = wprog.level_windows(sj)
                (lo_i, size_i), (lo_j, size_j) = wins_i[0], wins_j[0]
                ga_i, ga_j = lo_i - p0, lo_j - p0
                ai, bi = max(ga_i, 0), min(ga_i + size_i, x.shape[1])
                aj, bj = max(ga_j, 0), min(ga_j + size_j, x.shape[2])
                tile = F.pad(
                    x[:, ai:bi, aj:bj, :],
                    (0, 0, aj - ga_j, ga_j + size_j - bj,
                     ai - ga_i, ga_i + size_i - bi),
                )
                tile = _tile_chain_2d(
                    tile, (lo_i, lo_j), spec, params, (wins_i, wins_j), relu
                )
                out[:, si : si + plan.out_region,
                    sj : sj + plan.out_region, :] = tile
    return out


def _tile_chain_2d(tile, g_pad, spec, params, windows, relu):
    """Run one tile through the fused chain using only tile-local buffers.

    ``tile`` holds a window of the level-0 *unpadded* input starting at
    ``g = g_pad - pad_0`` (negative = overlaps the pad border; those rows are
    zero-filled by the caller).  At each level the requested Eq. (1) window
    is cut from the local buffer; any deficit is zero — exactly this level's
    padding.  After the level executes, rows outside the level's valid
    output range are cropped, so a deeper level that asks for them receives
    zeros (its own pad)."""
    wins_i, wins_j = windows
    sizes = spec.feature_sizes()
    gi = g_pad[0] - spec.levels[0].pad
    gj = g_pad[1] - spec.levels[0].pad
    ci = 0
    for l, lvl in enumerate(spec.levels):
        (loi_pad, size_i), (loj_pad, size_j) = wins_i[l], wins_j[l]
        loi, loj = loi_pad - lvl.pad, loj_pad - lvl.pad
        ai, aj = loi - gi, loj - gj
        bi, bj = ai + size_i, aj + size_j
        pli, phi = max(0, -ai), max(0, bi - tile.shape[1])
        plj, phj = max(0, -aj), max(0, bj - tile.shape[2])
        if pli or phi or plj or phj:
            tile = F.pad(tile, (0, 0, plj, phj, pli, phi))
            ai += pli
            bi += pli
            aj += plj
            bj += plj
        tile = tile[:, ai:bi, aj:bj, :]
        if lvl.kind == "conv":
            tile = conv2d_nhwc(
                tile, params.weights[ci], params.biases[ci], lvl.S, 0
            )
            if relu:
                tile = torch.relu(tile)
            ci += 1
        else:
            tile = maxpool_nhwc(tile, lvl.K, lvl.S)
        gi, gj = loi_pad // lvl.S, loj_pad // lvl.S
        # crop to the level's valid output range [0, out_size)
        out_size = sizes[l + 1]
        ci_lo, cj_lo = max(0, -gi), max(0, -gj)
        ci_hi = min(tile.shape[1], out_size - gi)
        cj_hi = min(tile.shape[2], out_size - gj)
        tile = tile[:, ci_lo:ci_hi, cj_lo:cj_hi, :]
        gi += ci_lo
        gj += cj_lo
    return tile
