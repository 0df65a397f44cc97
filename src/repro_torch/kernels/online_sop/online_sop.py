"""The digit-serial SOP + END kernel: CUDA launch wrapper and plain version.

:func:`online_sop_end_kernel` is the port of the reference's
``online_sop_end_pallas`` (``src/repro/kernels/online_sop/online_sop.py``)
minus its padding of ``P`` to a block multiple, with the reference's
``jax.vmap`` over a layer's filters written out as a filter axis on ``y``:
``y (m,)`` or ``y (F, m)``, one launch either way.  It launches the
hand-written CUDA kernel :data:`SOP_END` (C entry ``online_sop_end`` in
``src/repro_torch/csrc/online_sop.cu``), which replaces ``_sop_end_kernel``
and masks the ragged edges itself.  :data:`SOP_END` carries a plain integer
``launches`` count that :func:`launch` bumps where it launches the kernel,
and nowhere else.  The source file's header says what the kernel computes,
why its digit sums are exact, what bounds it on the H100 and how its design
answers that.

:func:`quantise_filters` and :func:`split_limbs` put each filter in 31-bit
fixed point as four balanced int8 limbs, the kernel's tensor-core operand;
:func:`prepare_weights` pads them to the kernel's tiles.

:func:`online_sop_end_plain` is the Pallas body in plain PyTorch, one
filter at a time: a loop over cycles of ``v = 2w``, the digit select,
``w = v - d`` and ``prefix += 2**-(j+1) * (d * y).sum(-1)``, then the END
latch.  The wrapper takes it **only** for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.online_arith import select_digit
from repro_torch.kernels import build

# the largest m the kernel takes (kMaxM in csrc/online_sop.cu).  Y is staged
# in k-tiles, so shared memory no longer bounds m; the limbs' exact sums do:
# a pair of them, 257 * 128 * m, stays inside int32.
_MAX_M = 56 * 1024
# the kernel's tiles (kKTile and kFilters in csrc/online_sop.cu): the limbs
# are padded to multiples of these with zeros
_K_TILE = 64
_FILTER_TILE = 64
_N_LIMBS = 4
# added to q, it makes every balanced limb's byte non-negative
_LIMB_BIAS = 128 * sum(256 ** k for k in range(_N_LIMBS))

SOP_END = build.CudaKernel(
    "online_sop", "online_sop_end",
    # x, y, limbs, tail, sop, cycle, detected, P, m, F, n_digits, stream
    [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p],
    "src/repro/kernels/online_sop/online_sop.py:35",
)


def _check_args(x: torch.Tensor, y: torch.Tensor, n_digits: int) -> None:
    """The kernel's argument contract, as raising checks."""
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(
            f"x and y must be float32, got {x.dtype} and {y.dtype}"
        )
    if (x.dim() != 2 or y.dim() not in (1, 2) or y.shape[-1] != x.shape[1]
            or y.numel() == 0):
        raise ValueError(
            f"x must be (P, m) and y (m,) or (F, m) with F >= 1; got"
            f" {tuple(x.shape)} and {tuple(y.shape)}"
        )
    if not 1 <= y.shape[-1] <= _MAX_M:
        raise ValueError(f"m must lie in [1, {_MAX_M}], got {y.shape[-1]}")
    if n_digits < 1:
        raise ValueError(f"n_digits must be >= 1, got {n_digits}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x and y must be contiguous")
    if x.device != y.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")


def quantise_filters(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(F, m)`` float32 -> ``(q (F, m) int64, E (F,) int64)`` with
    ``q = round(y * 2**(31 - E))``.

    ``E`` is ``ceil(log2 max|y_f|) + 1``: one bit above the reference's
    scale, so ``|q| <= 2**30`` fits four balanced int8 limbs (whose range
    stops at 2,139,062,143, short of ``2**31``) even where ``max|y_f|`` is
    a power of two.  ``|y - q * 2**(E - 31)| <= 2**(E - 32)``.  An all-zero
    filter takes ``E = 0`` and ``q = 0``."""
    mant, ex = torch.frexp(y.abs().amax(-1))  # max|y| = mant 2**ex
    e = (ex + (mant > 0.5)).to(torch.int64)
    q = torch.round(torch.ldexp(y.to(torch.float64), (31 - e)[:, None]))
    return q.to(torch.int64), e


def split_limbs(q: torch.Tensor) -> torch.Tensor:
    """``q`` int64, ``|q| <= 2**30`` -> ``(4, *q.shape)`` int8 limbs in
    [-128, 127] with ``q = sum_l 256**l * limbs[l]``: the balanced base-256
    digits of ``q``, read as the bytes of ``q + 128 * (1 + 256 + 256**2 +
    256**3)`` (each in [0, 255], low byte first as on every device the
    port runs on) less 128, which flips their top bit."""
    u = (q + _LIMB_BIAS).contiguous()  # in [0, 2**32)
    low = u.view(torch.uint8).unflatten(-1, (-1, 8))[..., :_N_LIMBS]
    return torch.bitwise_xor(low, 0x80).view(torch.int8).movedim(-1, 0)


class SopWeights(NamedTuple):
    """A layer's filters as the kernel takes them: ``y (F, m)`` float32 for
    ``sop``, ``limbs (4, F_pad, m_pad)`` int8 and ``tail (F_pad,)`` float64
    (``sum|q|``), zero past ``F`` and ``m``."""

    y: torch.Tensor
    limbs: torch.Tensor
    tail: torch.Tensor


def prepare_weights(y: torch.Tensor) -> SopWeights:
    """``y (F, m)`` float32 -> :class:`SopWeights` on ``y``'s device
    (plain tensor ops, set-up of the launch)."""
    F, m = y.shape
    q, _ = quantise_filters(y)
    f_pad = -(-F // _FILTER_TILE) * _FILTER_TILE
    m_pad = -(-m // _K_TILE) * _K_TILE
    limbs = torch.zeros((_N_LIMBS, f_pad, m_pad), dtype=torch.int8,
                        device=y.device)
    limbs[:, :F, :m] = split_limbs(q)
    tail = torch.zeros(f_pad, dtype=torch.float64, device=y.device)
    tail[:F] = q.abs().sum(-1).to(torch.float64)
    return SopWeights(y, limbs, tail)


def online_sop_end_kernel(
    x: torch.Tensor, y: torch.Tensor, n_digits: int = 16
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(P, m), (m,) -> (sop (P,), term_cycle (P,), detected (P,))``, or
    ``(P, m), (F, m) -> (P, F)`` outputs, column ``f`` for filter ``f``.

    ``x`` holds the serial operands, ``|x| < 1``, and ``y`` the parallel
    weights, both contiguous float32 on one device.  ``sop`` is float32,
    ``term_cycle`` int32 (``n_digits`` where END never fired) and
    ``detected`` bool.  A tensor on the CPU runs
    :func:`online_sop_end_plain`; a CUDA tensor launches the CUDA kernel
    once, for all ``F`` filters, or raises.
    """
    _check_args(x, y, n_digits)
    if x.device.type == "cpu":
        return online_sop_end_plain(x, y, n_digits)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"online_sop_end_kernel runs on CUDA (or the CPU plain version),"
            f" not on {x.device}"
        )
    y2 = y if y.dim() == 2 else y[None]
    shape = (x.shape[0], y2.shape[0])
    sop = torch.empty(shape, dtype=torch.float32, device=x.device)
    cyc = torch.empty(shape, dtype=torch.int32, device=x.device)
    det = torch.empty(shape, dtype=torch.bool, device=x.device)
    if x.shape[0]:
        with torch.cuda.device(x.device):
            launch(x, prepare_weights(y2), sop, cyc, det, n_digits,
                   stream=torch.cuda.current_stream(x.device).cuda_stream)
    if y.dim() == 1:
        return sop[:, 0], cyc[:, 0], det[:, 0]
    return sop, cyc, det


def launch(x, w: SopWeights, sop, cyc, det, n_digits: int, *,
           stream: int) -> None:
    """One bare launch into preallocated ``(P, F)`` outputs on ``stream``
    (arguments already checked); raises if the launch is refused."""
    SOP_END.call(x.data_ptr(), w.y.data_ptr(), w.limbs.data_ptr(),
                 w.tail.data_ptr(), sop.data_ptr(), cyc.data_ptr(),
                 det.data_ptr(), x.shape[0], x.shape[1], w.y.shape[0],
                 n_digits, stream)


# ---------------------------------------------------------------------------
# plain PyTorch version of the same algorithm
# ---------------------------------------------------------------------------


def end_margins(x: torch.Tensor, y: torch.Tensor, n_digits: int
                ) -> torch.Tensor:
    """``(P, n_digits)``: after cycle ``j`` (0-based) of the Pallas body,
    ``P_j + 2**-(j+1) * sum|y|``, the quantity whose first value ``<= 0``
    latches END.  Each cycle is the body's float32 arithmetic: ``v = 2w``,
    the digit select, ``w = v - d``, ``prefix += 2**-(j+1) * (d * y).sum(-1)``.
    """
    tail = y.abs().sum()
    w = x
    prefix = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    out = torch.empty((x.shape[0], n_digits), dtype=torch.float32,
                      device=x.device)
    for j in range(n_digits):
        v = 2.0 * w
        d = select_digit(v)
        w = v - d
        scale = 2.0 ** -(j + 1)
        prefix = prefix + scale * (d * y).sum(-1)
        out[:, j] = prefix + scale * tail
    return out


def latch_disagreements(x, y, n_digits: int, got, plain
                        ) -> tuple[torch.Tensor, torch.Tensor, float]:
    """Rows where ``got`` (a kernel's ``(sop, cycle, detected)``) and
    ``plain`` (:func:`online_sop_end_plain`'s) latch END differently.

    The digits are exact, so the two can differ only through the order of
    the float32 sums ``sum_i d_ij y_i``, i.e. where the plain version's
    margin ``P_j + 2**-j * sum|y|`` lies within their rounding of zero at
    the first cycle where the two disagree.  Returns ``(rows, margins,
    tie)``: the disagreeing rows, the plain version's ``|margin|`` at that
    cycle, and the band ``(m + n_digits) * 2**-24 * sum|y|`` a margin must
    lie within for the disagreement to be such a near-tie."""
    _, cyc, det = got
    _, pcyc, pdet = plain
    rows = ((cyc != pcyc) | (det != pdet)).nonzero().flatten()
    first = torch.minimum(cyc[rows], pcyc[rows]).long() - 1
    margins = end_margins(x[rows], y, n_digits)
    at = margins.gather(1, first[:, None]).flatten().abs()
    tie = (x.shape[1] + n_digits) * 2.0 ** -24 * float(y.abs().sum())
    return rows, at, tie


def online_sop_end_plain(
    x: torch.Tensor, y: torch.Tensor, n_digits: int = 16
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in plain PyTorch, on any device; the same
    arguments and results as :func:`online_sop_end_kernel` (a ``(F, m)``
    ``y`` runs one filter at a time and stacks the results on the last
    dim)."""
    if y.dim() == 2:
        outs = [online_sop_end_plain(x, yf, n_digits) for yf in y]
        return tuple(torch.stack(o, dim=-1) for o in zip(*outs))
    provably_neg = end_margins(x, y, n_digits) <= 0.0
    detected = provably_neg.any(-1)
    first = provably_neg.to(torch.uint8).argmax(-1).to(torch.int32) + 1
    cycle = torch.where(detected, first, n_digits).to(torch.int32)
    return (x * y).sum(-1), cycle, detected
