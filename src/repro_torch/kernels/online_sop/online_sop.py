"""The digit-serial SOP + END kernel: CUDA launch wrapper and plain version.

:func:`online_sop_end_kernel` is the port of the reference's
``online_sop_end_pallas`` (``src/repro/kernels/online_sop/online_sop.py``)
minus its padding of ``P`` to a block multiple: it launches the
hand-written CUDA kernel :data:`SOP_END` (C entry ``online_sop_end`` in
``src/repro_torch/csrc/online_sop.cu``), which replaces ``_sop_end_kernel``
and masks the ragged edge itself.  :data:`SOP_END` carries a plain integer
``launches`` count that the wrapper bumps where it launches the kernel, and
nowhere else.  The source file's header says what the kernel computes,
what bounds it on the H100 and how its design answers that.

:func:`online_sop_end_plain` is the Pallas body in plain PyTorch: a loop
over cycles of ``v = 2w``, the digit select, ``w = v - d`` and ``prefix +=
2**-(j+1) * (d * y).sum(-1)``, then the END latch.  The wrapper takes it
**only** for tensors on the CPU; for a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.online_arith import select_digit
from repro_torch.kernels import build

# the largest m the kernel takes: y is staged in one block's shared memory
# (kMaxM in csrc/online_sop.cu)
_MAX_M = 56 * 1024

SOP_END = build.CudaKernel(
    "online_sop", "online_sop_end",
    # x, y, sop, cycle, detected, P, m, n_digits, stream
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p],
    "src/repro/kernels/online_sop/online_sop.py:35",
)


def _check_args(x: torch.Tensor, y: torch.Tensor, n_digits: int) -> None:
    """The kernel's argument contract, as raising checks."""
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(
            f"x and y must be float32, got {x.dtype} and {y.dtype}"
        )
    if x.dim() != 2 or y.dim() != 1 or x.shape[1] != y.shape[0]:
        raise ValueError(
            f"x must be (P, m) and y (m,); got {tuple(x.shape)} and"
            f" {tuple(y.shape)}"
        )
    if not 1 <= y.shape[0] <= _MAX_M:
        raise ValueError(f"m must lie in [1, {_MAX_M}], got {y.shape[0]}")
    if n_digits < 1:
        raise ValueError(f"n_digits must be >= 1, got {n_digits}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x and y must be contiguous")
    if x.device != y.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")


def online_sop_end_kernel(
    x: torch.Tensor, y: torch.Tensor, n_digits: int = 16
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(P, m), (m,) -> (sop (P,), term_cycle (P,), detected (P,))``.

    ``x`` holds the serial operands, ``|x| < 1``, and ``y`` the parallel
    weights, both contiguous float32 on one device.  ``sop`` is float32,
    ``term_cycle`` int32 (``n_digits`` where END never fired) and
    ``detected`` bool.  A tensor on the CPU runs
    :func:`online_sop_end_plain`; a CUDA tensor launches the CUDA kernel or
    raises.
    """
    _check_args(x, y, n_digits)
    if x.device.type == "cpu":
        return online_sop_end_plain(x, y, n_digits)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"online_sop_end_kernel runs on CUDA (or the CPU plain version),"
            f" not on {x.device}"
        )
    P = x.shape[0]
    sop = torch.empty(P, dtype=torch.float32, device=x.device)
    cyc = torch.empty(P, dtype=torch.int32, device=x.device)
    det = torch.empty(P, dtype=torch.bool, device=x.device)
    if P:
        with torch.cuda.device(x.device):
            launch(x, y, sop, cyc, det, n_digits,
                   stream=torch.cuda.current_stream(x.device).cuda_stream)
    return sop, cyc, det


def launch(x, y, sop, cyc, det, n_digits: int, *, stream: int) -> None:
    """One bare launch into preallocated outputs on ``stream`` (arguments
    already checked); raises if the launch is refused."""
    SOP_END.call(x.data_ptr(), y.data_ptr(), sop.data_ptr(), cyc.data_ptr(),
                 det.data_ptr(), x.shape[0], x.shape[1], n_digits, stream)


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
    arguments and results as :func:`online_sop_end_kernel`."""
    provably_neg = end_margins(x, y, n_digits) <= 0.0
    detected = provably_neg.any(-1)
    first = provably_neg.to(torch.uint8).argmax(-1).to(torch.int32) + 1
    cycle = torch.where(detected, first, n_digits).to(torch.int32)
    return (x * y).sum(-1), cycle, detected
