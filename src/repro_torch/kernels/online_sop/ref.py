"""Plain-tensor oracle for the digit-serial SOP + END kernel.

The port of the reference's ``repro.kernels.online_sop.ref``.  Semantics:
inputs ``x`` (..., m) in (-1, 1) and parallel weights ``y`` (m,); the WPU
consumes one SD radix-2 digit of every ``x_i`` per cycle (MSDF), accumulates
the running SOP prefix, and terminates when the prefix is provably
negative:

    P_j + 2**-j * sum_i |y_i| <= 0

(the remaining digits can contribute at most ``2**-j * sum|y|``).  Outputs:
the full-precision SOP, the 1-based termination cycle (== T when it never
fires) and the detected flag.
"""

from __future__ import annotations

import torch

from repro_torch.core.online_arith import digit_weights, to_digits


def online_sop_end_ref(
    x: torch.Tensor, y: torch.Tensor, n_digits: int = 16
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Oracle: (sop, term_cycle, detected) for x: (..., m), y: (m,), both
    taken in float32."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    digits = to_digits(x, n_digits)  # (..., m, T)
    weights = digit_weights(n_digits, digits.device)
    # prefix_j of the SOP after digit j of every operand
    contrib = torch.einsum("...mt,m->...t", digits * weights, y)
    prefixes = contrib.cumsum(-1)  # (..., T)
    tail = weights * y.abs().sum()  # 2^-j * sum|y|
    provably_neg = prefixes + tail <= 0.0
    detected = provably_neg.any(-1)
    term = provably_neg.to(torch.uint8).argmax(-1) + 1  # first firing cycle
    term = torch.where(detected, term, n_digits)
    return x @ y, term.to(torch.int32), detected
