"""Online (MSDF) arithmetic over the signed-digit radix-2 set {-1, 0, 1}.

The port of the reference package's ``repro.core.online_arith``: the same
vectorized simulation of the paper's compute substrate (§3.1), with each
``lax.scan`` over the digit axis written as a Python loop over torch tensors.

* :func:`to_digits` / :func:`from_digits` — SD radix-2 encode/decode.  Values
  are normalized fractions in (-1, 1); digit ``j`` (0-based) has weight
  ``2**-(j+1)``, most significant digit first.
* :func:`online_mul_sp` — Algorithm 1, the serial-parallel online multiplier
  (serial MSDF input ``x``, parallel constant ``Y``, online delay delta=2).
* :func:`online_add` — online adder on two digit streams (delta=2).
* :func:`online_sop` — the WPU: per-window products reduced through a binary
  tree of online adders, producing the sum-of-products digit stream that the
  END unit observes (§3.2).

Scaling convention: each simulated adder computes ``(a+b)/2`` so every
stream stays in (-1, 1); a depth-``d`` tree therefore yields ``sop / 2**d``
(the hardware emits extra leading digits instead, which the cycle model
charges as growth cycles).

All recurrences follow one residual form:
``v_t = 2*w_{t-1} + (new digit contribution) * 2**-delta``;
``z_t = SEL(v_t)``; ``w_t = v_t - z_t``;
with SEL(v) = sign(v) when ``|v| >= 0.5`` else 0.  Every step is the same
float32 operation on the same operands, in the same order, as in the
reference, so the digits equal the reference's bit for bit.
"""

from __future__ import annotations

import math

import torch

DELTA_OLM = 2  # online delay of the serial-parallel multiplier (paper §3.1.1)
DELTA_OLA = 2  # online delay of the online adder


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def select_digit(v: torch.Tensor) -> torch.Tensor:
    """SELM: output digit in {-1, 0, 1} from the (exact) residual estimate."""
    one = torch.ones_like(v)
    return torch.where(v >= 0.5, one,
                       torch.where(v <= -0.5, -one, torch.zeros_like(v)))


def digit_weights(n: int, device=None) -> torch.Tensor:
    """``2**-(j+1)`` for ``j < n``, exact float32 powers of two."""
    return torch.tensor([2.0 ** -(j + 1) for j in range(n)],
                        dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------


def to_digits(x, n: int) -> torch.Tensor:
    """SD radix-2 encode: ``x`` in (-1, 1) -> digits ``(..., n)`` MSDF."""
    w = _f32(x)
    digits = []
    for _ in range(n):
        v = 2.0 * w
        d = select_digit(v)
        w = v - d
        digits.append(d)
    return torch.stack(digits, dim=-1)


def from_digits(d: torch.Tensor) -> torch.Tensor:
    """Decode digit streams ``(..., n)`` back to values."""
    return (d * digit_weights(d.shape[-1], d.device)).sum(-1)


def prefix_values(d: torch.Tensor) -> torch.Tensor:
    """Running prefix value after each digit: ``(..., n)``."""
    return (d * digit_weights(d.shape[-1], d.device)).cumsum(-1)


# ---------------------------------------------------------------------------
# Algorithm 1 — serial-parallel online multiplier
# ---------------------------------------------------------------------------


def _online_recurrence(inputs, delta: int) -> torch.Tensor:
    """Run ``v = 2w + c_t``, select, ``w = v - z`` over the contributions
    ``c_t`` (no selection during the first ``delta`` initialization steps);
    returns the digits after the delay, ``(..., len(inputs) - delta)``."""
    w = torch.zeros_like(inputs[0])
    zs = []
    for t, c in enumerate(inputs):
        v = 2.0 * w + c
        z = select_digit(v) if t >= delta else torch.zeros_like(v)
        w = v - z
        zs.append(z)
    return torch.stack(zs[delta:], dim=-1)


def online_mul_sp(x_digits: torch.Tensor, y, n_out: int) -> torch.Tensor:
    """Serial-parallel online multiplication (Algorithm 1).

    ``x_digits``: (..., n) MSDF digit stream of the serial operand.
    ``y``: (...,) parallel operand, |y| < 1.
    Returns the product's digit stream ``(..., n_out)``; digit ``j`` of the
    output is produced at hardware cycle ``j + DELTA_OLM``.
    """
    total = n_out + DELTA_OLM
    y = _f32(y).to(x_digits.device)
    xs = x_digits.to(torch.float32).movedim(-1, 0)  # (n, ...)
    shape = torch.broadcast_shapes(xs.shape[1:], y.shape)
    scale = 2.0 ** -DELTA_OLM
    zero = torch.zeros(shape, dtype=torch.float32, device=xs.device)
    # (initialization phase, Algorithm 1 lines 1-5: collect delta digits)
    contrib = [
        (xs[t] * y * scale if t < xs.shape[0] else zero).expand(shape)
        for t in range(total)
    ]
    return _online_recurrence(contrib, DELTA_OLM)


# ---------------------------------------------------------------------------
# Online adder
# ---------------------------------------------------------------------------


def online_add(a: torch.Tensor, b: torch.Tensor, *,
               scale_half: bool = True) -> torch.Tensor:
    """Online addition of two MSDF digit streams (delta = 2).

    With ``scale_half`` (default) computes ``(a + b) / 2`` so the output stays
    in (-1, 1) — the simulation's stand-in for the hardware's extra leading
    digit (see module docstring).
    """
    n = a.shape[-1]
    ax, bx = a.movedim(-1, 0), b.movedim(-1, 0)
    shape = torch.broadcast_shapes(ax.shape[1:], bx.shape[1:])
    scale = (0.5 if scale_half else 1.0) * 2.0 ** -DELTA_OLA
    zero = torch.zeros(shape, dtype=torch.float32, device=a.device)
    contrib = [
        ((ax[t] + bx[t]) * scale).expand(shape) if t < n else zero
        for t in range(n + DELTA_OLA)
    ]
    return _online_recurrence(contrib, DELTA_OLA)


# ---------------------------------------------------------------------------
# WPU: sum-of-products via multiplier bank + online adder tree
# ---------------------------------------------------------------------------


def online_sop(x_digits: torch.Tensor, y, n_out: int
               ) -> tuple[torch.Tensor, int]:
    """Window processing unit: SOP of ``m`` serial x parallel products.

    ``x_digits``: (..., m, n) digit streams; ``y``: (..., m) parallel weights.
    Returns ``(digits, depth)`` where ``digits`` is the (..., n_out) MSDF
    stream of ``sop / 2**depth`` and ``depth = ceil(log2 m)`` (the adder-tree
    depth, whose growth cycles Eq. (3) charges explicitly).
    """
    prods = online_mul_sp(x_digits, y, n_out)  # (..., m, n_out)
    streams = [prods[..., i, :] for i in range(prods.shape[-2])]
    depth = 0
    while len(streams) > 1:
        nxt = [online_add(streams[i], streams[i + 1])
               for i in range(0, len(streams) - 1, 2)]
        if len(streams) % 2:
            # odd element passes through scaled by 1/2 to stay aligned
            nxt.append(online_add(streams[-1], torch.zeros_like(streams[-1])))
        streams = nxt
        depth += 1
    return streams[0], depth


def sop_digits_fast(x: torch.Tensor, y: torch.Tensor, n_out: int
                    ) -> tuple[torch.Tensor, int]:
    """Fast path for large-scale END statistics: digit stream of the exact
    SOP value, scaled like :func:`online_sop`'s tree output.

    Any valid SD stream of the same value has prefix error <= 2**-j at digit
    j, so END decisions agree with the composed pipeline to within one digit
    cycle.
    """
    m = x.shape[-1]
    depth = max(1, math.ceil(math.log2(m))) if m > 1 else 0
    val = (_f32(x) * _f32(y)).sum(-1) / (2.0 ** depth)
    return to_digits(val, n_out), depth
