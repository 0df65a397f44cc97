"""Public wrapper for the SSD chunk-scan kernel.

The port of the reference's ``repro.kernels.ssd_scan.ops``: pads the
sequence with trailing zeros to a uniform chunk grid (causal, so the pad
never leaks backward; its ``dt = 0`` adds nothing to the state and decays
nothing, so the final state is exact) and exposes the signature of
:func:`repro_torch.models.ssm.ssd_chunked`, which is how
``mamba2_mixer`` runs its prefill through the kernel.

The kernel runs inside :class:`SsdScan`, a ``torch.autograd.Function``, so
that a training step differentiates through it.  Its forward is
:func:`~.ssd_scan.ssd_scan_kernel` and its backward
:func:`~.ssd_scan.ssd_scan_bwd_kernel`: on the card the CUDA launches of
kernel D and of its backward kernel, on the CPU their plain versions.  A
failed build or launch raises, in either direction; nothing falls back to
a plain version on the card.  When no input wants a gradient, autograd
records nothing and keeps nothing.

:func:`ssd_scan_vjp` (autograd through the plain forward) is the oracle
the tests and ``chip_smoke.py`` hold the backward against; no path of the
port calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ssd_scan import ssd_scan_bwd_kernel, ssd_scan_kernel, ssd_scan_plain


def ssd_scan_vjp(inputs, chunk: int, needs, gy, gstate):
    """Gradients of ``ssd_scan_plain(*inputs, chunk=chunk)`` for the inputs
    flagged in ``needs`` (``None`` for the others) against the upstream
    gradients ``gy`` of ``y`` and ``gstate`` of the final state (either may
    be ``None``: that output did not reach the loss)."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        y, state = ssd_scan_plain(*args, chunk=chunk)
        outs = [(o, g) for o, g in ((y, gy), (state, gstate)) if g is not None]
        wrt = [a for a in args if a.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in outs], wrt,
                                         [g for _, g in outs],
                                         allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)


class SsdScan(torch.autograd.Function):
    """Kernel D and its backward kernel: ``apply(x, dt, A, B, C, D,
    chunk)`` -> ``(y, state)`` as :func:`~.ssd_scan.ssd_scan_kernel`."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B, C, D)
        return ssd_scan_kernel(x, dt, A, B, C, D, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        if gy is None and gstate is None:
            return (None,) * 7
        inputs = ctx.saved_tensors
        grads = ssd_scan_bwd_kernel(*inputs, gy, gstate, chunk=ctx.chunk)
        return (*(g.to(t.dtype) if n else None for g, t, n in
                  zip(grads, inputs, ctx.needs_input_grad)), None)


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 64
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD over ``x (b,S,H,P)``; pads S to a multiple of ``min(chunk, S)``
    and cuts ``y`` back to S.  Returns ``(y (b,S,H,P), state (b,H,P,N))``:
    the CUDA kernel on CUDA tensors, its plain version on CPU tensors,
    differentiable in every input through :class:`SsdScan`."""
    S = x.shape[1]
    ch = min(chunk, S)
    pad = (-S) % ch
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y, state = SsdScan.apply(x, dt, A, B, C, D, ch)
    return y[:, :S], state
