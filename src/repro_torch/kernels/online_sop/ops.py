"""Public wrapper for the digit-serial SOP + END kernel.

The port of the reference's ``repro.kernels.online_sop.ops``: flattens
arbitrary batch dims, casts to float32 and dispatches to
:func:`~repro_torch.kernels.online_sop.online_sop.online_sop_end_kernel`
(the CUDA kernel on a CUDA tensor, its plain version on a CPU tensor).  A
``(F, m)`` ``y`` is the reference's ``jax.vmap`` over filters (``in_axes=0,
out_axes=-1``) written out: one launch, outputs ``(..., F)`` like the NHWC
convolution.  The reference's pad of ``m`` to 128 lanes is a TPU layout
detail that changes no result, so it is gone.
"""

from __future__ import annotations

import torch

from .online_sop import online_sop_end_kernel


def online_sop_end(
    x: torch.Tensor, y: torch.Tensor, n_digits: int = 16
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Digit-serial SOP + END over arbitrary batch dims.

    ``x``: (..., m) serial operands in (-1, 1); ``y``: (m,) parallel weights,
    or (F, m), one filter a row.  Returns (sop, term_cycle, detected), each
    (...,) for a (m,) ``y`` and (..., F) for a (F, m) one.
    """
    batch_shape = x.shape[:-1] + y.shape[:-1]
    m = x.shape[-1]
    xf = x.reshape(-1, m).to(torch.float32).contiguous()
    yf = y.to(torch.float32).contiguous()
    sop, cyc, det = online_sop_end_kernel(xf, yf, n_digits)
    return (
        sop.reshape(batch_shape),
        cyc.reshape(batch_shape),
        det.reshape(batch_shape),
    )
