"""Public wrapper for the SSD chunk-scan kernel.

The port of the reference's ``repro.kernels.ssd_scan.ops``: pads the
sequence with trailing zeros to a uniform chunk grid (causal, so the pad
never leaks backward; its ``dt = 0`` adds nothing to the state and decays
nothing, so the final state is exact) and exposes the signature of
:func:`repro_torch.models.ssm.ssd_chunked`, which is how
``mamba2_mixer`` runs its prefill through the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ssd_scan import ssd_scan_kernel


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 64
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD over ``x (b,S,H,P)``; pads S to a multiple of ``min(chunk, S)``
    and cuts ``y`` back to S.  Returns ``(y (b,S,H,P), state (b,H,P,N))``:
    the CUDA kernel on CUDA tensors, its plain version on CPU tensors."""
    S = x.shape[1]
    ch = min(chunk, S)
    pad = (-S) % ch
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y, state = ssd_scan_kernel(x, dt, A, B, C, D, chunk=ch)
    return y[:, :S], state
