"""Plain-tensor oracle for the SSD chunk-scan kernel: the token-by-token
state-space recurrence, independent of the chunked decomposition.

The port of the reference's ``repro.kernels.ssd_scan.ref``; its
``lax.scan`` is a Python loop over the sequence.
"""

from __future__ import annotations

import torch


def ssd_ref(x, dt, A, B, C, D) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSM recurrence.

    x: (b,S,H,P); dt: (b,S,H) post-softplus; A: (H,) negative;
    B/C: (b,S,N); D: (H,).  Returns (y (b,S,H,P), final_state (b,H,P,N)).
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A[None, :])  # (b,H)
        xb = x[:, t] * dt[:, t, :, None]
        state = state * dA[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xb, B[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t])
                  + x[:, t] * D[None, :, None])
    return torch.stack(ys, dim=1), state
