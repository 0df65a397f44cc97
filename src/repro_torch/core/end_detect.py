"""Early Negative Detection (END) — paper §3.2, Algorithm 2.

The port of the reference package's ``repro.core.end_detect``.

The END unit watches the MSDF digit stream of a SOP headed into a ReLU.  In
redundant form the prefix after ``j`` digits is ``N_j = sum_k d_k 2**(j-k)``
(an integer in units of ``2**-j``, equal to ``Z+ - Z-`` of the paper's
positive/negative bit registers).  The remaining tail can add at most
``2**-j - 2**-T < 2**-j``, so

    ``N_j <= -1``  (the paper's ``Z+ < Z-`` comparison)

proves the final SOP is strictly negative: the computation is terminated and
ReLU outputs zero — bit-exact, no accuracy loss.  Activations that are
negative but never trip the test within the digit budget are the paper's
"undetermined" residue (its Fig. 12 reports ~2.1-2.4%); they fall through to
full-length computation.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_CLAMP = 2 ** 24  # the latched prefix is clamped so int32 never overflows


def end_scan(digits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run Algorithm 2 over digit streams ``(..., T)``.

    Returns ``(detected, cycle)``: ``detected`` bool — the negative-detect
    condition fired; ``cycle`` int32 — 1-based digit index at which it fired
    (== T when it never fired; that stream runs to completion).
    """
    T = digits.shape[-1]
    d = digits.movedim(-1, 0).to(torch.int32)  # (T, ...)
    batch, dev = d.shape[1:], digits.device
    n_prefix = torch.zeros(batch, dtype=torch.int32, device=dev)
    det = torch.zeros(batch, dtype=torch.bool, device=dev)
    cyc = torch.full(batch, T, dtype=torch.int32, device=dev)
    for j in range(T):
        n_prefix = 2 * n_prefix + d[j]
        hit = (n_prefix <= -1) & ~det
        det = det | hit
        cyc = torch.where(hit, j + 1, cyc)
        n_prefix = n_prefix.clamp(-_CLAMP, _CLAMP)
    return det, cyc


@dataclass(frozen=True)
class EndStats:
    """Aggregate END statistics for a batch of SOP streams (Figs. 12-14)."""

    total: int
    negative: int  # truly negative final SOPs
    detected: int  # flagged early by Algorithm 2
    undetermined: int  # negative but never flagged within the digit budget
    mean_detect_cycle: float  # mean firing digit among detected
    cycles_no_end: int  # total digit cycles without END
    cycles_with_end: int  # total digit cycles with END termination

    @property
    def detected_frac(self) -> float:
        return self.detected / max(self.total, 1)

    @property
    def undetermined_frac(self) -> float:
        return self.undetermined / max(self.total, 1)

    @property
    def cycle_savings(self) -> float:
        return 1.0 - self.cycles_with_end / max(self.cycles_no_end, 1)


def end_statistics(digits: torch.Tensor, values) -> EndStats:
    """Evaluate END over streams with known exact values."""
    det, cyc = end_scan(digits)
    det = det.cpu().numpy().reshape(-1)
    cyc = cyc.cpu().numpy().reshape(-1)
    vals = torch.as_tensor(values).cpu().numpy().reshape(-1)
    T = digits.shape[-1]
    neg = vals < 0
    undet = neg & ~det
    total = vals.size
    eff = cyc.copy()
    eff[~det] = T
    return EndStats(
        total=int(total),
        negative=int(neg.sum()),
        detected=int(det.sum()),
        undetermined=int(undet.sum()),
        mean_detect_cycle=float(cyc[det].mean()) if det.any() else float(T),
        cycles_no_end=int(total * T),
        cycles_with_end=int(eff.sum()),
    )
