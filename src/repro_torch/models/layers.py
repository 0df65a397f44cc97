"""Normalisation for the port's models.

The port of ``rms_norm`` from the reference's ``repro.models.layers``; the
attention, MLP and RoPE blocks there wait for the families that need them.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """``(x * rsqrt(mean(x^2) + eps)).astype(x.dtype) * scale``, the mean
    in float32: the reference's cast order, so bf16 rounds where it does."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale
