"""Plain-PyTorch oracles for the fused pyramid: the monolithic layer-by-layer
execution from :mod:`repro_torch.core.executor` (port of the reference's
``repro.kernels.fused_conv.ref``)."""

from __future__ import annotations

import torch

from repro_torch.core.executor import PyramidParams, reference_forward
from repro_torch.core.fusion import FusionSpec


def fused_pyramid_ref(
    x: torch.Tensor,
    spec: FusionSpec,
    weights: list,
    biases: list,
    *,
    relu: bool = True,
) -> torch.Tensor:
    """Oracle for :func:`~repro_torch.kernels.fused_conv.ops.fused_pyramid`."""
    params = PyramidParams(weights=list(weights), biases=list(biases))
    return reference_forward(x, spec, params, relu=relu)


def fused_conv2_ref(
    x: torch.Tensor,
    spec: FusionSpec,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    relu: bool = True,
) -> torch.Tensor:
    return fused_pyramid_ref(x, spec, [w1, w2], [b1, b2], relu=relu)
