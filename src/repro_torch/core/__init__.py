"""USEFUSE core for the PyTorch port: fusion planning, the tile-program
compiler, the cycle model, and the tile-level executor oracle.

* fusion planning — :mod:`repro_torch.core.fusion` (Eq. (1), Algorithms 3-4)
* tile-program compiler — :mod:`repro_torch.core.program`
* cycle model — :mod:`repro_torch.core.cycle_model` (Eqs. (2)-(4))
* fused execution oracle — :mod:`repro_torch.core.executor`
* device dispatch — :func:`resolve_device`, shared by every entry point
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` (the default everywhere) means the CUDA card, and raises when
    no CUDA device is present: the port never falls back to the CPU on its
    own.  An explicit device (``"cpu"``, ``"cuda:1"``, a ``torch.device``)
    is honoured unchanged, which is how the CPU tests pin the plain
    PyTorch path."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the"
            " plain PyTorch path explicitly"
        )
    return torch.device("cuda")


__all__ = ["resolve_device"]
