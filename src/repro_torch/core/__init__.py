"""USEFUSE core for the PyTorch port: fusion planning, the tile-program
compiler, the cycle model, and the tile-level executor oracle.

* fusion planning — :mod:`repro_torch.core.fusion` (Eq. (1), Algorithms 3-4)
* tile-program compiler — :mod:`repro_torch.core.program`
* cycle model — :mod:`repro_torch.core.cycle_model` (Eqs. (2)-(4))
* online arithmetic — :mod:`repro_torch.core.online_arith` (Algorithm 1)
* early negative detection — :mod:`repro_torch.core.end_detect`
  (Algorithm 2)
* fused execution oracle — :mod:`repro_torch.core.executor`
* device dispatch — :func:`resolve_device`, shared by every entry point

The public names are the reference's ``repro.core`` API, with
:func:`resolve_device` in the place of its ``resolve_interpret``.
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


# the submodules import ``resolve_device`` from this package, so it is
# defined above before any of them loads
from .cycle_model import ArithParams, DesignResult, evaluate_design  # noqa: E402
from .end_detect import EndStats, end_scan, end_statistics  # noqa: E402
from .executor import (  # noqa: E402
    PyramidParams,
    fused_forward,
    init_pyramid_params,
    reference_forward,
)
from .fusion import (  # noqa: E402
    FusedLevel,
    FusionPlan,
    FusionSpec,
    LockstepPlan,
    lockstep_plan,
    plan_fusion,
    receptive_window,
    tile_sizes,
    uniform_tile_stride,
)
from .online_arith import (  # noqa: E402
    from_digits,
    online_add,
    online_mul_sp,
    online_sop,
    sop_digits_fast,
    to_digits,
)
from .program import (  # noqa: E402
    ConvLevelProg,
    LevelWindow,
    TileProgram,
    WindowProgram,
    compile_program,
    compile_windows,
    pick_out_region,
)

__all__ = [
    "ArithParams",
    "ConvLevelProg",
    "DesignResult",
    "EndStats",
    "LevelWindow",
    "TileProgram",
    "WindowProgram",
    "compile_program",
    "compile_windows",
    "pick_out_region",
    "FusedLevel",
    "FusionPlan",
    "FusionSpec",
    "LockstepPlan",
    "PyramidParams",
    "end_scan",
    "end_statistics",
    "evaluate_design",
    "from_digits",
    "fused_forward",
    "init_pyramid_params",
    "lockstep_plan",
    "online_add",
    "online_mul_sp",
    "online_sop",
    "plan_fusion",
    "receptive_window",
    "reference_forward",
    "resolve_device",
    "sop_digits_fast",
    "tile_sizes",
    "to_digits",
    "uniform_tile_stride",
]
