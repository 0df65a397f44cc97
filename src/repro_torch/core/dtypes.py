"""The single source of per-value byte widths and compute dtypes.

Mirrors the reference package's ``repro.core.dtypes`` with torch dtypes in
place of jnp ones.  Every byte model — :class:`~repro_torch.core.program.
TileProgram`'s budget/HBM accounting and the DMA terms of
:meth:`~repro_torch.core.program.LaunchPlan.modeled_cycles` — derives its
``bytes_per_val`` from :data:`DTYPE_BYTES`.

Dtypes are carried as canonical *name strings* (``"float32"``,
``"bfloat16"``, ``"int8"``) so programs and plans stay frozen hashable
dataclasses; :func:`torch_dtype` recovers the torch dtype at launch time.

``int8`` is modeled (byte accounting, throughput) but not executable by the
fused kernels; see :data:`EXEC_DTYPES`.
"""

from __future__ import annotations

import numpy as np
import torch

# bytes per value of every dtype the byte models understand
DTYPE_BYTES: dict[str, int] = {
    "float32": 4,
    "bfloat16": 2,
    "int8": 1,
    "int32": 4,
}

# dtypes the fused kernels can actually run (bf16 operands accumulate in f32)
EXEC_DTYPES: tuple[str, ...] = ("float32", "bfloat16")

# relative matrix-unit throughput vs float32 used by the reference's cycle
# model (kept identical so modeled cycles, and hence plans, match)
MXU_THROUGHPUT: dict[str, int] = {
    "float32": 1,
    "bfloat16": 2,
    "int8": 4,
}

# working precision in bits — the trailing digit-stream term of Eq. (3)
DTYPE_BITS: dict[str, int] = {k: 8 * v for k, v in DTYPE_BYTES.items()}

_TORCH_DTYPES: dict[str, torch.dtype] = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int32": torch.int32,
}
_TORCH_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def canonical_dtype(dtype) -> str:
    """Canonical name string of ``dtype`` (name, torch dtype, or numpy
    dtype).

    Raises ``KeyError`` with the known table on anything the byte models
    don't understand, so a typo'd dtype fails at plan time, not mid-kernel.
    """
    if isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = _TORCH_NAMES.get(dtype, str(dtype))
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = str(dtype)
    if name not in DTYPE_BYTES:
        raise KeyError(
            f"unknown compute dtype {name!r}; known: {sorted(DTYPE_BYTES)}"
        )
    return name


def dtype_bytes(dtype) -> int:
    """Bytes per value, via :data:`DTYPE_BYTES`."""
    return DTYPE_BYTES[canonical_dtype(dtype)]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for a canonical name (launch side of the
    name-string convention)."""
    return _TORCH_DTYPES[canonical_dtype(dtype)]


def mxu_throughput(dtype) -> int:
    """Relative matrix-unit throughput factor vs float32 (>= 1)."""
    return MXU_THROUGHPUT[canonical_dtype(dtype)]
