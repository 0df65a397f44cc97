"""Carry the reference package's params into the port.

The reference (JAX) and the port share layouts — HWIO ``(K, K, Cin, Cout)``
conv weights, ``(fan_in, n_out)`` dense weights and ``(Cout,)`` biases — so
the same numbers give the same function in both.  These helpers take the
reference's params as numpy arrays (``np.asarray`` of each leaf; any
array-like works) and return the port's tensors.  Nothing here imports
JAX: the caller converts on its side.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.core.executor import PyramidParams


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(params: dict, *, device=None) -> dict:
    """``{node: (w, b)}`` (or ``{key: array}`` for pre-flattened ``_flat/``
    entries) of numpy-convertible arrays -> the same dict of tensors on
    ``device`` (``None`` = the CUDA card)."""
    dev = resolve_device(device)
    out = {}
    for k, v in params.items():
        if isinstance(v, (tuple, list)):
            out[k] = tuple(_tensor(a, dev) for a in v)
        else:
            out[k] = _tensor(v, dev)
    return out


def pyramid_params_from_numpy(params, *, device=None) -> PyramidParams:
    """Anything with ``weights`` and ``biases`` lists (the reference's
    ``PyramidParams``) -> the port's :class:`PyramidParams` on ``device``."""
    dev = resolve_device(device)
    return PyramidParams(
        weights=[_tensor(w, dev) for w in params.weights],
        biases=[_tensor(b, dev) for b in params.biases],
    )
