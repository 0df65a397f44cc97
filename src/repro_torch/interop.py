"""Carry the reference package's params into the port.

The reference (JAX) and the port share layouts — HWIO ``(K, K, Cin, Cout)``
conv weights, ``(fan_in, n_out)`` dense weights and ``(Cout,)`` biases, and
the language models' stacked ``(L, ...)`` layer params and ``(L, B, ...)``
caches — so the same numbers give the same function in both.  These
helpers take the reference's params as numpy arrays (``np.asarray`` of each
leaf; any array-like works) and return the port's tensors.  Nothing here imports
JAX: the caller converts on its side.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.core.executor import PyramidParams


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, which torch cannot read
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


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


def lm_params_from_numpy(tree: dict, device=None) -> dict:
    """A language model's param tree (nested dicts of numpy-convertible
    arrays, as ``jax.tree.map(np.asarray, params)`` gives them, bfloat16
    included) -> the same tree of tensors with equal values on ``device``
    (``None`` = the CUDA card).  Caches (nested dicts of arrays too) take
    the same path."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _tensor(t, dev)

    return walk(tree)
