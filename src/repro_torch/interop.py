"""Carry the reference package's params and optimizer states into the port.

The reference (JAX) and the port share layouts — HWIO ``(K, K, Cin, Cout)``
conv weights, ``(fan_in, n_out)`` dense weights and ``(Cout,)`` biases, the
language models' stacked ``(L, ...)`` layer params and ``(L, B, ...)``
caches, and AdamW's moments in the params' tree — so the same numbers give
the same function in both.  These helpers take the reference's trees as
numpy arrays (``np.asarray`` of each leaf; any array-like works) and return
the port's tensors.  Nothing here imports JAX: the caller converts on its
side.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import resolve_device
from repro_torch.core.executor import PyramidParams
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.grad_compress import CompressState


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


def adamw_state_from_numpy(state, device=None) -> AdamWState:
    """The reference's ``AdamWState`` (``step``, ``mu``, ``nu``), its
    leaves numpy-convertible (``jax.tree.map(np.asarray, state)``) -> the
    port's :class:`~repro_torch.optim.adamw.AdamWState` on ``device``
    (``None`` = the CUDA card), moments in their own dtype."""
    return AdamWState(step=_tensor(state.step, resolve_device(device)),
                      mu=lm_params_from_numpy(state.mu, device),
                      nu=lm_params_from_numpy(state.nu, device))


def compress_state_from_numpy(state, device=None) -> CompressState:
    """The reference's ``CompressState`` (the bf16 error-feedback tree) ->
    the port's :class:`~repro_torch.optim.grad_compress.CompressState`."""
    return CompressState(error=lm_params_from_numpy(state.error, device))
