"""Serving substrate: cache specs, init, and the decode step.

The port of the reference's ``repro.models.serving`` for the SSM family,
whose cache is ``conv (L, B, K-1, conv_ch)`` + ``state (L, B, H, P, N)``,
O(1) in the sequence length.  Caches are declared with the same
:class:`~repro_torch.models.params.P` specs as parameters and made in the
config's dtype, as the reference makes them: in bf16 runs the SSM state
rides in bf16 between tokens and ``ssd_decode_step`` computes its output
from a float32 copy each token.

:func:`decode_step` consumes one token per sequence and updates the caches
**in place** (the reference returns new ones).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import resolve_device

from .model import _check_family, _dtype, forward
from .params import P, tree_map


def _ssm_cache(cfg, L, B) -> dict:
    di = cfg.ssm_heads * cfg.ssm_head_dim
    conv_ch = di + 2 * cfg.ssm_state
    return {
        "conv": P((L, B, cfg.ssm_conv - 1, conv_ch),
                  ("layers", "batch", None, "mlp"), "zero"),
        "state": P(
            (L, B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            ("layers", "batch", "heads", None, None),
            "zero",
        ),
    }


def build_cache_specs(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The cache specs of ``batch`` sequences of up to ``max_seq`` tokens
    (an SSM cache does not depend on ``max_seq``)."""
    _check_family(cfg)
    return _ssm_cache(cfg, cfg.n_layers, batch)


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, *, device=None):
    """Zero caches in the config's dtype on ``device`` (``None`` = the
    CUDA card)."""
    dev = resolve_device(device)
    return tree_map(
        lambda p: torch.zeros(p.shape, dtype=_dtype(cfg), device=dev),
        build_cache_specs(cfg, batch, max_seq),
    )


def decode_step(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,  # (B, 1)
    caches,
    cache_index,  # position of the token (unused by the SSM family)
):
    """One serving step: the next-token logits ``(B, V)`` and the caches,
    updated in place."""
    logits, caches = forward(cfg, params, tokens, caches=caches)
    return logits[:, -1, :], caches
