"""Model assembly: param specs and the forward over the layer stack.

The port of the reference's ``repro.models.model`` for the ``ssm`` family
(Mamba-2): every layer is one ``ssm_layer`` over stacked ``(L, ...)``
params.  The reference's ``lax.scan`` over the stack is a Python loop over
the leading dimension; its sharding constraints and remat are gone (one
GPU, no training in the port yet), and so are the ``mode``, ``cache_index``
and ``chunked`` arguments and the aux-loss sum, which no layer of this
family reads or produces: :func:`forward` returns ``(logits, caches)``
where the reference returns ``(logits, aux, caches)``.  Other families,
layernorm and tied embeddings raise ``NotImplementedError``: no ported
config uses them.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import resolve_device

from . import params as prm
from .blocks import ssm_layer
from .layers import rms_norm
from .params import P, stack_specs, tree_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _check_family(cfg: ArchConfig) -> None:
    got = (cfg.family, cfg.kind, cfg.norm, cfg.tie_embeddings)
    if got != ("ssm", "decoder", "rmsnorm", False):
        raise NotImplementedError(
            f"{cfg.name}: (family, kind, norm, tie_embeddings) = {got} is"
            " not ported yet; the port runs the ssm family's decoder with"
            " rmsnorm and an untied head"
        )


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def _layer_specs(cfg: ArchConfig) -> dict:
    """Spec of ONE layer of the main stack (unstacked)."""
    return {
        "norm": P((cfg.d_model,), (None,), "one"),
        "mixer": prm.mamba_specs(cfg),
    }


def build_param_specs(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    d, V = cfg.d_model, cfg.vocab
    return {
        "embed": P((V, d), ("vocab", "embed"), 0.02),
        "final_norm": P((d,), (None,), "one"),
        "lm_head": P((d, V), ("embed", "vocab")),
        "layers": stack_specs(_layer_specs(cfg), cfg.n_layers, "layers"),
    }


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None) -> dict:
    """Random params of ``cfg`` in its dtype, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None`` = the
    CUDA card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return prm.init_tree(build_param_specs(cfg), gen, _dtype(cfg))


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    """Layer ``i`` of a stacked ``(L, ...)`` tree."""
    return tree_map(lambda t: t[i], tree)


def _stack(cfg, x, stacked_params, caches=None):
    """Run the layer stack in order.  ``caches`` (stacked ``(L, B, ...)``)
    are updated in place, layer by layer."""
    for i in range(cfg.n_layers):
        p = _layer(stacked_params, i)
        if caches is None:
            x, _ = ssm_layer(cfg, p, x)
        else:
            x, new_cache = ssm_layer(cfg, p, x, _layer(caches, i))
            for k, v in new_cache.items():
                caches[k][i].copy_(v)
    return x, caches


def _final_norm(cfg, params, x):
    return rms_norm(x, params["final_norm"])


def logits_fn(cfg, params, x):
    return _final_norm(cfg, params, x) @ params["lm_head"]


def hidden_forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
                   caches=None):
    """Forward of ``tokens (B, S)`` returning ``(hidden (B, S, d),
    caches)``: the pre-head hidden states; ``caches``, when given, are
    updated in place (decode, one token per sequence)."""
    _check_family(cfg)
    x = params["embed"][tokens].to(_dtype(cfg))
    return _stack(cfg, x, params["layers"], caches)


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, *, caches=None):
    """Full forward.  Returns ``(logits (B, S, V), caches)``."""
    x, new_caches = hidden_forward(cfg, params, tokens, caches=caches)
    return logits_fn(cfg, params, x), new_caches
