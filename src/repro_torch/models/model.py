"""Model assembly: param specs and the forward over the layer stack.

The port of the reference's ``repro.models.model`` for the decoder
families with RMSNorm and an untied head: ``ssm`` (Mamba-2, one
``ssm_layer`` a layer), ``dense`` (``dense_layer``, GQA or MLA
attention), ``moe`` (``moe_layer``: routed experts with shared experts or
a dense residual MLP) and ``hybrid`` (Hymba: ``hybrid_layer``, attention
and Mamba heads in parallel, run in order-faithful segments of global
full-attention layers and sliding-window layers).  The reference's
``lax.scan`` over a stack of ``(L, ...)`` params is a Python loop over the
leading dimension; its sharding constraints and remat are gone (one GPU,
no training in the port yet), and so is the aux-loss sum, which only
training reads: :func:`forward` returns ``(logits, caches)`` where the
reference returns ``(logits, aux, caches)``.  Caches are updated in place.
Other families (VLM, encoder-decoder), layernorm, GELU and tied embeddings
raise ``NotImplementedError``: no ported config uses them.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import resolve_device

from . import params as prm
from .blocks import LayerCtx, dense_layer, hybrid_layer, moe_layer, ssm_layer
from .layers import rms_norm
from .params import P, stack_specs, tree_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_BODY = {"dense": dense_layer, "moe": moe_layer, "ssm": ssm_layer,
         "hybrid": hybrid_layer}


def _check_family(cfg: ArchConfig) -> None:
    got = (cfg.family, cfg.kind, cfg.norm, cfg.tie_embeddings, cfg.act)
    if (cfg.family not in _BODY or cfg.attn_kind not in ("gqa", "mla")
            or got[1:] != ("decoder", "rmsnorm", False, "swiglu")):
        raise NotImplementedError(
            f"{cfg.name}: (family, kind, norm, tie_embeddings, act) = {got}"
            f" with attn_kind={cfg.attn_kind!r} is not ported yet; the port"
            f" runs the {sorted(_BODY)} families' decoders with rmsnorm,"
            " GQA or MLA attention, SwiGLU and an untied head"
        )


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def _layer_specs(cfg: ArchConfig) -> dict:
    """Spec of ONE layer of the main stack (unstacked)."""
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"norm": P((d,), (None,), "one"),
                "mixer": prm.mamba_specs(cfg)}
    s = {"attn_norm": P((d,), (None,), "one"),
         "attn": (prm.mla_specs(cfg) if cfg.attn_kind == "mla"
                  else prm.gqa_specs(cfg))}
    if cfg.family == "hybrid":
        s["mixer"] = prm.mamba_specs(cfg)
    s["ffn_norm"] = P((d,), (None,), "one")
    if cfg.family == "moe":
        s["moe"] = prm.moe_specs(cfg)
        if cfg.n_shared_experts:
            s["shared"] = prm.swiglu_specs(d, cfg.d_ff)
        if cfg.dense_residual:
            s["dense"] = prm.swiglu_specs(d, cfg.d_ff)
    else:
        s["ffn"] = prm.swiglu_specs(d, cfg.d_ff)
    return s


def _hymba_segments(cfg: ArchConfig):
    """Order-faithful (kind, count) segments: g = global, s = sliding."""
    globals_ = sorted(cfg.global_layers)
    segs, prev = [], 0
    for g in globals_:
        if g > prev:
            segs.append(("s", g - prev))
        segs.append(("g", 1))
        prev = g + 1
    if prev < cfg.n_layers:
        segs.append(("s", cfg.n_layers - prev))
    return segs


def build_param_specs(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    d, V = cfg.d_model, cfg.vocab
    specs = {
        "embed": P((V, d), ("vocab", "embed"), 0.02),
        "final_norm": P((d,), (None,), "one"),
        "lm_head": P((d, V), ("embed", "vocab")),
    }
    layer = _layer_specs(cfg)
    if cfg.family == "hybrid":
        n_g = len(cfg.global_layers)
        specs["global"] = stack_specs(layer, n_g, "layers")
        specs["sliding"] = stack_specs(layer, cfg.n_layers - n_g, "layers")
    else:
        specs["layers"] = stack_specs(layer, cfg.n_layers, "layers")
    return specs


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


def _layers(tree, lo: int, hi: int):
    """Layers ``lo .. hi - 1`` of a stacked ``(L, ...)`` tree, as views."""
    return tree_map(lambda t: t[lo:hi], tree)


def _write_back(cache, new) -> None:
    """Copy a layer's new cache into its slot of the stacked caches; a
    tensor the layer already updated in place is left alone."""
    if isinstance(cache, dict):
        for k in cache:
            _write_back(cache[k], new[k])
    elif new is not cache:
        cache.copy_(new)


def _stack(cfg, body, x, stacked_params, ctx: LayerCtx, caches=None):
    """Run a homogeneous layer stack in order.  ``caches`` (stacked ``(L,
    B, ...)``) are updated in place, layer by layer."""
    for i in range(prm.leaves(stacked_params)[0].shape[0]):
        p = tree_map(lambda t: t[i], stacked_params)
        if caches is None:
            x, _ = body(cfg, p, x, ctx, None)
        else:
            cache = tree_map(lambda t: t[i], caches)
            x, new_cache = body(cfg, p, x, ctx, cache)
            _write_back(cache, new_cache)
    return x


def _hymba_forward(cfg, params, x, ctx: LayerCtx, caches=None):
    """The segments in order: a global layer attends over everything
    (``window = 0``), a sliding segment within ``cfg.window``; each takes
    its own slice of the ``global`` or ``sliding`` stacks and caches."""
    gi = si = 0
    for kind, count in _hymba_segments(cfg):
        if kind == "g":
            part, lo, window = "global", gi, 0
            gi += count
        else:
            part, lo, window = "sliding", si, cfg.window
            si += count
        cache = (None if caches is None
                 else _layers(caches[part], lo, lo + count))
        x = _stack(cfg, hybrid_layer, x, _layers(params[part], lo, lo + count),
                   replace(ctx, window=window), cache)
    return x


def _decoder_forward(cfg, params, x, ctx: LayerCtx, caches=None):
    """Run the decoder stack; returns the hidden states."""
    if cfg.family == "hybrid":
        return _hymba_forward(cfg, params, x, ctx, caches)
    return _stack(cfg, _BODY[cfg.family], x, params["layers"], ctx, caches)


def _final_norm(cfg, params, x):
    return rms_norm(x, params["final_norm"])


def logits_fn(cfg, params, x):
    return _final_norm(cfg, params, x) @ params["lm_head"]


def hidden_forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
                   mode: str = "train", chunked: bool | None = None,
                   caches=None, cache_index=None):
    """Forward of ``tokens (B, S)`` returning ``(hidden (B, S, d),
    caches)``: the pre-head hidden states.  ``chunked`` (flash-chunked
    attention) defaults to ``S > 2048`` and is off whenever ``caches`` are
    given; ``caches``, when given, are updated in place with the tokens at
    positions ``cache_index ..`` (decode)."""
    _check_family(cfg)
    x = params["embed"][tokens].to(_dtype(cfg))
    if chunked is None:
        chunked = tokens.shape[1] > 2048
    ctx = LayerCtx(mode=mode, cache_index=cache_index,
                   chunked=chunked and caches is None, causal=True, window=0)
    return _decoder_forward(cfg, params, x, ctx, caches), caches


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            mode: str = "train", chunked: bool | None = None, caches=None,
            cache_index=None):
    """Full forward.  Returns ``(logits (B, S, V), caches)``."""
    x, new_caches = hidden_forward(cfg, params, tokens, mode=mode,
                                   chunked=chunked, caches=caches,
                                   cache_index=cache_index)
    return logits_fn(cfg, params, x), new_caches
