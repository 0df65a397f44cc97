"""Model assembly: param specs and the forward over the layer stack.

The port of the reference's ``repro.models.model`` for every family:
``ssm`` (Mamba-2, one ``ssm_layer`` a layer), ``dense`` (``dense_layer``,
GQA or MLA attention), ``moe`` (``moe_layer``: routed experts with shared
experts or a dense residual MLP), ``hybrid`` (Hymba: ``hybrid_layer``,
attention and Mamba heads in parallel, run in order-faithful segments of
global full-attention layers and sliding-window layers), ``vlm``
(Llama-3.2-Vision: groups of ``cross_every - 1`` dense layers, each group
closed by a gated ``cross_attn_block`` over the vision stub) and the
encoder-decoder ``audio`` family (Whisper: a non-causal encoder over the
frame stub, then decoder layers of self- and cross-attention), with
RMSNorm or LayerNorm, SwiGLU or GELU, and an untied or tied head.  The
reference's ``lax.scan`` over a stack of ``(L, ...)`` params is a Python
loop over the leading dimension; its sharding constraints (the identity on
one device) and remat are gone (no training in the port yet), and so is
the aux-loss sum, which only training reads: :func:`forward` returns
``(logits, caches)`` where the reference returns ``(logits, aux,
caches)``.  Caches are updated in place.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import resolve_device

from . import params as prm
from .blocks import (
    LayerCtx,
    cross_attn_block,
    dense_layer,
    hybrid_layer,
    moe_layer,
    ssm_layer,
)
from .layers import layer_norm, rms_norm
from .params import P, stack_specs, tree_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_BODY = {"dense": dense_layer, "moe": moe_layer, "ssm": ssm_layer,
         "hybrid": hybrid_layer, "vlm": dense_layer, "audio": dense_layer}
# each config field the forward branches on, and the values it knows
_CHOICES = {"family": tuple(_BODY), "attn_kind": ("gqa", "mla"),
            "kind": ("decoder", "encdec"), "norm": ("rmsnorm", "layernorm"),
            "act": ("swiglu", "gelu")}


def _check_family(cfg: ArchConfig) -> None:
    """Refuse a config field value the forward has no branch for, and a
    VLM whose layers do not split into cross groups."""
    for field, known in _CHOICES.items():
        if getattr(cfg, field) not in known:
            raise ValueError(f"{cfg.name}: {field}={getattr(cfg, field)!r};"
                             f" known: {known}")
    if cfg.family == "vlm" and (cfg.cross_every < 1
                                or cfg.n_layers % cfg.cross_every):
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a"
                         f" multiple of cross_every={cfg.cross_every}")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def _norm_specs(cfg, name):
    s = {name: P((cfg.d_model,), (None,), "one")}
    if cfg.norm == "layernorm":
        s[name + "_b"] = P((cfg.d_model,), (None,), "zero")
    return s


def _layer_specs(cfg: ArchConfig) -> dict:
    """Spec of ONE layer of the main stack (unstacked)."""
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"norm": P((d,), (None,), "one"),
                "mixer": prm.mamba_specs(cfg)}
    s = {**_norm_specs(cfg, "attn_norm"),
         "attn": (prm.mla_specs(cfg) if cfg.attn_kind == "mla"
                  else prm.gqa_specs(cfg))}
    if cfg.family == "hybrid":
        s["mixer"] = prm.mamba_specs(cfg)
    s.update(_norm_specs(cfg, "ffn_norm"))
    if cfg.family == "moe":
        s["moe"] = prm.moe_specs(cfg)
        if cfg.n_shared_experts:
            s["shared"] = prm.swiglu_specs(d, cfg.d_ff)
        if cfg.dense_residual:
            s["dense"] = prm.swiglu_specs(d, cfg.d_ff)
    else:
        s["ffn"] = (prm.gelu_mlp_specs(d, cfg.d_ff) if cfg.act == "gelu"
                    else prm.swiglu_specs(d, cfg.d_ff))
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
    specs = {"embed": P((V, d), ("vocab", "embed"), 0.02),
             **_norm_specs(cfg, "final_norm")}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P((d, V), ("embed", "vocab"))
    layer = _layer_specs(cfg)
    if cfg.family == "vlm":
        # n_layers = n_cross groups of (cross_every - 1) self layers and
        # one gated cross layer (llama-3.2-vision: 40 = 8 x (4 + 1))
        n_cross = cfg.n_layers // cfg.cross_every
        specs["layers"] = stack_specs(
            stack_specs(layer, cfg.cross_every - 1, "layers"), n_cross,
            "layers")
        specs["cross"] = stack_specs(prm.cross_attn_specs(cfg), n_cross,
                                     "layers")
    elif cfg.family == "hybrid":
        n_g = len(cfg.global_layers)
        specs["global"] = stack_specs(layer, n_g, "layers")
        specs["sliding"] = stack_specs(layer, cfg.n_layers - n_g, "layers")
    else:
        specs["layers"] = stack_specs(layer, cfg.n_layers, "layers")
    if cfg.kind == "encdec":
        enc_layer = {
            **_norm_specs(cfg, "attn_norm"),
            "attn": prm.gqa_specs(cfg),
            **_norm_specs(cfg, "ffn_norm"),
            "ffn": prm.gelu_mlp_specs(d, cfg.d_ff),
        }
        specs["encoder"] = stack_specs(enc_layer, cfg.enc_layers, "layers")
        cross = prm.cross_attn_specs(cfg)
        cross.pop("gate")  # whisper's cross-attention is ungated
        specs["cross"] = stack_specs(cross, cfg.n_layers, "layers")
        specs.update(_norm_specs(cfg, "enc_final_norm"))
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


def _vlm_forward(cfg, params, x, ctx: LayerCtx, caches=None):
    """Each group's ``cross_every - 1`` self layers, then its gated cross
    layer over ``ctx.vision`` (or, in decode, over the group's cross
    cache, which passes through unchanged).  The nested self caches
    ``(n_cross, cross_every - 1, B, ...)`` are updated in place."""
    for gi in range(cfg.n_layers // cfg.cross_every):
        cache = (None if caches is None
                 else tree_map(lambda t: t[gi], caches["self"]))
        x = _stack(cfg, dense_layer, x,
                   tree_map(lambda t: t[gi], params["layers"]), ctx, cache)
        cross = (None if caches is None
                 else tree_map(lambda t: t[gi], caches["cross"]))
        x = cross_attn_block(cfg, tree_map(lambda t: t[gi], params["cross"]),
                             x, ctx.vision, ctx, cross)
    return x


def _whisper_encoder(cfg, params, frames):
    """Encoder over stub frame embeddings ``(B, enc_seq, d)``: dense,
    non-causal and unchunked attention (with RoPE, as the reference's),
    then the final LayerNorm."""
    ctx = LayerCtx(mode="train", causal=False)
    x = _stack(cfg, dense_layer, frames, params["encoder"], ctx)
    return layer_norm(x, params["enc_final_norm"], params["enc_final_norm_b"])


def _whisper_decoder(cfg, params, x, ctx: LayerCtx, caches=None):
    """Decoder: per layer self-attention (its cache updated in place),
    then ungated cross-attention to ``ctx.encoder_out`` or, in decode, to
    the layer's cross cache."""
    for i in range(cfg.n_layers):
        p = tree_map(lambda t: t[i], params["layers"])
        cp = tree_map(lambda t: t[i], params["cross"])
        if caches is None:
            x, _ = dense_layer(cfg, p, x, ctx, None)
            x = cross_attn_block(cfg, cp, x, ctx.encoder_out, ctx, None)
        else:
            cache = tree_map(lambda t: t[i], caches["self"])
            x, new_cache = dense_layer(cfg, p, x, ctx, cache)
            _write_back(cache, new_cache)
            x = cross_attn_block(cfg, cp, x, ctx.encoder_out, ctx,
                                 tree_map(lambda t: t[i], caches["cross"]))
    return x


def _decoder_forward(cfg, params, x, ctx: LayerCtx, caches=None):
    """Run the decoder stack; returns the hidden states."""
    if cfg.family == "vlm":
        return _vlm_forward(cfg, params, x, ctx, caches)
    if cfg.family == "hybrid":
        return _hymba_forward(cfg, params, x, ctx, caches)
    if cfg.kind == "encdec":
        return _whisper_decoder(cfg, params, x, ctx, caches)
    return _stack(cfg, _BODY[cfg.family], x, params["layers"], ctx, caches)


def _final_norm(cfg, params, x):
    if cfg.norm == "layernorm":
        return layer_norm(x, params["final_norm"], params["final_norm_b"])
    return rms_norm(x, params["final_norm"])


def logits_fn(cfg, params, x):
    x = _final_norm(cfg, params, x)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return x @ params["lm_head"]


def stub_input(cfg: ArchConfig, t):
    """A stub input (vision patches or audio frames) promoted once to the
    model's dtype.  The reference makes its stubs in bf16 even for f32
    models: ``jnp.einsum`` promotes a bf16 vision stub against the f32
    weights (the same values as this cast), where torch's einsums raise.
    (Its Whisper encoder refuses bf16 frames at f32: its layer scan's
    carry would change dtype.)  A stub wider than the model's dtype is
    refused: ``jnp`` would carry the rest of the model at the stub's
    precision."""
    if t is None:
        return None
    dt = _dtype(cfg)
    if torch.promote_types(t.dtype, dt) != dt:
        raise ValueError(f"{cfg.name}: a {t.dtype} stub input into a {dt}"
                         " model; pass it in the model's dtype or narrower")
    return t.to(dt)


def hidden_forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
                   mode: str = "train", chunked: bool | None = None,
                   vision=None, frames=None, caches=None, cache_index=None):
    """Forward of ``tokens (B, S)`` returning ``(hidden (B, S, d),
    caches)``: the pre-head hidden states.  ``chunked`` (flash-chunked
    attention) defaults to ``S > 2048`` and is off whenever ``caches`` are
    given; ``caches``, when given, are updated in place with the tokens at
    positions ``cache_index ..`` (decode).  ``vision (B, vis_seq, d)``
    feeds a VLM's cross layers unless ``caches`` hold its projections;
    ``frames (B, enc_seq, d)`` run Whisper's encoder, whose states feed the
    cross layers (decode passes none: the cross caches hold their
    projections).  Both stubs are promoted to the model's dtype
    (:func:`stub_input`)."""
    _check_family(cfg)
    x = params["embed"][tokens].to(_dtype(cfg))
    if chunked is None:
        chunked = tokens.shape[1] > 2048
    vision = stub_input(cfg, vision)
    encoder_out = None
    if cfg.kind == "encdec" and frames is not None:
        encoder_out = _whisper_encoder(cfg, params, stub_input(cfg, frames))
    ctx = LayerCtx(mode=mode, cache_index=cache_index,
                   chunked=chunked and caches is None, causal=True, window=0,
                   vision=vision, encoder_out=encoder_out)
    return _decoder_forward(cfg, params, x, ctx, caches), caches


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            mode: str = "train", chunked: bool | None = None, vision=None,
            frames=None, caches=None, cache_index=None):
    """Full forward.  Returns ``(logits (B, S, V), caches)``."""
    x, new_caches = hidden_forward(cfg, params, tokens, mode=mode,
                                   chunked=chunked, vision=vision,
                                   frames=frames, caches=caches,
                                   cache_index=cache_index)
    return logits_fn(cfg, params, x), new_caches
