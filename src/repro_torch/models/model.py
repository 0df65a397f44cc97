"""Model assembly: param specs, the forward over the layer stack, the loss.

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
loop over the leading dimension.  Its three sharding constraints stay
(:func:`repro_torch.parallel.constraints.constrain`: the residual stream
at each layer, the loss's hidden states and logits); they are the
identity unless a mesh is registered and the tensors are DTensors.  :func:`forward` and :func:`hidden_forward` return
``(out, caches)`` where the reference returns ``(out, aux, caches)``: the
layers' summed aux loss reaches :func:`lm_loss` through the helper they
share (:func:`_forward_aux`).  Caches are updated in place.

Training: :func:`lm_loss` is the next-token cross-entropy by
:func:`chunked_ce`, which never keeps the ``(B, S, V)`` logits for the
backward, plus the MoE aux.  ``cfg.remat`` recomputes each layer in the
backward as the reference's ``jax.checkpoint`` does: ``full`` keeps only
the layer's inputs (``torch.utils.checkpoint``), ``dots`` also keeps its
matmul outputs (a selective-checkpoint policy, the reference's
``checkpoint_dots``).  Remat applies where autograd records a forward
without caches: some param or input requires grad.
"""

from __future__ import annotations

import functools
from dataclasses import replace

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.core import resolve_device
from repro_torch.parallel.constraints import constrain
from repro_torch.parallel.spmd import take_rows

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
            "act": ("swiglu", "gelu"), "remat": ("none", "full", "dots")}


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


def abstract_params(cfg: ArchConfig) -> dict:
    """``cfg``'s params as ``device="meta"`` tensors (nothing allocated)."""
    return prm.abstract_tree(build_param_specs(cfg), _dtype(cfg))


def param_axes(cfg: ArchConfig) -> dict:
    """The logical axes of every param leaf (same structure)."""
    return prm.axes_tree(build_param_specs(cfg))


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layers(tree, lo: int, hi: int):
    """Layers ``lo .. hi - 1`` of a stacked ``(L, ...)`` tree, as views."""
    return tree_map(lambda t: t[lo:hi], tree)


def _unstack(tree) -> list:
    """A stacked ``(L, ...)`` tree as ``L`` per-layer trees of views.  One
    ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where indexing layer by layer would add a zero-padded ``(L, ...)``
    gradient per layer."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    n = len(prm.leaves(parts)[0])
    return [tree_map(lambda ts, i=i: ts[i], parts) for i in range(n)]


def _write_back(cache, new) -> None:
    """Copy a layer's new cache into its slot of the stacked caches; a
    tensor the layer already updated in place is left alone."""
    if isinstance(cache, dict):
        for k in cache:
            _write_back(cache[k], new[k])
    elif new is not cache:
        cache.copy_(new)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep matmul outputs, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _records(*trees) -> bool:
    """Whether autograd records a call on ``trees`` (tensors or nested
    dicts of them): grad mode is on and some tensor requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for tree in trees for t in prm.leaves(tree))


def _remat(cfg, fn):
    """``fn`` (one layer) under ``cfg.remat`` when autograd records the
    call: ``full`` saves only its inputs and recomputes it in the
    backward, ``dots`` saves its matmul outputs too.  A call that nothing
    differentiates (inference) runs ``fn`` as it is.  The layers draw no
    random numbers, so no RNG state is stashed."""
    if cfg.remat == "none":
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda *args: (checkpoint(fn, *args, **kw) if _records(*args)
                          else fn(*args))


def _stack(cfg, body, x, stacked_params, ctx: LayerCtx, caches=None):
    """Run a homogeneous layer stack in order; returns ``(x, aux)``, the
    layers' aux summed.  Without ``caches`` each layer runs under
    :func:`_remat`; ``caches`` (stacked ``(L, B, ...)``) are updated in
    place, layer by layer."""
    aux = 0.0
    step = _remat(cfg, lambda p, x: body(cfg, p, x, ctx, None))
    for i, p in enumerate(_unstack(stacked_params)):
        # pin the residual stream's sharding per layer; "seq" maps to ()
        # by default and to ("model",) under sequence parallelism
        x = constrain(x, "batch", "seq", None)
        if caches is None:
            x, _, a = step(p, x)
        else:
            cache = tree_map(lambda t: t[i], caches)
            x, new_cache, a = body(cfg, p, x, ctx, cache)
            _write_back(cache, new_cache)
        aux = aux + a
    return x, aux


def _hymba_forward(cfg, params, x, ctx: LayerCtx, caches=None):
    """The segments in order: a global layer attends over everything
    (``window = 0``), a sliding segment within ``cfg.window``; each takes
    its own slice of the ``global`` or ``sliding`` stacks and caches.
    Every layer runs under :func:`_remat`, the global ones too (the
    reference calls those outside its remat'd scan: the same values,
    another memory trade).  Returns ``(x, aux)``."""
    gi = si = 0
    aux = 0.0
    for kind, count in _hymba_segments(cfg):
        if kind == "g":
            part, lo, window = "global", gi, 0
            gi += count
        else:
            part, lo, window = "sliding", si, cfg.window
            si += count
        cache = (None if caches is None
                 else _layers(caches[part], lo, lo + count))
        x, a = _stack(cfg, hybrid_layer, x,
                      _layers(params[part], lo, lo + count),
                      replace(ctx, window=window), cache)
        aux = aux + a
    return x, aux


def _vlm_forward(cfg, params, x, ctx: LayerCtx, caches=None):
    """Each group's ``cross_every - 1`` self layers, then its gated cross
    layer over ``ctx.vision`` (or, in decode, over the group's cross
    cache, which passes through unchanged).  The nested self caches
    ``(n_cross, cross_every - 1, B, ...)`` are updated in place.  The
    cross layers run without remat, as the reference's.  Returns ``(x,
    aux)``."""
    aux = 0.0
    groups = _unstack(params["layers"])
    for gi, cp in enumerate(_unstack(params["cross"])):
        cache = (None if caches is None
                 else tree_map(lambda t: t[gi], caches["self"]))
        x, a = _stack(cfg, dense_layer, x, groups[gi], ctx, cache)
        aux = aux + a
        cross = (None if caches is None
                 else tree_map(lambda t: t[gi], caches["cross"]))
        x, _ = cross_attn_block(cfg, cp, x, ctx.vision, ctx, cross)
    return x, aux


def _whisper_encoder(cfg, params, frames):
    """Encoder over stub frame embeddings ``(B, enc_seq, d)``: dense,
    non-causal and unchunked attention (with RoPE, as the reference's),
    then the final LayerNorm."""
    ctx = LayerCtx(mode="train", causal=False)
    x, _ = _stack(cfg, dense_layer, frames, params["encoder"], ctx)
    return layer_norm(x, params["enc_final_norm"], params["enc_final_norm_b"])


def _whisper_decoder(cfg, params, x, ctx: LayerCtx, caches=None):
    """Decoder: per layer self-attention (its cache updated in place),
    then ungated cross-attention to ``ctx.encoder_out`` or, in decode, to
    the layer's cross cache; the pair runs under :func:`_remat` without
    caches.  Returns ``(x, aux)``; the aux stays 0, as the reference's
    (it drops its layers' aux)."""

    def layer(p, cp, x):
        x, _, _ = dense_layer(cfg, p, x, ctx, None)
        x, _ = cross_attn_block(cfg, cp, x, ctx.encoder_out, ctx, None)
        return x

    step = _remat(cfg, layer)
    pairs = zip(_unstack(params["layers"]), _unstack(params["cross"]))
    for i, (p, cp) in enumerate(pairs):
        x = constrain(x, "batch", "seq", None)  # pin residual sharding
        if caches is None:
            x = step(p, cp, x)
        else:
            cache = tree_map(lambda t: t[i], caches["self"])
            x, new_cache, _ = dense_layer(cfg, p, x, ctx, cache)
            _write_back(cache, new_cache)
            x, _ = cross_attn_block(cfg, cp, x, ctx.encoder_out, ctx,
                                    tree_map(lambda t: t[i], caches["cross"]))
    return x, 0.0


def _decoder_forward(cfg, params, x, ctx: LayerCtx, caches=None):
    """Run the decoder stack; returns ``(hidden, aux)``."""
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


def _forward_aux(cfg: ArchConfig, params, tokens: torch.Tensor, *,
                 mode: str = "train", chunked: bool | None = None,
                 vision=None, frames=None, caches=None, cache_index=None):
    """:func:`hidden_forward` returning ``(hidden, aux)``, the layers'
    summed aux beside the hidden states (the reference's
    ``hidden_forward`` returns both); ``caches`` are updated in place."""
    _check_family(cfg)
    x = take_rows(params["embed"], tokens).to(_dtype(cfg))
    if chunked is None:
        chunked = tokens.shape[1] > 2048
    vision = stub_input(cfg, vision)
    encoder_out = None
    if cfg.kind == "encdec" and frames is not None:
        encoder_out = _whisper_encoder(cfg, params, stub_input(cfg, frames))
    ctx = LayerCtx(mode=mode, cache_index=cache_index,
                   chunked=chunked and caches is None, causal=True, window=0,
                   vision=vision, encoder_out=encoder_out)
    return _decoder_forward(cfg, params, x, ctx, caches)


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
    x, _ = _forward_aux(cfg, params, tokens, mode=mode, chunked=chunked,
                        vision=vision, frames=frames, caches=caches,
                        cache_index=cache_index)
    return x, caches


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            mode: str = "train", chunked: bool | None = None, vision=None,
            frames=None, caches=None, cache_index=None):
    """Full forward.  Returns ``(logits (B, S, V), caches)``."""
    x, new_caches = hidden_forward(cfg, params, tokens, mode=mode,
                                   chunked=chunked, vision=vision,
                                   frames=frames, caches=caches,
                                   cache_index=cache_index)
    return logits_fn(cfg, params, x), new_caches


def _ce_sum(cfg, params, h, t) -> torch.Tensor:
    """Sum over a chunk's positions of ``logsumexp(logits) - logit[label]``,
    the logits ``(b, c, V)`` in float32, kept batch- and vocab-sharded
    under a mesh."""
    h = constrain(h, "batch", None, None)
    logits = constrain(logits_fn(cfg, params, h).to(torch.float32),
                       "batch", None, "vocab")
    lse = torch.logsumexp(logits, dim=-1)
    if type(logits).__name__ == "DTensor":
        # the reference's one-hot contraction: stays vocab-sharded
        label = torch.sum(logits * F.one_hot(
            t.long(), logits.shape[-1]).to(torch.float32), dim=-1)
    else:
        label = torch.gather(logits, -1, t[..., None].long())[..., 0]
    return torch.sum(lse - label)


def chunked_ce(cfg, params, hidden, targets, *, chunk: int = 2048):
    """Memory-safe cross-entropy: logits are never materialized whole.

    The sequence splits into equal chunks of the largest ``c <= chunk``
    that divides it (a uniform grid, no ragged tail, the reference's
    choice); each chunk projects to ``(B, c, V)`` float32 logits, reduces
    to logsumexp minus the label's logit, and is freed.  Under autograd
    each chunk is checkpointed, so its logits are recomputed in the
    backward instead of kept.  Returns the mean over ``B * S``."""
    b, s, _ = hidden.shape
    c = min(chunk, s)
    while s % c:
        c -= 1
    step = _ce_sum
    if _records(hidden, params):
        step = functools.partial(checkpoint, _ce_sum, use_reentrant=False,
                                 preserve_rng_state=False)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, c):
        total = total + step(cfg, params, hidden[:, c0:c0 + c],
                             targets[:, c0:c0 + c])
    return total / (b * s)


def lm_loss(cfg: ArchConfig, params, batch: dict, *,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token cross-entropy (+ the MoE aux): ``batch["tokens"] (B,
    S + 1)`` predicts each next token from the ones before it, with a
    VLM's ``batch["vision"]`` and Whisper's ``batch["frames"]`` stubs.
    MoE configs add ``aux_weight * aux / n_layers``, the layers' summed
    load-balance loss.  A float32 scalar."""
    tokens = batch["tokens"]
    hidden, aux = _forward_aux(cfg, params, tokens[:, :-1],
                               vision=batch.get("vision"),
                               frames=batch.get("frames"))
    loss = chunked_ce(cfg, params, hidden, tokens[:, 1:])
    if cfg.n_experts:
        loss = loss + aux_weight * aux / max(cfg.n_layers, 1)
    return loss
