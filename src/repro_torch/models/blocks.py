"""Per-family layer bodies.

The port of the reference's ``repro.models.blocks``.  Every body has the
signature ``(cfg, p, x, ctx, cache) -> (x, new_cache, aux)``, where
``ctx`` is a :class:`LayerCtx` carrying the mode, the attention switches
and the auxiliary inputs (the vision stub, the encoder's states);
:mod:`repro_torch.models.model` loops the bodies over stacked params and
sums their ``aux``, the per-layer load-balance loss that
:func:`moe_layer` takes from :func:`~repro_torch.models.moe.moe_ffn` and
every other body returns as ``0.0``.  :func:`cross_attn_block` returns
``(x, 0.0)``, as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.parallel.spmd import per_head

from .layers import (
    chunked_attention,
    dense_attention,
    gelu_mlp,
    gqa_attention,
    layer_norm,
    mla_attention,
    rms_norm,
    swiglu,
)
from .moe import moe_ffn
from .ssm import mamba2_mixer


@dataclass
class LayerCtx:
    mode: str = "train"  # train | prefill | decode
    cache_index: Any = None  # position of the first token in decode
    chunked: bool = False  # use flash-chunked attention
    causal: bool = True
    window: int = 0  # sliding window for this layer (0 = full)
    vision: Any = None  # (B, vis_seq, d) stub embeddings (vlm)
    encoder_out: Any = None  # (B, enc_seq, d) encoder states (encdec)


def _norm(cfg, x, p_scale, p_bias=None):
    if cfg.norm == "layernorm":
        return layer_norm(x, p_scale, p_bias)
    return rms_norm(x, p_scale)


def _ffn(cfg, p, x):
    if cfg.act == "gelu":
        return gelu_mlp(x, p["w_in"], p["w_out"])
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _self_attention(cfg, p, x, ctx: LayerCtx, cache):
    if cfg.attn_kind == "mla":
        return mla_attention(
            p,
            x,
            n_heads=cfg.n_heads,
            d_nope=cfg.d_nope,
            d_rope=cfg.d_rope,
            d_v=cfg.d_v,
            rope_theta=cfg.rope_theta,
            kv_cache=cache,
            cache_index=ctx.cache_index,
            chunked=ctx.chunked,
            q_chunk=cfg.attn_chunk,
            kv_chunk=cfg.attn_chunk,
        )
    return gqa_attention(
        p,
        x,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.d_head,
        rope_theta=cfg.rope_theta,
        causal=ctx.causal,
        window=ctx.window,
        kv_cache=cache,
        cache_index=ctx.cache_index,
        chunked=ctx.chunked,
        q_chunk=cfg.attn_chunk,
        kv_chunk=cfg.attn_chunk,
    )


# ---------------------------------------------------------------------------
# family bodies
# ---------------------------------------------------------------------------


def dense_layer(cfg, p, x, ctx: LayerCtx, cache=None):
    """Pre-norm dense block (deepseek / glm4 / phi4 / minicpm3 / llama,
    and whisper's encoder and decoder self layers, whose norms carry a
    LayerNorm bias)."""
    h, new_cache = _self_attention(
        cfg, p["attn"], _norm(cfg, x, p["attn_norm"], p.get("attn_norm_b")),
        ctx, cache)
    x = x + h
    x = x + _ffn(cfg, p["ffn"],
                 _norm(cfg, x, p["ffn_norm"], p.get("ffn_norm_b")))
    return x, new_cache, 0.0


def moe_layer(cfg, p, x, ctx: LayerCtx, cache=None):
    """MoE block: attention + routed experts (+ shared experts when
    ``n_shared_experts``, + a dense residual MLP when ``dense_residual``),
    all three on the same normed input.  The tokens split into ``max(1,
    tokens // cfg.moe_group_tokens)`` dispatch groups.  ``aux`` is the
    load-balance loss that :func:`moe_ffn` returns."""
    h, new_cache = _self_attention(
        cfg, p["attn"], _norm(cfg, x, p["attn_norm"]), ctx, cache)
    x = x + h
    xn = _norm(cfg, x, p["ffn_norm"])
    tokens = xn.shape[0] * xn.shape[1]
    y, aux = moe_ffn(
        p["moe"],
        xn,
        n_experts=cfg.n_experts,
        top_k=cfg.top_k,
        capacity_factor=cfg.capacity_factor,
        groups=max(1, tokens // cfg.moe_group_tokens),
    )
    if cfg.n_shared_experts:
        y = y + _ffn(cfg, p["shared"], xn)
    if cfg.dense_residual:
        y = y + _ffn(cfg, p["dense"], xn)
    return x + y, new_cache, aux


def ssm_layer(cfg, p, x, ctx: LayerCtx, cache=None):
    """Mamba-2 block: rmsnorm -> mixer -> residual (no separate FFN).
    ``cache`` is ``None`` in prefill and the layer's SSM cache in decode."""
    h, new_cache = mamba2_mixer(
        p["mixer"],
        _norm(cfg, x, p["norm"]),
        n_heads=cfg.ssm_heads,
        head_dim=cfg.ssm_head_dim,
        state_dim=cfg.ssm_state,
        conv_dim=cfg.ssm_conv,
        chunk=cfg.ssd_chunk,
        ssm_cache=cache,
    )
    return x + h, new_cache, 0.0


def hybrid_layer(cfg, p, x, ctx: LayerCtx, cache=None):
    """Hymba block: attention and mamba heads in parallel, then FFN.

    ``cache`` is a dict with 'attn' and 'ssm' sub-caches (``None`` outside
    decode).  The two heads' outputs are summed before the halving, so in
    bf16 the sum rounds first, as in the reference.
    """
    attn_cache = cache.get("attn") if cache else None
    ssm_cache = cache.get("ssm") if cache else None
    xn = _norm(cfg, x, p["attn_norm"])
    h_attn, new_attn = _self_attention(cfg, p["attn"], xn, ctx, attn_cache)
    h_ssm, new_ssm = mamba2_mixer(
        p["mixer"],
        xn,
        n_heads=cfg.ssm_heads,
        head_dim=cfg.ssm_head_dim,
        state_dim=cfg.ssm_state,
        conv_dim=cfg.ssm_conv,
        chunk=cfg.ssd_chunk,
        ssm_cache=ssm_cache,
    )
    x = x + 0.5 * (h_attn + h_ssm)  # parallel-head fusion (mean combine)
    x = x + _ffn(cfg, p["ffn"], _norm(cfg, x, p["ffn_norm"]))
    new_cache = None
    if cache is not None:
        new_cache = {"attn": new_attn, "ssm": new_ssm}
    return x, new_cache, 0.0


def _cross_chunks(sq: int, skv: int) -> tuple[int, int]:
    """The reference's chunk grid for a long cross-attention: 1024-query
    chunks when they divide ``sq`` (else one chunk of ``sq``), and the
    whole source as one key block up to 2048 positions (Llama-Vision's
    1601, Whisper's 1500), else its largest divisor in 512..2048 (else the
    whole source).  Both always divide, as ``chunked_attention`` needs."""
    qc = 1024 if sq % 1024 == 0 else sq
    if skv <= 2048:
        return qc, skv
    divisors = [d for d in range(512, 2049) if skv % d == 0]
    return qc, max(divisors) if divisors else skv


def cross_attn_block(cfg, p, x, kv_src, ctx: LayerCtx, kv_cache=None):
    """Gated cross-attention (llama-vision) / plain cross-attn (whisper).

    ``kv_src``: (B, S_src, d) keys/values source (vision or encoder
    states).  ``kv_cache``: optional precomputed dict(k=, v=) to skip the
    projections (decode: projected once per request, reused every step);
    it is read, never written.  Non-causal attention: flash-chunked on the
    grid of :func:`_cross_chunks` past 2048 queries, dense below.  The
    output is scaled by ``tanh(gate)`` when the params have a ``gate``.
    Returns ``(x, 0.0)``: the new hidden states and the layer's aux.
    """
    xn = _norm(cfg, x, p["norm"], p.get("norm_b"))
    q = torch.einsum("bsd,dhk->bshk", xn, p["wq"])
    if kv_cache is not None:
        k, v = kv_cache["k"].to(q.dtype), kv_cache["v"].to(q.dtype)
    else:
        k = torch.einsum("bsd,dhk->bshk", kv_src, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", kv_src, p["wv"])
    sq, skv = q.shape[1], k.shape[1]
    if sq > 2048:
        qc, kc = _cross_chunks(sq, skv)
        out = per_head(chunked_attention, q, k, v, causal=False,
                       q_chunk=qc, kv_chunk=kc)
    else:
        out = per_head(dense_attention, q, k, v, causal=False)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if "gate" in p:
        y = torch.tanh(p["gate"]) * y
    return x + y, 0.0
