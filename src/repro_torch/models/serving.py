"""Serving substrate: cache specs, init, and the decode step.

The port of the reference's ``repro.models.serving``.  Cache layouts per
family:

* GQA (dense, MoE): k/v  (L, B, S_max, H_kv, D_h)
* MLA (dense):  ckv (L, B, S_max, kv_lora) + krope (L, B, S_max, d_rope),
          the latent and the shared RoPE key, not per-head K/V
* SSM:    conv (L, B, K-1, conv_ch) + state (L, B, H, P, N) — O(1) in S
* hybrid: 'global' and 'sliding' stacks (3 and 29 layers at Hymba-1.5B),
          each {'attn': GQA k/v, 'ssm': conv/state}
* vlm:    'self' GQA k/v (n_cross, cross_every - 1, B, S_max, H_kv, D_h)
          + 'cross' k/v (n_cross, B, vis_seq, H_kv, D_h), the vision
          stub's projections, filled once a request
* encdec: 'self' GQA k/v + 'cross' k/v (L, B, enc_seq, H_kv, D_h), the
          encoder states' projections, filled once a request

Caches are declared with the same :class:`~repro_torch.models.params.P`
specs as parameters and made in the config's dtype, as the reference makes
them: in bf16 runs the SSM state rides in bf16 between tokens and
``ssd_decode_step`` computes its output from a float32 copy each token.

:func:`prefill_cross_caches` fills the cross caches and :func:`decode_step`
consumes one token per sequence at ``cache_index``; both update the caches
**in place** (the reference returns new ones).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import resolve_device

from .model import (
    _check_family,
    _dtype,
    _whisper_encoder,
    forward,
    stub_input,
)
from . import params as prm
from .params import P, tree_map


def _gqa_cache(cfg, L, B, S) -> dict:
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
    ax = ("layers", "batch", "cache_seq", "kv_heads", None)
    return {
        "k": P((L, B, S, Hkv, Dh), ax, "zero"),
        "v": P((L, B, S, Hkv, Dh), ax, "zero"),
    }


def _mla_cache(cfg, L, B, S) -> dict:
    ax = ("layers", "batch", "cache_seq", None)
    return {
        "ckv": P((L, B, S, cfg.kv_lora_rank), ax, "zero"),
        "krope": P((L, B, S, cfg.d_rope), ax, "zero"),
    }


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


def _cross_cache(cfg, L, B, S_src) -> dict:
    ax = ("layers", "batch", None, "kv_heads", None)
    return {
        "k": P((L, B, S_src, cfg.n_kv_heads, cfg.d_head), ax, "zero"),
        "v": P((L, B, S_src, cfg.n_kv_heads, cfg.d_head), ax, "zero"),
    }


def build_cache_specs(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The cache specs of ``batch`` sequences of up to ``max_seq`` tokens
    (an SSM cache does not depend on ``max_seq``)."""
    _check_family(cfg)
    L, B, S = cfg.n_layers, batch, max_seq
    if cfg.family == "ssm":
        return _ssm_cache(cfg, L, B)
    if cfg.family == "hybrid":
        n_g = len(cfg.global_layers)
        n_s = L - n_g
        return {
            "global": {"attn": _gqa_cache(cfg, n_g, B, S),
                       "ssm": _ssm_cache(cfg, n_g, B)},
            "sliding": {"attn": _gqa_cache(cfg, n_s, B, S),
                        "ssm": _ssm_cache(cfg, n_s, B)},
        }
    if cfg.family == "vlm":
        n_cross = L // cfg.cross_every
        spg = cfg.cross_every - 1
        self_c = tree_map(
            lambda p: P((p.shape[0], spg) + p.shape[1:],
                        (p.axes[0], "layers") + p.axes[1:], "zero"),
            _gqa_cache(cfg, n_cross, B, S))
        return {"self": self_c,
                "cross": _cross_cache(cfg, n_cross, B, cfg.vis_seq)}
    if cfg.kind == "encdec":
        return {"self": _gqa_cache(cfg, L, B, S),
                "cross": _cross_cache(cfg, L, B, cfg.enc_seq)}
    if cfg.attn_kind == "mla":
        return _mla_cache(cfg, L, B, S)
    return _gqa_cache(cfg, L, B, S)


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, *, device=None):
    """Zero caches in the config's dtype on ``device`` (``None`` = the
    CUDA card)."""
    dev = resolve_device(device)
    return tree_map(
        lambda p: torch.zeros(p.shape, dtype=_dtype(cfg), device=dev),
        build_cache_specs(cfg, batch, max_seq),
    )


def abstract_caches(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The caches as ``device="meta"`` tensors (nothing allocated)."""
    return prm.abstract_tree(build_cache_specs(cfg, batch, max_seq),
                             _dtype(cfg))


def cache_axes(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The logical axes of every cache leaf (same structure)."""
    return prm.axes_tree(build_cache_specs(cfg, batch, max_seq))


def hybrid_split_caches(cfg, caches):
    """Reorder hybrid caches into the forward pass's (global, sliding) view.

    The specs already separate the global and sliding stacks, each zipped as
    {'attn':..., 'ssm':...}: the identity today, kept as the single point of
    change if cache layouts diverge."""
    return caches


def _to_forward_caches(cfg, caches):
    if cfg.family == "hybrid":
        # the forward wants per-part dicts {'attn': {k,v}, 'ssm': {...}}
        def regroup(part):
            return {"attn": part["attn"], "ssm": part["ssm"]}

        return {"global": regroup(caches["global"]),
                "sliding": regroup(caches["sliding"])}
    return caches


def prefill_cross_caches(cfg: ArchConfig, params, caches, *, vision=None,
                         frames=None):
    """Fill the per-request cross-attention K/V caches (vlm / encdec) in
    place and return ``caches``; other families' caches are returned
    untouched.  The projections run once a request (Whisper's encoder
    too); every decode step then reads the cached K/V.  ``vision (B,
    vis_seq, d)`` or ``frames (B, enc_seq, d)``: the stub inputs."""
    if cfg.family == "vlm":
        src = stub_input(cfg, vision)
    elif cfg.kind == "encdec":
        src = _whisper_encoder(cfg, params, stub_input(cfg, frames))
    else:
        return caches
    for name in ("k", "v"):
        caches["cross"][name].copy_(torch.einsum(
            "bsd,ldhk->lbshk", src, params["cross"]["w" + name]))
    return caches


def decode_step(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,  # (B, 1)
    caches,
    cache_index: int,  # position of the token (unused by the SSM family)
    *,
    vision=None,
    frames=None,
    encoder_out=None,
):
    """One serving step: the next-token logits ``(B, V)`` and the caches,
    updated in place (the same tree that was passed in).  A VLM's or
    Whisper's cross layers read ``caches["cross"]``, which
    :func:`prefill_cross_caches` filled; ``frames``, when given, run
    Whisper's encoder again for nothing, and ``encoder_out`` is not read,
    as in the reference."""
    logits, _ = forward(cfg, params, tokens, mode="decode", chunked=False,
                        vision=vision, frames=frames,
                        caches=_to_forward_caches(cfg, caches),
                        cache_index=cache_index)
    return logits[:, -1, :], caches
