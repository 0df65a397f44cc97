"""Transformer building blocks of the port: RMSNorm, LayerNorm, SwiGLU,
the GELU MLP, RoPE, GQA attention and multi-head latent attention (MLA).

The port of the reference's ``repro.models.layers``.  Every block is a
plain function of tensors, with the reference's cast order: attention
scores in float32, masked with the finite :data:`NEG_INF`, softmaxed in
float32 and cast back to the inputs' type before the value product.

Attention comes in two dataflows, as in the reference:

* :func:`dense_attention` — materialized scores, for short sequences.
* :func:`chunked_attention` — flash-style online softmax over a grid of
  query and key chunks, visiting for each query chunk only the key blocks
  its causal and window masks leave live; the reference's ``lax.scan``
  over key blocks is a Python loop.

Decode attention (:func:`gqa_attention` or :func:`mla_attention` with a
cache) writes the new keys and values (MLA: the latent and the shared RoPE
key) into the cache **in place** and attends over the whole cache with
position masks, where the reference returns an updated cache.  A write
past the cache's end raises ``ValueError`` (:func:`_check_cache_room`); the
reference clamps it onto the last slots instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.spmd import per_head

# finite, so that exp(m - m_new) stays finite (0) when a visited block masks
# a whole row of the online softmax; -inf would make it NaN
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """``(x * rsqrt(mean(x^2) + eps)).astype(x.dtype) * scale``, the mean
    in float32: the reference's cast order, so bf16 rounds where it does."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """``((x - mean) * rsqrt(var + eps)).astype(x.dtype) * scale + bias``,
    the mean and the population variance in float32: the reference's cast
    order.  ``F.layer_norm`` is not used: at bf16 it applies the weight
    before the cast, which rounds elsewhere."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: down( silu(x@gate) * (x@up) )."""
    g = F.silu(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down


def gelu_mlp(x, w_in, w_out):
    """GELU MLP: out( gelu(x@in) ), with the tanh approximation that
    ``jax.nn.gelu`` takes by default (the erf form differs by up to 5e-4)."""
    return F.gelu(x @ w_in, approximate="tanh") @ w_out


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float = 1e4, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, D) with positions (..., S) or (S,).  Rotates the two
    halves of the head (not interleaved pairs) by float32 angles; the
    product with x is in float32 and the result is cast back to x's type."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (D/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------


def _expand_kv(k, n_rep: int):
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D) for GQA: a repeat-interleave,
    query head ``h`` reads KV head ``h // n_rep``."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _mask(qpos, kpos, causal: bool, window: int):
    """``(Sq, Skv)`` bool: True where query ``qpos`` may see key ``kpos``."""
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def dense_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """Materialized attention.  q: (B,Sq,H,D), k/v: (B,Skv,Hkv,D)."""
    n_rep = q.shape[2] // k.shape[2]
    k = _expand_kv(k, n_rep)
    v = _expand_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    sq, skv = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(skv, device=q.device)
    mask = _mask(qpos, kpos, causal, window)
    logits = logits.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
):
    """Flash-style attention: online softmax over a (Q-chunk x KV-chunk) grid.

    Both sequence lengths must be chunk multiples (the uniform-stride
    contract; a ``ValueError`` otherwise).  Each q-chunk visits only its
    live KV block range ``[lo, hi)``, Python ints, as the reference's
    default ``skip_masked_blocks`` does: causal skips the future blocks, a
    sliding window both tails.  A block the masks leave wholly visible is
    not masked (the same numbers: the mask would keep every score).
    The block's scores are scaled and masked in place (no backward keeps
    them until ``amax``), and the softmax numerator is taken out of place:
    ``amax`` keeps the scores for its backward, so autograd differentiates
    the loop.
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    dv = v.shape[-1]
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(
            f"uniform chunk grid: Sq={sq} must be a multiple of"
            f" q_chunk={q_chunk} and Skv={skv} of kv_chunk={kv_chunk}")
    n_rep = h // k.shape[2]
    k = _expand_kv(k, n_rep)
    v = _expand_kv(v, n_rep)
    scale = d ** -0.5
    nq, nk = sq // q_chunk, skv // kv_chunk
    f32 = torch.float32

    # (n, B, H, C, D) chunk stacks, contiguous so every block is one slab
    qs = q.reshape(b, nq, q_chunk, h, d).permute(1, 0, 3, 2, 4).contiguous()
    ks = k.reshape(b, nk, kv_chunk, h, d).permute(1, 0, 3, 2, 4).contiguous()
    vs = v.reshape(b, nk, kv_chunk, h, dv).permute(1, 0, 3, 2, 4).contiguous()
    kv_offset = skv - sq  # causal alignment when skv > sq (cache prefixes)
    q_ar = torch.arange(q_chunk, device=q.device)
    k_ar = torch.arange(kv_chunk, device=q.device)

    def run_q_chunk(iq: int, lo: int, hi: int):
        """Online softmax for one q-chunk over KV blocks [lo, hi)."""
        qc = qs[iq]
        q0 = iq * q_chunk + kv_offset  # the chunk's first query position
        acc = torch.zeros((b, h, q_chunk, dv), dtype=f32, device=q.device)
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((b, h, q_chunk), dtype=f32, device=q.device)
        for ik in range(lo, hi):
            kc, vc = ks[ik], vs[ik]
            k0 = ik * kv_chunk
            logits = torch.einsum("bhqd,bhkd->bhqk", qc, kc).to(f32).mul_(scale)
            # the block's farthest pair is within the window and its
            # latest key at or before its earliest query: nothing to mask
            visible = ((not causal or k0 + kv_chunk - 1 <= q0)
                       and (not window
                            or q0 + q_chunk - 1 - k0 < window))
            if not visible:
                mask = _mask(q0 + q_ar, k0 + k_ar, causal, window)
                logits.masked_fill_(~mask[None, None], NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            # out of place: amax keeps ``logits`` for its backward
            p = (logits - m_new[..., None]).exp_()
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vc.dtype), vc).to(f32)
            m = m_new
        return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)

    outs = []
    for iq in range(nq):
        lo, hi = 0, nk
        if causal:  # last causally-visible kv block for this q chunk
            hi = min(nk, (iq * q_chunk + q_chunk - 1 + kv_offset)
                     // kv_chunk + 1)
        if window:  # first block within the window of the oldest query
            lo = max(0, (iq * q_chunk + kv_offset - window + 1) // kv_chunk)
        outs.append(run_q_chunk(iq, lo, hi))
    out = torch.stack(outs, dim=0)
    # (nq, B, H, Cq, Dv) -> (B, Sq, H, Dv)
    return out.permute(1, 0, 3, 2, 4).reshape(b, sq, h, dv)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def _check_cache_room(cache_len: int, cache_index: int, s: int) -> None:
    """Refuse a write of ``s`` positions at ``cache_index`` that would run
    past a cache of ``cache_len`` positions: a slice assignment there
    writes nothing and raises nothing, so the step would attend over a
    cache without its own tokens."""
    if cache_index + s > cache_len:
        raise ValueError(
            f"decode past the cache's end: {s} position(s) at cache_index"
            f" {cache_index} into a cache of {cache_len}")


def gqa_attention(
    p,
    x,
    *,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    rope_theta: float,
    causal: bool = True,
    window: int = 0,
    kv_cache=None,
    cache_index=None,
    chunked: bool = False,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
):
    """Full GQA block: qkv proj + RoPE + attention + out proj.

    ``kv_cache``: optional dict(k=(B,Smax,Hkv,D), v=...) for decode; the new
    tokens' k/v are written into it in place at ``cache_index`` (in the
    cache's type; ``ValueError`` if they would run past ``Smax``) and
    attention runs over the whole cache with position masking.  Returns
    (out, new_cache): ``new_cache`` holds the cache's own tensors, ``None``
    without a cache.
    """
    b, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])  # (B,S,H,Dh)
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    positions = torch.arange(s, device=x.device)
    if cache_index is not None:
        positions = positions + cache_index
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if kv_cache is not None:
        kc, vc = kv_cache["k"], kv_cache["v"]
        _check_cache_room(kc.shape[1], cache_index, s)
        kc[:, cache_index:cache_index + s] = k.to(kc.dtype)
        vc[:, cache_index:cache_index + s] = v.to(vc.dtype)
        new_cache = {"k": kc, "v": vc}
        # decode: attend over the cache up to cache_index+s
        skv = kc.shape[1]
        n_rep = n_heads // n_kv_heads
        ke = _expand_kv(kc.to(q.dtype), n_rep)
        ve = _expand_kv(vc.to(q.dtype), n_rep)
        scale = d_head ** -0.5
        logits = torch.einsum("bqhd,bkhd->bhqk", q, ke).to(torch.float32) * scale
        kpos = torch.arange(skv, device=x.device)
        qpos = positions
        mask = kpos[None, :] <= qpos[:, None]
        if window:
            mask &= qpos[:, None] - kpos[None, :] < window
        logits = logits.masked_fill(~mask[None, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, ve)
    else:
        new_cache = None
        if chunked:
            out = per_head(chunked_attention, q, k, v, causal=causal,
                           window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
        else:
            out = per_head(dense_attention, q, k, v, causal=causal,
                           window=window)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------


def mla_attention(
    p,
    x,
    *,
    n_heads: int,
    d_nope: int,
    d_rope: int,
    d_v: int,
    rope_theta: float,
    kv_cache=None,
    cache_index=None,
    chunked: bool = False,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
):
    """Multi-head latent attention with a compressed KV cache.

    The queries pass a low-rank bottleneck with an RMSNorm; the cache holds
    only the normed latent ``c_kv`` (kv_lora) and one RoPE key shared by
    all heads (d_rope) a position, and K/V are re-expanded from it on every
    call.  RoPE rotates ``q_rope`` and the shared key only; the scale is
    ``(d_nope + d_rope) ** -0.5``.  ``kv_cache``: optional dict(ckv=(B,
    Smax, kv_lora), krope=(B, Smax, d_rope)), written in place at
    ``cache_index`` (``ValueError`` past ``Smax``).  Returns ``(out,
    new_cache)`` as :func:`gqa_attention`.  The reference's ``q_lora`` and
    ``kv_lora`` arguments, which it does not read (the params carry those
    widths), are not ported.
    """
    b, s, _ = x.shape
    # --- queries through the low-rank bottleneck ---
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])  # (B,S,H,d_nope+d_rope)
    q_nope, q_rope = q[..., :d_nope], q[..., d_nope:]
    # --- compressed kv + shared rope key ---
    ckv = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wkv_a"]), p["kv_norm"])
    krope = torch.einsum("bsd,dk->bsk", x, p["wk_rope"])  # (B,S,d_rope)

    positions = torch.arange(s, device=x.device)
    if cache_index is not None:
        positions = positions + cache_index
    q_rope = apply_rope(q_rope, positions, rope_theta)
    krope = apply_rope(krope[:, :, None, :], positions, rope_theta)[:, :, 0]

    if kv_cache is not None:
        ckv_c, kr_c = kv_cache["ckv"], kv_cache["krope"]
        _check_cache_room(ckv_c.shape[1], cache_index, s)
        ckv_c[:, cache_index:cache_index + s] = ckv.to(ckv_c.dtype)
        kr_c[:, cache_index:cache_index + s] = krope.to(kr_c.dtype)
        new_cache = {"ckv": ckv_c, "krope": kr_c}
        ckv_full, krope_full = ckv_c.to(x.dtype), kr_c.to(x.dtype)
    else:
        new_cache = None
        ckv_full, krope_full = ckv, krope

    # expand the latent to per-head K/V
    k_nope = torch.einsum("bsr,rhk->bshk", ckv_full, p["wk_b"])
    vfull = torch.einsum("bsr,rhk->bshk", ckv_full, p["wv_b"])
    skv = ckv_full.shape[1]
    kr = krope_full[:, :, None, :].expand(b, skv, n_heads, d_rope)
    k = torch.cat([k_nope, kr], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)

    if kv_cache is not None:
        scale = (d_nope + d_rope) ** -0.5
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, k).to(torch.float32) * scale
        mask = torch.arange(skv, device=x.device)[None, :] <= positions[:, None]
        logits = logits.masked_fill(~mask[None, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vfull)
    elif chunked:
        out = per_head(chunked_attention, qf, k, vfull, causal=True,
                       q_chunk=q_chunk, kv_chunk=kv_chunk)
    else:
        out = per_head(dense_attention, qf, k, vfull, causal=True)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache
