"""Mamba-2 (SSD, state-space duality) blocks — arXiv:2405.21060.

The port of the reference's ``repro.models.ssm``.  Chunked SSD for prefill
(intra-chunk quadratic + inter-chunk state recurrence, the paper's
Listing-1 decomposition) and an O(1)-per-token recurrent step for decode.

The port's :func:`mamba2_mixer` runs its prefill SSD through
:func:`repro_torch.kernels.ssd_scan.ops.ssd_scan` (the hand-written CUDA
chunk scan on the card, its plain version on the CPU; in training its
hand-written backward too) where the reference calls the pure-jnp
:func:`ssd_chunked`: the swap the reference's ``ssd_scan`` was written
for, same signature, same padding.  :func:`ssd_chunked` is kept
as it is: the tests hold the mixer's prefill against the mixer with
:func:`ssd_chunked` in the kernel's place, and the kernel on the card
against it.

Shapes: heads H with head dim P (= d_inner / H), state N, groups G=1 (B/C
shared across heads).  Mixed-type products follow jnp's promotion (both
operands to their common type), written out as casts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.parallel.spmd import shard_local


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``: every operand in the operands' promoted type."""
    dtype = ops[0].dtype
    for t in ops[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.einsum(eq, *(t.to(dtype) for t in ops))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum a[..., j+1..i] (lower-tri)."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int, h0=None):
    """Chunked SSD scan.

    x: (b, S, H, P), dt: (b, S, H) (post-softplus), A: (H,) negative,
    B/C: (b, S, N) shared across heads (G=1), D: (H,).
    Returns (y (b,S,H,P), final_state (b,H,P,N)).
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}")

    # discretize: per-step log decay and input scaling
    dA = dt * A[None, None, :]  # (b,S,H) negative
    xb = x * dt[..., None]  # dt-scaled input (ZOH simplification, mamba2)

    state = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
             if h0 is None else h0.to(torch.float32))
    ys = []
    for c0 in range(0, S, chunk):
        xk, dAk = xb[:, c0:c0 + chunk], dA[:, c0:c0 + chunk]
        Bk, Ck = B[:, c0:c0 + chunk], C[:, c0:c0 + chunk]
        cums = torch.cumsum(dAk, dim=1)  # (b,chunk,H)
        # ---- intra-chunk (quadratic, attention-like with decay) ----
        L = torch.exp(_segsum(dAk.transpose(1, 2)))  # (b,H,chunk,chunk)
        scores = _einsum("bqn,bkn->bqk", Ck, Bk)  # (b,chunk,chunk)
        y_diag = _einsum("bhqk,bqk,bkhp->bqhp", L.to(x.dtype),
                         scores.to(x.dtype), xk)
        # ---- contribution of the carried state ----
        decay_in = torch.exp(cums)  # (b,chunk,H)
        y_off = _einsum("bqn,bhpn,bqh->bqhp", Ck, state.to(torch.float32),
                        decay_in).to(x.dtype)
        # ---- new carried state ----
        decay_out = torch.exp(cums[:, -1:, :] - cums)  # (b,chunk,H)
        new = _einsum("bkn,bkh,bkhp->bhpn", Bk, decay_out, xk)
        state = (state * torch.exp(cums[:, -1, :])[..., None, None]
                 + new.to(torch.float32))
        ys.append(y_diag + y_off)
    y = torch.cat(ys, dim=1)
    return y + x * D[None, None, :, None], state


def ssd_decode_step(state, x, dt, A, B, C, D):
    """Single-token SSD recurrence.  state: (b,H,P,N); x: (b,H,P);
    dt: (b,H); B/C: (b,N).  Returns (y (b,H,P), new_state)."""
    dA = torch.exp(dt * A[None, :])  # (b,H)
    xb = x * dt[..., None]
    new_state = state * dA[..., None, None] + _einsum(
        "bhp,bn->bhpn", xb, B).to(state.dtype)
    y = _einsum("bhpn,bn->bhp", new_state.to(torch.float32), C).to(x.dtype)
    return y + x * D[None, :, None], new_state


def causal_conv1d(x, w, state=None):
    """Depthwise causal conv over (b, S, C) with kernel (K, C).

    ``state``: (b, K-1, C) rolling buffer for decode.  Returns (y, new_state).
    """
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else None
    return y, new_state


def mamba2_mixer(
    p: dict,
    x: torch.Tensor,  # (b, S, d_model)
    *,
    n_heads: int,
    head_dim: int,
    state_dim: int,
    conv_dim: int = 4,
    chunk: int = 256,
    ssm_cache=None,  # dict(conv=(b,K-1,conv_ch), state=(b,H,P,N)) for decode
):
    """Full Mamba-2 mixer: in_proj -> conv1d -> SSD -> gate -> out_proj.

    Prefill (``ssm_cache=None``) runs the SSD through
    :func:`~repro_torch.kernels.ssd_scan.ops.ssd_scan`, which pads S to a
    chunk multiple itself; decode (``S == 1``) runs :func:`ssd_decode_step`.
    Returns (y, new_cache).
    """
    b, S, _ = x.shape
    d_inner = n_heads * head_dim
    zxbcdt = x @ p["w_in"]
    z, xbc, dt = torch.split(
        zxbcdt, [d_inner, d_inner + 2 * state_dim, n_heads], dim=-1)
    conv_state = None if ssm_cache is None else ssm_cache["conv"]
    # depthwise along the channels: run per shard of the batch and channels
    xbc, new_conv = shard_local(causal_conv1d, (xbc, p["conv_w"],
                                                conv_state),
                                ("b.c", ".c", "b.c"), ("b.c", "b.c"))
    xbc = F.silu(xbc)  # mamba2: silu AFTER the causal conv
    xs, B, C = torch.split(xbc, [d_inner, state_dim, state_dim], dim=-1)
    xs = xs.reshape(b, S, n_heads, head_dim)
    dt = F.softplus(dt + p["dt_bias"])  # (b,S,H)
    A = -torch.exp(p["A_log"])  # (H,) negative

    if ssm_cache is None:
        y, _ = ssd_scan(xs, dt, A, B, C, p["D"], chunk=chunk)
        new_cache = None
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per step, got S={S}")
        y, final_state = ssd_decode_step(
            ssm_cache["state"], xs[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
            p["D"])
        y = y[:, None]
        new_cache = {"conv": new_conv, "state": final_state}

    y = y.reshape(b, S, d_inner)
    y = y * F.silu(z)  # gating
    return y @ p["w_out"], new_cache
