"""Mixture-of-Experts: top-k token-choice routing with capacity dispatch.

The port of the reference's ``repro.models.moe``: GShard-style dense
dispatch.  Tokens are organised into groups ``(G, T_g, d)``; each group
dispatches into ``(E, C)`` expert buffers through one-hot einsums, the
experts run as one grouped SwiGLU over ``(G, E, C, d)``, and the results
combine back with the routing weights.  Claims past an expert's capacity
are dropped and fall through the residual connection.

Two PyTorch calls differ from their JAX namesakes where it matters here:
``torch.topk`` does not put the lower index first on ties, where
``lax.top_k`` does, so routing takes a stable descending sort; and
``F.one_hot`` raises on an index past its classes, where ``jax.nn.one_hot``
gives a zero row, so a dropped claim's slot goes to one extra class that is
cut away.  The dense dispatch itself stays: every product is the
reference's einsum, so the sums run over the same terms.

Shared experts (Qwen1.5-MoE) and a parallel dense residual MLP (Arctic)
are composed in :mod:`repro_torch.models.blocks`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def route_topk(logits: torch.Tensor, top_k: int):
    """Top-k routing: returns ``(expert_idx (..., k), weights (..., k))``.

    Ties go to the lower expert index (``lax.top_k``'s order); the weights
    are the float32 softmax over the selected experts' logits (Mixtral /
    Qwen2-MoE convention)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    w = torch.softmax(vals[..., :top_k].to(torch.float32), dim=-1)
    return idx[..., :top_k], w


def dispatch_combine(x, expert_idx, weights, n_experts: int, capacity: int):
    """Build the dispatch and combine tensors with per-expert capacity.

    ``x (G, T, d)`` grouped tokens, ``expert_idx`` and ``weights (G, T,
    k)``.  A claim's slot in its expert's buffer is the count of earlier
    claims on that expert within the group, claims ordered token by token
    and choice by choice (the exclusive cumsum in int32); a claim at or
    past ``capacity`` is dropped.  Returns ``(dispatched (G, E, C, d),
    combine (G, T, E, C))``, the one-hots in ``x``'s type."""
    g, t, k = expert_idx.shape
    onehot = F.one_hot(expert_idx, n_experts).to(torch.int32)  # (G,T,k,E)
    claims = onehot.reshape(g, t * k, n_experts)
    pos = (torch.cumsum(claims, dim=1, dtype=torch.int32) - claims).reshape(
        g, t, k, n_experts)
    pos_sel = torch.gather(pos, -1, expert_idx[..., None])[..., 0]  # (G,T,k)
    kept = pos_sel < capacity
    oh_e = onehot.to(x.dtype) * kept.to(x.dtype)[..., None]  # (G,T,k,E)
    # a dropped claim's slot is class `capacity`, cut away: a zero row
    slot = torch.where(kept, pos_sel, capacity).long()
    oh_c = F.one_hot(slot, capacity + 1)[..., :capacity].to(x.dtype)
    dispatch = torch.einsum("gtke,gtkc->gtec", oh_e, oh_c)  # (G,T,E,C) 0/1
    combine = torch.einsum("gtke,gtkc->gtec", oh_e,
                           oh_c * weights[..., None].to(x.dtype))
    dispatched = torch.einsum("gtec,gtd->gecd", dispatch, x)
    return dispatched, combine


def experts(p: dict, dispatched: torch.Tensor) -> torch.Tensor:
    """The experts as one grouped SwiGLU: ``(G, E, C, d) -> (G, E, C, d)``."""
    gate = F.silu(torch.einsum("gecd,edf->gecf", dispatched, p["w_gate"]))
    up = torch.einsum("gecd,edf->gecf", dispatched, p["w_up"])
    return torch.einsum("gecf,efd->gecd", gate * up, p["w_down"])


def moe_ffn(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.0, groups: int = 1):
    """Full MoE FFN block on ``x (B, S, d)``: the router in float32, top-k
    routing, dispatch with capacity ``max(1, int(T_g k f) // E)``, the
    experts and the combine.  Returns ``(y (B, S, d), aux)`` with the
    Switch load-balance loss ``E * sum(frac_e * mean_prob_e)``.  A token
    count that ``groups`` does not divide raises ``ValueError``."""
    b, s, d = x.shape
    tokens = b * s
    if tokens % groups:
        raise ValueError(f"{tokens} tokens do not split into {groups} groups")
    tg = tokens // groups
    xg = x.reshape(groups, tg, d)
    f32 = torch.float32
    logits = torch.einsum("gtd,de->gte", xg.to(f32), p["router"].to(f32))
    idx, w = route_topk(logits, top_k)
    capacity = max(1, int(tg * top_k * capacity_factor) // n_experts)
    dispatched, combine = dispatch_combine(xg, idx, w, n_experts, capacity)
    y = torch.einsum("gtec,gecd->gtd", combine, experts(p, dispatched))

    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(idx[..., 0], n_experts).to(f32).mean(dim=(0, 1))
    aux = n_experts * torch.sum(frac * probs.mean(dim=(0, 1)))
    return y.reshape(b, s, d).to(x.dtype), aux
