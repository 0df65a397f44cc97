"""Gradient compression: int8 block quantization with error feedback.

The port of the reference's ``repro.optim.grad_compress``: gradients are
quantized to int8 with one absmax scale per block of :data:`BLOCK` values
before the data-parallel reduction, and the quantization residual is
carried in a bfloat16 error-feedback buffer and added back the next step.
Rounding is half to even, as ``jnp.round``'s.  :func:`compressed_mean`,
the reference's int8 all-reduce inside ``shard_map``, is a
``torch.distributed`` all-reduce over a process group.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.params import leaves, tree_map, tree_unflatten

BLOCK = 256


class CompressState(NamedTuple):
    error: Any  # error-feedback tree (same shapes as grads, bf16)


def init_state(params) -> CompressState:
    return CompressState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device),
        params))


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``g`` flattened, zero-padded to whole blocks -> ``(q (n, BLOCK)
    int8, scale (n, 1) float32)``."""
    flat = g.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


@torch.no_grad()
def compress_grads(grads, state: CompressState):
    """Quantize grads (with error feedback added) to int8; return
    (dequantized grads for the update, new error state)."""

    def one(g, e):
        g32 = g.to(torch.float32) + e.to(torch.float32)
        q, scale = _quantize(g32)
        deq = _dequantize(q, scale, g.shape)
        return deq, (g32 - deq).to(torch.bfloat16)

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(state.error))]
    deq, err = (tree_unflatten(grads, part) for part in zip(*out))
    return deq, CompressState(error=err)


def compressed_mean(g: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``g`` over the ranks of ``group`` (``None``: the default
    group), reduced from int8 blocks: each rank quantizes ``g`` in float32,
    the blocks times their scales (float32, as the reference's int32 times
    float32 scale) are summed by ``all_reduce``, divided by the group's
    size, cut to ``g``'s elements and cast back to ``g``'s type."""
    import torch.distributed as dist

    q, scale = _quantize(g.to(torch.float32))
    total = q.to(torch.int32) * scale
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    flat = (total / n).reshape(-1)[:g.numel()]
    return flat.reshape(g.shape).to(g.dtype)
