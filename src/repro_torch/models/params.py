"""Parameter specs: one source of truth for shapes and init scales.

The port of the reference's ``repro.models.params``.  Every leaf is
declared as ``P(shape, axes, scale)``; the same tree drives

* real initialization (truncated normal with fan-in scaling, from an
  explicit ``torch.Generator``);
* abstract initialization (the dry run): ``device="meta"`` tensors,
  nothing allocated (:func:`abstract_tree`);
* sharding: the ``axes`` tuple of logical names is resolved against a mesh
  by :mod:`repro_torch.parallel.sharding` (:func:`axes_tree`); on one GPU
  nothing is sharded.

Trees are nested dicts; :func:`leaves` and :func:`tree_map` walk them in
sorted-key order, the order ``jax.tree`` flattens a dict in.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class P:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    scale: float | str = "fan_in"  # "fan_in" | "zero" | "one" | float

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes}"
                             " differ in rank")


def leaves(tree: Any) -> list:
    """The leaves of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` applied to every leaf of a nested dict; the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_unflatten(like: Any, flat) -> Any:
    """The tree of ``like``'s structure whose leaves are ``flat``, taken
    in :func:`leaves` order."""
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


def _init_leaf(gen: torch.Generator, spec: P, dtype) -> torch.Tensor:
    kw = dict(dtype=dtype, device=gen.device)
    if spec.scale == "zero":
        return torch.zeros(spec.shape, **kw)
    if spec.scale == "one":
        return torch.ones(spec.shape, **kw)
    if spec.scale == "fan_in":
        fan_in = spec.shape[0] if len(spec.shape) == 1 else math.prod(
            spec.shape[:-1])
        std = min(1.0, (1.0 / max(fan_in, 1)) ** 0.5)
    else:
        std = float(spec.scale)
    t = torch.empty(spec.shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def init_tree(specs: Any, gen: torch.Generator, dtype=torch.bfloat16):
    """Materialize a spec tree into real parameters on ``gen``'s device,
    drawing the leaves from ``gen`` in sorted-key order."""
    return tree_map(lambda s: _init_leaf(gen, s, dtype), specs)


def abstract_tree(specs: Any, dtype=torch.bfloat16):
    """Spec tree -> ``device="meta"`` tensors of the same shapes in
    ``dtype`` (no allocation; the dry run)."""
    return tree_map(
        lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), specs)


def axes_tree(specs: Any):
    """Spec tree -> logical-axes tree (same structure)."""
    return tree_map(lambda s: s.axes, specs)


def stack_specs(specs: Any, n: int, axis_name: str = "layers"):
    """Prepend a stacked (layer) dimension to every leaf of a layer spec."""
    return tree_map(
        lambda s: P((n,) + s.shape, (axis_name,) + s.axes, s.scale), specs)


def gqa_specs(cfg) -> dict:
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        "wq": P((d, H, Dh), ("embed", "heads", None)),
        "wk": P((d, Hkv, Dh), ("embed", "kv_heads", None)),
        "wv": P((d, Hkv, Dh), ("embed", "kv_heads", None)),
        "wo": P((H, Dh, d), ("heads", None, "embed")),
    }


def mla_specs(cfg) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.d_nope, cfg.d_rope, cfg.d_v
    return {
        "wq_a": P((d, r_q), ("embed", "lora")),
        "q_norm": P((r_q,), (None,), "one"),
        "wq_b": P((r_q, H, dn + dr), ("lora", "heads", None)),
        "wkv_a": P((d, r_kv), ("embed", "lora")),
        "kv_norm": P((r_kv,), (None,), "one"),
        "wk_rope": P((d, dr), ("embed", None)),
        "wk_b": P((r_kv, H, dn), ("lora", "heads", None)),
        "wv_b": P((r_kv, H, dv), ("lora", "heads", None)),
        "wo": P((H, dv, d), ("heads", None, "embed")),
    }


def swiglu_specs(d: int, f: int) -> dict:
    return {
        "w_gate": P((d, f), ("embed", "mlp")),
        "w_up": P((d, f), ("embed", "mlp")),
        "w_down": P((f, d), ("mlp", "embed")),
    }


def gelu_mlp_specs(d: int, f: int) -> dict:
    return {
        "w_in": P((d, f), ("embed", "mlp")),
        "w_out": P((f, d), ("mlp", "embed")),
    }


def moe_specs(cfg) -> dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return {
        "router": P((d, E), ("embed", None)),
        "w_gate": P((E, d, f), ("experts", "embed", None)),
        "w_up": P((E, d, f), ("experts", "embed", None)),
        "w_down": P((E, f, d), ("experts", None, "embed")),
    }


def mamba_specs(cfg) -> dict:
    d = cfg.d_model
    H, Pd, N, K = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    di = H * Pd
    conv_ch = di + 2 * N
    return {
        "w_in": P((d, 2 * di + 2 * N + H), ("embed", "mlp")),
        "conv_w": P((K, conv_ch), (None, "mlp")),
        "dt_bias": P((H,), (None,), "zero"),
        "A_log": P((H,), (None,), 0.5),
        "D": P((H,), (None,), "one"),
        "w_out": P((di, d), ("mlp", "embed")),
    }


def cross_attn_specs(cfg) -> dict:
    """One cross-attention layer: GQA projections over a K/V source, a
    pre-norm (with a bias under LayerNorm) and a ``tanh`` gate that starts
    at zero (Llama-Vision; Whisper's caller drops it)."""
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = {
        "wq": P((d, H, Dh), ("embed", "heads", None)),
        "wk": P((d, Hkv, Dh), ("embed", "kv_heads", None)),
        "wv": P((d, Hkv, Dh), ("embed", "kv_heads", None)),
        "wo": P((H, Dh, d), ("heads", None, "embed")),
        "gate": P((1,), (None,), "zero"),
        "norm": P((d,), (None,), "one"),
    }
    if cfg.norm == "layernorm":
        s["norm_b"] = P((d,), (None,), "zero")
    return s
