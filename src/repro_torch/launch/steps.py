"""Step builders for the train, prefill and decode cells.

The port of the reference's ``repro.launch.steps``: ``make_optimizer``,
``make_train_step``, ``make_prefill_step`` and ``make_decode_step`` return
plain functions (PyTorch runs them eagerly; the dry run traces them), and
:func:`input_specs` returns ``device="meta"`` stand-ins of every model
input of a cell (nothing allocated).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models import model as M
from repro_torch.models import serving as S
from repro_torch.models.params import leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.parallel.constraints import split_rows

MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_optimizer(cfg: ArchConfig) -> AdamW:
    return AdamW(moment_dtype=MOMENT_DTYPES[cfg.moment_dtype])


def _value_and_grad(cfg, params, batch):
    """``lm_loss`` and its gradient for every param leaf, in
    :func:`~repro_torch.models.params.leaves` order (zeros for a leaf the
    loss does not reach, as ``jax.grad`` gives)."""
    ps = tree_map(lambda t: t.detach().requires_grad_(), params)
    flat = leaves(ps)
    loss = M.lm_loss(cfg, ps, batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(flat, grads)]


def _split(name, t, microbatches):
    """``t`` as ``(microbatches, B / microbatches, ...)``
    (:func:`~repro_torch.parallel.constraints.split_rows`); a batch that
    does not divide evenly is refused, as the reference's reshape does."""
    if t.shape[0] % microbatches:
        raise ValueError(f"batch[{name!r}] has {t.shape[0]} rows, which "
                         f"do not split into {microbatches} microbatches")
    return split_rows(t, microbatches)


def make_train_step(cfg: ArchConfig, *, microbatches: int = 1,
                    accum_dtype=torch.float32, grad_dtype=None):
    """``(train_step, opt)``: ``train_step(params, opt_state, batch) ->
    (new_params, new_state, loss)``, one AdamW update of ``lm_loss`` at
    the learning rate ``warmup_cosine(opt_state.step)``, read before the
    step counts up, so a run's first step moves nothing.  The params stay
    untouched (the update is functional).

    With ``microbatches > 1`` the batch splits along its first dimension
    into equal parts (a ``ValueError`` if it does not divide); each part's
    gradient is divided by ``microbatches`` and added into
    ``accum_dtype`` buffers, its loss likewise, and one update follows.
    ``grad_dtype`` casts a single batch's gradients before the update
    (the reference's reduce-bytes option)."""
    opt = make_optimizer(cfg)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = _value_and_grad(cfg, params, batch)
            if grad_dtype is not None:
                grads = [g.to(grad_dtype) for g in grads]
        else:
            loss = 0.0
            grads = [torch.zeros_like(p, dtype=accum_dtype)
                     for p in leaves(params)]
            parts = {k: _split(k, v, microbatches) for k, v in batch.items()}
            for i in range(microbatches):
                loss_i, g_i = _value_and_grad(
                    cfg, params, {k: v[i] for k, v in parts.items()})
                loss = loss + loss_i / microbatches
                for a, g in zip(grads, g_i):
                    a.add_(g.to(a.dtype) / microbatches)
        lr_scale = warmup_cosine(opt_state.step)
        new_params, new_state = opt.update(tree_unflatten(params, grads),
                                           opt_state, params, lr_scale)
        return new_params, new_state, loss

    return train_step, opt


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        """``batch["tokens"] (B, S)`` -> the last position's logits
        ``(B, V)``; a VLM's ``batch["vision"]`` and Whisper's
        ``batch["frames"]`` stubs ride along.  Attention runs
        flash-chunked, as in the reference, so an attention family's ``S``
        must be a multiple of ``cfg.attn_chunk`` (a ``ValueError``
        otherwise)."""
        hidden, _ = M.hidden_forward(cfg, params, batch["tokens"],
                                     mode="prefill", chunked=True,
                                     vision=batch.get("vision"),
                                     frames=batch.get("frames"))
        # project ONLY the last position: (B, S, V) logits never materialize
        return M.logits_fn(cfg, params, hidden[:, -1:, :])[:, 0, :]

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def step(params, tokens, caches, cache_index):
        """One token per sequence -> ``(logits (B, V), caches)``; the
        caches are updated in place."""
        return S.decode_step(cfg, params, tokens, caches, cache_index)

    return step


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """``device="meta"`` stand-ins for every model input of this cell.

    Modality frontends are stubs, as in the reference: a VLM gets
    precomputed patch embeddings, Whisper precomputed frame embeddings.
    Tokens are int32, as the reference's."""
    B, Sq = shape.global_batch, shape.seq_len
    dt = M._dtype(cfg)
    if shape.step in ("train", "prefill"):
        n = Sq + 1 if shape.step == "train" else Sq
        specs = {"tokens": _meta((B, n), torch.int32)}
        if cfg.family == "vlm":
            specs["vision"] = _meta((B, cfg.vis_seq, cfg.d_model), dt)
        if cfg.kind == "encdec":
            specs["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), dt)
        return specs
    # decode: one new token against a seq_len cache
    return {"tokens": _meta((B, 1), torch.int32),
            "caches": S.abstract_caches(cfg, B, Sq),
            "cache_index": _meta((), torch.int32)}
