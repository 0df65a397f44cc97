"""Step builders for the prefill and decode cells.

The port of ``make_prefill_step`` and ``make_decode_step`` from the
reference's ``repro.launch.steps``.  The steps are plain functions (PyTorch
runs eagerly; nothing is traced); training steps and the dry-run's
abstract inputs wait for ``optim``.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models import serving as S


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
