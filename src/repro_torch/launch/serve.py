"""Serving loop: batched greedy decode with KV and SSM caches.

The port of the reference's ``repro.launch.serve``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b \
        --tokens 32 [--device cpu]

greedily decodes a batch of random prompts on the reduced config, on the
card unless ``--device`` says otherwise; :func:`serve` takes
``reduced=False`` for the full config.  The prompt is
prefilled by repeated decode, as in the reference, so one step serves every
position: step ``i`` writes its token at cache position ``i``.  A VLM's
vision stub and Whisper's frame stub are random bf16 inputs, as in the
reference, projected into the cross caches once before the loop.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ArchConfig, get_config
from repro_torch.core import resolve_device
from repro_torch.models.model import init_params
from repro_torch.models.serving import (
    decode_step,
    init_caches,
    prefill_cross_caches,
)


def serve(arch: str | ArchConfig, *, batch: int = 4, prompt_len: int = 8,
          new_tokens: int = 24, reduced: bool = True, seed: int = 0,
          device=None) -> tuple[torch.Tensor, float]:
    """Decode ``new_tokens`` greedy tokens after random ``prompt_len``-token
    prompts for ``batch`` sequences of ``arch``, an architecture id or a
    config (one cut in depth to fit a card, say).  Returns ``(tokens
    (batch, new_tokens), tokens/s)``, the rate over the whole loop (prompt
    steps included), ended by a device synchronize."""
    dev = resolve_device(device)
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, seed, device=dev)
    max_seq = prompt_len + new_tokens
    caches = init_caches(cfg, batch, max_seq, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    vision = frames = None
    if cfg.family == "vlm":
        vision = torch.randn((batch, cfg.vis_seq, cfg.d_model), generator=gen,
                             device=dev, dtype=torch.bfloat16)
    if cfg.kind == "encdec":
        frames = torch.randn((batch, cfg.enc_seq, cfg.d_model), generator=gen,
                             device=dev, dtype=torch.bfloat16)
    caches = prefill_cross_caches(cfg, params, caches, vision=vision,
                                  frames=frames)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           device=dev)
    out_tokens = []
    tok = prompt[:, :1]
    t0 = time.perf_counter()
    for i in range(max_seq - 1):
        logits, caches = decode_step(cfg, params, tok, caches, i)
        nxt = torch.argmax(logits, dim=-1)[:, None]
        tok = prompt[:, i + 1:i + 2] if i + 1 < prompt_len else nxt
        if i + 1 >= prompt_len:
            out_tokens.append(nxt)
    out = torch.cat(out_tokens, dim=1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    return out, batch * out.shape[1] / dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    gen, tps = serve(args.arch, batch=args.batch, new_tokens=args.tokens,
                     device=args.device)
    print(f"generated {tuple(gen.shape)} tokens at {tps:.1f} tok/s"
          f" (reduced config, {gen.device})")
    print(gen[:, :12])


if __name__ == "__main__":
    main()
