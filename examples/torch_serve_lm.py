"""Batched serving on the PyTorch port: greedy decode with KV and SSM
caches on a dense, a state-space and a mixture-of-experts decoder.

The port of ``examples/serve_lm.py``: ``repro_torch.launch.serve.serve`` on
each architecture's reduced config, batch 2, 12 new tokens.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py               # the card
      PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

Without ``--device`` it runs on the CUDA card and exits non-zero when there
is none.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import resolve_device
from repro_torch.launch.serve import serve

ARCHS = ("deepseek_7b", "mamba2_780m", "qwen2_moe_a2_7b")
BATCH, NEW_TOKENS = 2, 12


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for arch in ARCHS:
        gen, tps = serve(arch, batch=BATCH, new_tokens=NEW_TOKENS, device=dev)
        print(f"{arch:18s} generated {gen.shape[1]} tokens/seq at"
              f" {tps:.1f} tok/s (reduced config, {where})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
