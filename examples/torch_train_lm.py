"""End-to-end LM training on the PyTorch port: a ~100M-param dense model
trained for a few hundred steps with the full stack — data pipeline, AdamW,
checkpoint/restart.

The port of ``examples/train_lm.py``: the DeepSeek-7B family scaled to 12
layers x 768 (:func:`lm100m_config`), handed to
``repro_torch.launch.train.train`` as a config.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
      PYTHONPATH=src python examples/torch_train_lm.py --steps 10 --device cpu

Checkpoints go to ``--ckpt-dir`` (default ``repro_torch_lm_ckpt`` in the
temporary directory, ``$TMPDIR`` or ``/tmp``; not the reference example's
directory, since checkpoints cross both packages) every 50 steps, and a run
resumes after the newest complete checkpoint there: a second run with the
same directory continues the first instead of starting over, and fails when
the checkpoint already holds every step asked for.  Give a fresh directory
for a fresh run.  Without ``--device`` it runs on the CUDA card and exits
non-zero when there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import ArchConfig, get_config
from repro_torch.core import resolve_device
from repro_torch.launch.train import train

# not the reference example's /tmp/repro_lm_ckpt: checkpoints cross both
# packages, so a run there would resume from the reference's
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt")
# ~100M params: deepseek-7b family scaled to 12 layers x 768
LM100M = dict(
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
    d_ff=2048, vocab=32000, remat="none",
)


def lm100m_config(**overrides) -> ArchConfig:
    """DeepSeek-7B's config with :data:`LM100M`'s fields, then
    ``overrides`` (a cut in depth or width, say)."""
    return dataclasses.replace(get_config("deepseek_7b"),
                               **{**LM100M, **overrides})


def train_lm(argv: list[str] | None = None, *,
             config: ArchConfig | None = None) -> list[float]:
    """Train ``config`` (default :func:`lm100m_config`) as the command line
    says; returns the losses of the steps this run took."""
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = lm100m_config() if config is None else config
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"training {cfg.n_layers}L d_model={cfg.d_model} vocab={cfg.vocab}"
          f" on {where}, checkpoints in {args.ckpt_dir}")
    return train(
        cfg,
        steps=args.steps,
        reduced=False,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        ckpt_dir=args.ckpt_dir,
        log_every=20,
        device=dev,
    )


def main(argv: list[str] | None = None, *,
         config: ArchConfig | None = None) -> int:
    """:func:`train_lm`, failing unless the loss fell over the steps this
    run took.  A run that took no step (its checkpoint already held them
    all) fails; a resumed run that took one has no loss change to check."""
    losses = train_lm(argv, config=config)
    if not losses:
        print("ran 0 steps: the checkpoint directory already holds every"
              " step asked for; give a fresh --ckpt-dir or more --steps")
        return 1
    if len(losses) == 1:
        print("ran 1 step after the checkpoint: no loss change to check")
        return 0
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")
    assert losses[-1] < losses[0], "training must reduce loss"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
