"""End-to-end training loop:

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek_7b \
        [--steps 100] [--seq-len 256] [--global-batch 8] [--full] \
        [--ckpt-dir DIR] [--device cpu]

The port of the reference's ``repro.launch.train`` on one device (the card
unless ``--device`` says otherwise): the deterministic data pipeline,
AdamW, checkpoint/restart and the straggler detector's hooks, on the
reduced config unless ``--full``.  One process drives one device, so no
mesh is registered and the model's sharding constraints are the identity;
the sharded steps of a production mesh are planned by the dry run
(:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ArchConfig, get_config
from repro_torch.core import resolve_device
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import init_params
from repro_torch.runtime.straggler import StragglerDetector


def train(
    arch: str | ArchConfig,
    *,
    steps: int = 100,
    reduced: bool = True,
    seq_len: int = 256,
    global_batch: int = 8,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    resume: bool = True,
    log_every: int = 10,
    microbatches: int = 1,
    device=None,
) -> list[float]:
    """Train ``arch`` (an architecture id, or a config: one cut in depth to
    fit a card, say) from seed-0 params for steps ``0 .. steps - 1`` on
    ``batch_at(DataConfig(vocab, seq_len, global_batch), step)``; with
    ``ckpt_dir``, resume after its newest complete checkpoint (when
    ``resume``) and save params and optimizer state at every nonzero step
    that ``ckpt_every`` divides.  A VLM's vision stub and Whisper's frame
    stub are bf16 zeros, as in the reference.  Returns the losses of the
    steps run."""
    dev = resolve_device(device)
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, 0, device=dev)
    step_fn, opt = make_train_step(cfg, microbatches=microbatches)
    opt_state = opt.init(params)

    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                          global_batch=global_batch)
    start_step = 0
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ckpt and resume:
        latest = ckpt.latest_complete()
        if latest is not None:
            state = ckpt.restore(latest, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = latest + 1
            print(f"resumed from checkpoint step {latest}")

    detector = StragglerDetector(n_hosts=1)
    losses = []
    t_last = time.time()
    for step in range(start_step, steps):
        batch = {"tokens": torch.from_numpy(
            batch_at(data_cfg, step)["tokens"]).to(dev)}
        if cfg.family == "vlm":
            batch["vision"] = torch.zeros(
                (global_batch, cfg.vis_seq, cfg.d_model), dtype=torch.bfloat16,
                device=dev)
        if cfg.kind == "encdec":
            batch["frames"] = torch.zeros(
                (global_batch, cfg.enc_seq, cfg.d_model), dtype=torch.bfloat16,
                device=dev)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        detector.observe([time.time() - t_last])
        t_last = time.time()
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f}")
        if ckpt and step and step % ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": opt_state})
    if ckpt:
        ckpt.wait()
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    losses = train(
        args.arch,
        steps=args.steps,
        reduced=not args.full,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        ckpt_dir=args.ckpt_dir,
        device=args.device,
    )
    print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
