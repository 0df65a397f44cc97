"""The reference's assigned input shapes (seq_len x global_batch).

The port of ``SHAPES`` from ``repro.configs.shapes``; the cell matrix and
its support rules stay with the reference's dry-run, which the port does
not have.

* ``train_4k``    — 4,096 x 256, a training step
* ``prefill_32k`` — 32,768 x 32, the prefill forward (causal)
* ``decode_32k``  — one new token against a 32,768 cache, batch 128
* ``long_500k``   — one new token against a 524,288 cache, batch 1
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    step: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
