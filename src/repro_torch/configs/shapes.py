"""The reference's assigned input shapes (seq_len x global_batch).

The port of ``SHAPES``, ``cell_supported`` and ``cells`` from
``repro.configs.shapes``: the dry run's cell matrix.

* ``train_4k``    — 4,096 x 256, a training step
* ``prefill_32k`` — 32,768 x 32, the prefill forward (causal)
* ``decode_32k``  — one new token against a 32,768 cache, batch 128
* ``long_500k``   — one new token against a 524,288 cache, batch 1; it
  needs sub-quadratic attention, so only the SSM and hybrid families run
  it, and the other cells are recorded as skipped
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


def cell_supported(cfg, shape: ShapeConfig) -> tuple[bool, str]:
    """(supported, reason-if-not) for one (arch x shape) cell."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (assignment: skip + record)"
        )
    return True, ""


def cells(configs: dict):
    """Yield ``(arch_id, cfg, shape, supported, reason)`` for the full
    matrix of ``configs`` (e.g. :func:`repro_torch.configs.base.all_configs`)
    against every shape."""
    for arch_id, cfg in configs.items():
        for shape in SHAPES.values():
            ok, why = cell_supported(cfg, shape)
            yield arch_id, cfg, shape, ok, why
