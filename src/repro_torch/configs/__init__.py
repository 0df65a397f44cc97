"""Architecture configs: one module per ported architecture.

``get_config("<id>")`` resolves the registry (the MoE family's
``arctic_480b`` and ``qwen2_moe_a2_7b``, the dense family's
``minicpm3_4b`` (MLA attention), ``deepseek_7b``, ``glm4_9b`` and
``phi4_mini_3_8b``, the hybrid ``hymba_1_5b`` and the SSM family's
``mamba2_780m`` so far); shapes live in :mod:`repro_torch.configs.shapes`.
"""

from .base import ARCH_IDS, ArchConfig, get_config
from .shapes import SHAPES, ShapeConfig

__all__ = ["ARCH_IDS", "ArchConfig", "SHAPES", "ShapeConfig", "get_config"]
