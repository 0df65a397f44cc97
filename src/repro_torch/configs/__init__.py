"""Architecture configs: one module per architecture.

``get_config("<id>")`` resolves the registry (the MoE family's
``arctic_480b`` and ``qwen2_moe_a2_7b``, the dense family's
``minicpm3_4b`` (MLA attention), ``deepseek_7b``, ``glm4_9b`` and
``phi4_mini_3_8b``, the VLM ``llama32_vision_11b``, the hybrid
``hymba_1_5b``, the SSM family's ``mamba2_780m`` and the encoder-decoder
``whisper_large_v3``: all ten of the reference's); shapes live in
:mod:`repro_torch.configs.shapes`.
"""

from .base import ARCH_IDS, ArchConfig, all_configs, get_config
from .shapes import SHAPES, ShapeConfig, cells

__all__ = ["ARCH_IDS", "ArchConfig", "SHAPES", "ShapeConfig", "all_configs",
           "cells", "get_config"]
