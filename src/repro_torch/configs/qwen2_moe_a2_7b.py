"""Qwen1.5-MoE-A2.7B — 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (kv=16) moe d_ff=1408
vocab=151936.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,           # shared-expert aggregate width (4 x 1408)
    vocab=151936,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
    rope_theta=1e6,
    moe_group_tokens=512,  # keeps (G,T,E,C) dispatch temps ~tens of MB/device
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
