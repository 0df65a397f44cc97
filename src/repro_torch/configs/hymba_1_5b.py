"""Hymba-1.5B — hybrid: parallel attention + mamba heads per layer.

[arXiv:2411.13676; hf]  32L d_model=1600 25H (kv=5) d_ff=5504 ssm_state=16
vocab=32001.  Sliding-window attention everywhere except 3 global layers
(first / middle / last), mamba heads in parallel within every layer.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    window=1024,
    global_layers=(0, 15, 31),
    ssm_heads=50,
    ssm_head_dim=64,   # d_inner = 3200 = 2 * d_model
    ssm_state=16,
    source="arXiv:2411.13676",
)
