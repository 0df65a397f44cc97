"""Mamba2-780m — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified]  48L d_model=1536 ssm_state=128 vocab=50280.
d_inner = 2*d_model = 3072, head_dim 64 -> 48 ssm heads.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab=50280,
    ssm_heads=48,
    ssm_head_dim=64,
    ssm_state=128,
    source="arXiv:2405.21060",
)
