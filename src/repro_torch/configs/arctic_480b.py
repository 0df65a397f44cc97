"""Snowflake Arctic 480B base — MoE 128e top-2 + dense residual MLP.

[hf:Snowflake/snowflake-arctic-base; hf]  35L d_model=7168 56H (GQA kv=8)
expert d_ff=4864 vocab=32000.  Arctic is a "dense-MoE hybrid": every layer
sums a dense residual MLP and a 128-expert top-2 MoE.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,          # dense residual MLP width
    vocab=32000,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    rope_theta=1e4,
    moment_dtype="bfloat16",  # 480B params: fp32 moments exceed single-pod HBM
    moe_group_tokens=512,  # keeps (G,T,E,C) dispatch temps ~tens of MB/device
    source="hf:Snowflake/snowflake-arctic-base",
)
