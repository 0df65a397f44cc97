"""Llama-3.2-11B-Vision — dense decoder + gated cross-attn image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  40L d_model=4096 32H (kv=8)
d_ff=14336 vocab=128256.  A gated cross-attention layer every 5 layers (8
total); the vision tower is a stub: callers pass precomputed patch
embeddings (vis_seq x d_model).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    cross_every=5,
    vis_seq=1601,  # 1 tile x (40x40 patches + cls)
    rope_theta=5e5,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
