"""MiniCPM3-4B — dense with MLA (multi-head latent attention).

[hf:openbmb/MiniCPM3-4B; hf]  62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA dims from the HF config: q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32,
v_head 64.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    attn_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    d_nope=64,
    d_rope=32,
    d_v=64,
    d_head=96,  # nope + rope
    source="hf:openbmb/MiniCPM3-4B",
)
