"""Whisper-large-v3 — encoder-decoder audio transformer.

[arXiv:2212.04356; unverified]  32L encoder + 32L decoder, d_model=1280
20H (kv=20) d_ff=5120 vocab=51866.  GELU MLP + LayerNorm (whisper family).
The conv frame frontend is a stub: callers pass precomputed frame
embeddings (1500 x d_model).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    kind="encdec",
    n_layers=32,
    enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    enc_seq=1500,
    act="gelu",
    norm="layernorm",
    source="arXiv:2212.04356",
)
