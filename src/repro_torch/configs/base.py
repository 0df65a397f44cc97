"""ArchConfig: the architecture description + registry.

The port of the reference's ``repro.configs.base``, fields unchanged.  One
config file per ported architecture lives next to this module; each exposes
``CONFIG``.  ``get_config(name)`` resolves from the registry, which lists
all ten of the reference's architectures (the MoE, dense (GQA or MLA
attention), VLM, hybrid, SSM and encoder-decoder audio families);
``cfg.reduced()`` builds the family-preserving small config used by the
CPU tests.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # defaults to d_model // n_heads

    # attention
    attn_kind: str = "gqa"  # gqa | mla
    rope_theta: float = 1e4
    window: int = 0  # sliding-window size for local-attn layers (hybrid)
    global_layers: Tuple[int, ...] = ()  # full-attn layer ids among sliding

    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    d_nope: int = 0
    d_rope: int = 0
    d_v: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.0
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE

    # SSM / hybrid
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_state: int = 0
    ssm_conv: int = 4
    ssd_chunk: int = 256

    # structure
    kind: str = "decoder"  # decoder | encdec
    enc_layers: int = 0
    enc_seq: int = 0  # stub frontend sequence length (whisper frames)
    cross_every: int = 0  # vlm: a cross-attn layer every N layers
    vis_seq: int = 0  # stub vision tokens
    act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False

    # numerics / distribution
    dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots
    moment_dtype: str = "float32"  # adam moment dtype (bf16 for huge MoE)
    attn_chunk: int = 1024  # flash chunk (prefill)
    moe_group_tokens: int = 4096  # target tokens per dispatch group

    # provenance
    source: str = ""

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embedding + layers)."""
        import math

        from repro_torch.models.model import build_param_specs
        from repro_torch.models.params import leaves

        return sum(math.prod(s.shape) for s in leaves(build_param_specs(self)))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed experts count top_k/E)."""
        total = self.param_count()
        if not self.n_experts:
            return total
        expert_p = (
            self.n_layers * self.n_experts * 3 * self.d_model * self.moe_d_ff
        )
        active_expert_p = expert_p * self.top_k / self.n_experts
        return int(total - expert_p + active_expert_p)

    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        return replace(
            self,
            n_layers=2,
            enc_layers=min(self.enc_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_head=16,
            d_ff=128,
            vocab=256,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            d_nope=8 if self.d_nope else 0,
            d_rope=8 if self.d_rope else 0,
            d_v=16 if self.d_v else 0,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 2),
            top_k=min(self.top_k, 2),
            moe_d_ff=32 if self.moe_d_ff else 0,
            ssm_heads=4 if self.ssm_heads else 0,
            ssm_head_dim=8 if self.ssm_head_dim else 0,
            ssm_state=8 if self.ssm_state else 0,
            ssd_chunk=8,
            window=16 if self.window else 0,
            global_layers=(0,) if self.global_layers else (),
            enc_seq=min(self.enc_seq, 16),
            vis_seq=min(self.vis_seq, 16),
            cross_every=2 if self.cross_every else 0,
            attn_chunk=16,
            moe_group_tokens=32,
            remat="none",
        )


# the reference's architectures, in its order
ARCH_IDS = (
    "arctic_480b",
    "qwen2_moe_a2_7b",
    "minicpm3_4b",
    "deepseek_7b",
    "glm4_9b",
    "phi4_mini_3_8b",
    "llama32_vision_11b",
    "hymba_1_5b",
    "mamba2_780m",
    "whisper_large_v3",
)


def get_config(name: str) -> ArchConfig:
    """Resolve an architecture id (dashes or underscores) to its config."""
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    """Every architecture's config, keyed by id in :data:`ARCH_IDS` order."""
    return {a: get_config(a) for a in ARCH_IDS}
