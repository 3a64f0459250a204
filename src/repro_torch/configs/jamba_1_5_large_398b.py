"""jamba-1.5-large-398b — AI21 Jamba: Mamba + attention 1:7 interleave,
16-expert top-2 MoE on every other layer.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2. Same values as the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,              # MoE on even layers within the period
    attn_every=8,             # 1 attention : 7 mamba per 8-layer period
    d_state=16,
    conv_width=4,
    mamba_expand=2,
    rope_theta=10_000.0,
))
