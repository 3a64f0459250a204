"""arctic-480b — Snowflake Arctic: 128-expert top-2 MoE plus an
always-on dense residual FFN in parallel (the "dense-MoE hybrid").

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 (per expert) vocab=32000, MoE 128e top-2. Same values as the
JAX package's config.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    num_experts=128,
    experts_per_token=2,
    moe_every=1,
    dense_residual_ff=4864,   # parallel dense FFN branch (arctic residual)
    rope_theta=10_000.0,
))
