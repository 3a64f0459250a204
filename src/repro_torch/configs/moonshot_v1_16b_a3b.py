"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf] 48L d_model=2048 16H (GQA kv=16)
d_ff=1408 (per expert) vocab=163840, MoE 64e top-6. Same values as the
JAX package's config.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163_840,
    num_experts=64,
    experts_per_token=6,
    moe_every=1,
    rope_theta=50_000.0,
))
