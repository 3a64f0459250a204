"""qwen2.5-32b — dense GQA with QKV bias.

[hf:Qwen/Qwen2.5-0.5B family; hf] 64L d_model=5120 40H (GQA kv=8)
d_ff=27648 vocab=152064. Same values as the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27_648,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
))
