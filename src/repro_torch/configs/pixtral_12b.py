"""pixtral-12b — pixtral-ViT frontend (a stub) + mistral-nemo backbone.

[hf:mistralai/Pixtral-12B-2409; unverified] 40L d_model=5120 32H
(GQA kv=8) d_ff=14336 vocab=131072. The ViT frontend is a stub, as in
the JAX package: the model is fed precomputed patch embeddings
``[B, S, d_model]`` (``Model.input_specs``), normed by ``in_norm``; only
the transformer backbone is modeled. Decode feeds tokens. Same values
as the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    input_kind="embeddings",
    rope_theta=1_000_000.0,
))
