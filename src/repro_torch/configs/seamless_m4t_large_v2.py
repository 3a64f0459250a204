"""seamless-m4t-large-v2 — encoder-decoder, multimodal (a speech stub).

[arXiv:2308.11596; hf] 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206. The speech frontend is a stub, as in the JAX package: the
encoder is fed precomputed frame embeddings (``Model.input_specs``);
the decoder takes tokens and cross-attends to the encoder's output
(``models/encdec.py``). Vocab pads 256206 -> 256256 (a multiple of
256). Same values as the JAX package's config.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,            # decoder depth
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    input_kind="embeddings",
    norm="layernorm",
    act="gelu",
    rope_theta=10_000.0,
))
