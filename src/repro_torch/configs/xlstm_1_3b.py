"""xlstm-1.3b — sLSTM + mLSTM blocks, one sLSTM per 8-layer period.

[arXiv:2405.04517] 48L d_model=2048 4H d_ff=0 (the xLSTM blocks carry
their own up/down projections) vocab=50304. Same values as the JAX
package's config; the mLSTM head width is ``2 * d_model / num_heads``
(1024), not ``head_dim``.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50_304,
    slstm_every=8,
))
