"""Model configurations of the LM stack: the ``ModelConfig`` schema, the
four input-shape cells (``ShapeConfig``, ``SHAPES``, ``cell_applicable``),
the quantization policies and the registry, as ``repro.configs.base``.

Each architecture module registers one ``ModelConfig`` at import;
``get_config(name)`` and ``list_configs()`` import the package first so
the registry is full. Every family of the JAX package is registered:
dense, moe, hybrid, ssm, vlm (pixtral-12b, fed patch embeddings) and
encdec (seamless-m4t-large-v2, fed frame embeddings). A cell is one
``(ModelConfig, ShapeConfig)`` pair; ``cell_applicable`` says which of
the 40 run, with the JAX package's reasons word for word.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.binarize import QuantMode
from repro_torch.models.common import QuantPolicy


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (the JAX package's fields and
    defaults; ``dtype`` is a ``torch.dtype``)."""

    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1             # MoE FFN on layers where i % moe_every == 0
    dense_residual_ff: int = 0     # arctic: parallel always-on dense FFN width
    capacity_factor: float = 1.25
    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0        # 0 = full attention
    # --- hybrid (jamba): attention layer every `attn_every`, rest mamba ---
    attn_every: int = 0
    d_state: int = 16
    conv_width: int = 4
    mamba_expand: int = 2
    # --- xlstm ---
    slstm_every: int = 0           # sLSTM block every N layers, rest mLSTM
    # --- enc-dec ---
    encoder_layers: int = 0
    # --- modality frontend stub ---
    input_kind: str = "tokens"     # tokens | embeddings (vlm/audio stubs)
    # --- misc ---
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the JAX package's
        16-way model-parallel row sharding)."""
        return _round_up(self.vocab_size, 256)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def is_attention_layer(self, i: int) -> bool:
        if self.family != "hybrid" or self.attn_every <= 0:
            return True
        # jamba: one attention layer per period of attn_every, at
        # position attn_every // 2; the rest are mamba.
        return i % self.attn_every == self.attn_every // 2

    def is_moe_layer(self, i: int) -> bool:
        return self.num_experts > 0 and i % self.moe_every == 0

    def is_slstm_layer(self, i: int) -> bool:
        return self.slstm_every > 0 and i % self.slstm_every == 0

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for one of the 40 cells."""
    if shape.name == "long_500k" and not model.subquadratic:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{model.name} is pure full-attention (DESIGN.md §4)"
        )
    if shape.kind == "decode" and not model.has_decode:
        return False, f"{model.name} has no decode step"
    return True, ""


# --- quantization policies (the paper's encoding applied to a whole model) --

def train_policy(enabled: bool = True) -> QuantPolicy:
    """Training: fake-quant (±1 weights, float activations) binarization of
    every ``*_proj`` matmul, weight-only, XNOR-Net alpha."""
    return QuantPolicy(enabled=enabled, mode=QuantMode.FAKE_QUANT,
                       binarize_acts=False, use_scale=True, engine="xla")


def serve_policy(enabled: bool = True) -> QuantPolicy:
    """Serving: packed 1-bit weights (paper §3.1), weight-only, XNOR-Net
    alpha, the plain-torch unpack-and-matmul engine."""
    return QuantPolicy(enabled=enabled, mode=QuantMode.PACKED,
                       binarize_acts=False, use_scale=True, engine="xla")


def float_policy() -> QuantPolicy:
    """Control group: the same graph, no binarization (paper §4.3)."""
    return QuantPolicy(enabled=False)


# --- registry ----------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs  # noqa: F401  (registers every arch)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs  # noqa: F401

    return sorted(_REGISTRY)


def smoke_config(name: str) -> ModelConfig:
    """The reduced same-family config of the JAX package's smoke tests:
    few layers, narrow, tiny vocab and expert count, float32."""
    c = get_config(name)
    return dataclasses.replace(
        c,
        num_layers=min(c.num_layers, 4 if c.family in ("hybrid", "ssm") else 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(c.num_kv_heads, 2),
        head_dim=32,
        d_ff=256 if c.d_ff else 0,
        vocab_size=512,
        num_experts=min(c.num_experts, 8),
        experts_per_token=min(c.experts_per_token, 2),
        dense_residual_ff=256 if c.dense_residual_ff else 0,
        encoder_layers=min(c.encoder_layers, 2),
        sliding_window=min(c.sliding_window, 64) if c.sliding_window else 0,
        attn_every=2 if c.attn_every else 0,
        slstm_every=2 if c.slstm_every else 0,
        d_state=8,
        dtype=torch.float32,
    )
