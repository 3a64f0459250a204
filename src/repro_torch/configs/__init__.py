"""Experiment configurations of the port. Importing this package
registers every LM architecture of the JAX package; ``ASSIGNED`` lists
them in the JAX package's order, and ``get_config(name)`` /
``list_configs()`` / ``SHAPES`` / ``cell_applicable`` are the API.
``bnn_cifar`` holds the CIFAR BNN's Table 2 presets."""

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_applicable,
    float_policy,
    get_config,
    list_configs,
    serve_policy,
    smoke_config,
    train_policy,
)

# one module per assigned architecture (+ the paper's own model)
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    bnn_cifar,
    jamba_1_5_large_398b,
    mistral_large_123b,
    moonshot_v1_16b_a3b,
    pixtral_12b,
    qwen2_5_3b,
    qwen2_5_32b,
    seamless_m4t_large_v2,
    smollm_360m,
    xlstm_1_3b,
)

ASSIGNED = [
    "moonshot-v1-16b-a3b",
    "arctic-480b",
    "jamba-1.5-large-398b",
    "mistral-large-123b",
    "qwen2.5-32b",
    "smollm-360m",
    "qwen2.5-3b",
    "pixtral-12b",
    "xlstm-1.3b",
    "seamless-m4t-large-v2",
]
