"""Experiment configurations of the port. Importing this package
registers every LM architecture the port runs; ``configs.base`` has
``get_config(name)`` / ``list_configs()``. ``bnn_cifar`` holds the
CIFAR BNN's Table 2 presets."""

from repro_torch.configs import jamba_1_5_large_398b  # noqa: F401
from repro_torch.configs import smollm_360m  # noqa: F401
from repro_torch.configs import xlstm_1_3b  # noqa: F401
