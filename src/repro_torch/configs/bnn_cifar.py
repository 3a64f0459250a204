"""The paper's own evaluation setup: the Courbariaux BNN on CIFAR-10
(paper §4.2) with the kernel modes of Table 2, as ``BNNConfig`` presets
of :func:`repro_torch.core.bnn.bnn_apply`. Same presets as
``repro.configs.bnn_cifar``.
"""

import dataclasses

from repro_torch.core.binarize import QuantMode
from repro_torch.core.bnn import BNNConfig


@dataclasses.dataclass(frozen=True)
class BNNExperiment:
    name: str
    batch: int = 64
    num_batches: int = 16     # timed inference batches (the paper used 10k images)


# Table 2 rows
PAPER_KERNEL = BNNConfig(mode=QuantMode.PACKED, engine="xnor")     # "Our Kernel"
DIRECT_KERNEL = BNNConfig(mode=QuantMode.PACKED, engine="xnor",    # no im2col
                          conv_impl="direct")
MXU_KERNEL = BNNConfig(mode=QuantMode.PACKED, engine="unpack")     # weight unpack GEMM
XLA_PACKED = BNNConfig(mode=QuantMode.PACKED, engine="xla")        # plain torch
CONTROL_GROUP = BNNConfig(mode=QuantMode.FLOAT)                    # "Control Group"
SIMULATION = BNNConfig(mode=QuantMode.FAKE_QUANT)                  # released BNNs

PRESETS = {
    "PAPER_KERNEL": PAPER_KERNEL,
    "DIRECT_KERNEL": DIRECT_KERNEL,
    "MXU_KERNEL": MXU_KERNEL,
    "XLA_PACKED": XLA_PACKED,
    "CONTROL_GROUP": CONTROL_GROUP,
    "SIMULATION": SIMULATION,
}
