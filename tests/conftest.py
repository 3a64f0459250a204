"""Session-scoped multi-device simulation for the whole test run.

The mesh-sharded serving tests (tests/test_sharded_serve.py, the
device-count legs of the property/golden suites) need more than one
jax device, and jax locks the device count at first backend
initialization — so the flag must be injected BEFORE any test module
imports jax. A root conftest is the one file pytest guarantees to
import first; setting the env var at module scope here is therefore
the "session-scoped fixture" that every test shares.

Forcing 8 host devices is bit-neutral for every single-device test:
computations without an explicit sharding run on device 0 exactly as
before (the golden-logits fixture passing unchanged under this
conftest is the proof, and is itself asserted — tests/test_golden.py).
A count already present in XLA_FLAGS (e.g. a CI leg exporting its own)
wins over the default here.
"""

import os

FORCED_HOST_DEVICES = 8

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        f"{_flags} --xla_force_host_platform_device_count="
        f"{FORCED_HOST_DEVICES}"
    ).strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU, nvcc and the CUDA build of torch "
        "(tests/test_torch_cuda.py; skipped without a GPU)",
    )
