"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
inputs drawn with numpy, handed to the JAX package and to the port."""

import os
import pathlib

import numpy as np
import torch

CKPT = pathlib.Path(__file__).parent / "golden" / "bnn_trained_ckpt.npz"

# Under pytest-xdist, one intra-op thread per worker: the workers run
# side by side, and torch's default of one thread per core in each of
# them oversubscribes the CPU several times over. A serial run keeps
# torch's default.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def words(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform random 32-bit patterns as int32 (about half negative)."""
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32).view(np.int32)


def pm1(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform random ±1.0 float32 values."""
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


def t(x) -> torch.Tensor:
    """A CPU tensor holding a copy of ``x`` (numpy or JAX array)."""
    return torch.from_numpy(np.array(x, copy=True))


def ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Units in the last place between two float32 arrays of one sign."""
    return np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                  - b.astype(np.float32).view(np.int32).astype(np.int64))


def bf16_ulp(x: torch.Tensor, floor: float = 2.0**-8) -> torch.Tensor:
    """One bfloat16 ulp at the magnitude of ``x`` (float32): ``2^(e-7)``
    for ``|x|`` in ``[2^e, 2^(e+1))``, taken at ``floor`` below it, where
    a bf16 ulp shrinks past the float32 rounding of the sums behind it."""
    _, exp = torch.frexp(torch.clamp(x.abs(), min=floor))
    return torch.ldexp(torch.ones_like(x), exp - 8)
