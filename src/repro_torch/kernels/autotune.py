"""Block configuration of the CUDA kernels.

The JAX package tunes its Pallas tiles per shape (``repro.kernels.
autotune``). The port's kernels compile their tiles in (``csrc/
popcount.cuh``, ``csrc/direct_conv.cu``), so this module holds only the
vocabulary — ``AUTO``, ``BlockConfig``, the compiled tile — and
:func:`block_kwargs`, which accepts ``AUTO`` or the compiled tiles and
refuses any other tiling rather than ignore it. No layer takes a tiling
yet: the tuner, its cache and the ``blocks`` argument of the layers
come with a later slice.
"""

from __future__ import annotations

import dataclasses

AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One kernel tiling. ``block_m`` doubles as ``block_d`` (output
    channels per block) for the direct conv."""

    block_m: int = 32
    block_n: int = 32
    block_kw: int = 32
    word_group: int = 1


# The tiling compiled into csrc/: GEMM blocks of 32 rows (one packed
# output word) x 32 columns x 32 K words; direct-conv blocks of
# ``block_m`` = 32 output channels (the conv reads no other field).
COMPILED_TILE = BlockConfig()


def block_kwargs(blocks, *, conv: bool = False) -> dict:
    """Keyword arguments for the kernel wrappers: none, since the tiles
    are compiled in. Raises for a ``BlockConfig`` other than the
    compiled one, so a requested tiling is never silently dropped."""
    if isinstance(blocks, str):
        if blocks != AUTO:
            raise ValueError(f"blocks must be {AUTO!r} or a BlockConfig, "
                             f"got {blocks!r}")
        return {}
    ok = (blocks.block_m == COMPILED_TILE.block_m if conv
          else blocks == COMPILED_TILE)
    if not ok:
        raise ValueError(f"the CUDA kernels compile one tiling in, "
                         f"{COMPILED_TILE}; got {blocks}")
    return {}
