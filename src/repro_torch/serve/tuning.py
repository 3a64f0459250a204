"""Serving-level tiling: one ``blocks`` config for a whole deployed
engine, tuned at the bucket the fleet runs most (the port of
``repro.serve.tuning``).

``kernels.autotune.tune`` tunes one kernel at one shape. A deployment
wants the complement: one :class:`~repro_torch.kernels.autotune.BlockConfig`
for every kernel of the forward, chosen where batching pays most, the
largest bucket. :func:`tune_serving_blocks` times whole
``bnn_serve_fn`` forwards (each replayed from a CUDA graph, as the
executors serve them) across Hopper tilings: the tensor-core tile widths
of the per-layer engines, their K split, the megakernels' clusters. A
candidate's logits must equal the ``AUTO`` logits bit for bit, else it
raises and stores nothing; the fastest is stored in the autotune cache
(kernel name ``"bnn_serve"``, shape key engine / conv_impl / bucket,
stamped and ignored on a stale stamp like every entry), and
:func:`load_serving_blocks` reads it back at warmup, so serving never
re-measures.
"""

from __future__ import annotations

from typing import Iterable, Optional, Union

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import AUTO, BlockConfig

SERVE_KERNEL = "bnn_serve"

Blocks = Union[str, BlockConfig]


def serving_shape(engine: str, conv_impl: str, bucket: int) -> dict:
    """The autotune-cache shape key of one serving configuration."""
    return {"engine": engine, "conv": conv_impl, "bucket": bucket}


def default_serving_candidates(bucket: int, engine: str = "xnor") -> list[Blocks]:
    """``AUTO`` and the whole-forward tilings of ``engine``: each tile
    width for every layer, and no K split, for the per-layer engines;
    each cluster of the conv stages and of the chain for the megakernel.
    (``bucket`` keeps the JAX package's signature: the tilings here do
    not depend on it.)"""
    del bucket
    cands: list[Blocks] = [AUTO]
    if engine.startswith("megakernel"):
        cands += [BlockConfig(stage_cluster=c) for c in (2, 4)]
        cands += [BlockConfig(chain_cluster=c) for c in (4, 8, 16)]
    else:
        cands += [BlockConfig(block_n=bn) for bn in autotune.TILE_NS]
        cands.append(BlockConfig(k_splits=1))
    return cands


def load_serving_blocks(engine: str, conv_impl: str, bucket: int) -> Blocks:
    """The cached serving config of this engine / conv_impl / bucket, or
    ``AUTO`` (no entry, a stale stamp, or the cache disabled)."""
    if not autotune.cache_enabled():
        return AUTO
    cfg = autotune.load_entry(SERVE_KERNEL,
                              serving_shape(engine, conv_impl, bucket))
    return cfg if cfg is not None else AUTO


def tune_serving_blocks(
    packed_params: dict,
    bucket: int,
    *,
    engine: str = "xnor",
    conv_impl: str = "im2col",
    candidates: Optional[Iterable[Blocks]] = None,
    cache: bool = True,
    timings: Optional[dict] = None,
    timer=None,
) -> Blocks:
    """Time the whole forward per candidate at ``bucket`` images on the
    params' device and return the fastest (stored in the cache when it
    is a ``BlockConfig``, ``cache`` is on and ``REPRO_AUTOTUNE`` is not
    0). ``timings`` receives seconds per forward by candidate (``None``
    for one the kernels refuse, e.g. a cluster whose shared memory
    exceeds a block's); ``timer`` defaults to ``kernels.autotune.time_call``.
    Raises ``RuntimeError`` if a candidate's logits differ from AUTO's."""
    from repro_torch.core.bnn import bnn_serve_fn
    from repro_torch.serve.executor import IMAGE_SHAPE, params_device

    timer = timer or autotune.time_call
    dev = params_device(packed_params)
    gen = torch.Generator().manual_seed(bucket)
    images = torch.randn((bucket,) + IMAGE_SHAPE, generator=gen).to(dev)
    want = bnn_serve_fn(engine=engine, conv_impl=conv_impl)(packed_params, images)
    cands = (list(candidates) if candidates is not None
             else default_serving_candidates(bucket, engine))
    best, best_t = None, float("inf")
    for blocks in cands:
        fn = bnn_serve_fn(engine=engine, conv_impl=conv_impl, blocks=blocks)
        try:
            got = fn(packed_params, images)
        except ValueError:
            if timings is not None:
                timings[blocks] = None
            continue
        if not torch.equal(got, want):
            raise RuntimeError(f"serving tiling {autotune.blocks_key(blocks)} "
                               f"changed the {engine}/{conv_impl} logits at "
                               f"bucket {bucket}; nothing is cached")
        t = timer(lambda fn=fn: fn(packed_params, images))
        if timings is not None:
            timings[blocks] = t
        if t < best_t:
            best, best_t = blocks, t
    if best is None:
        raise ValueError(f"no serving tiling runs for {engine}/{conv_impl} "
                         f"at bucket {bucket}")
    if cache and autotune.cache_enabled() and isinstance(best, BlockConfig):
        autotune.save_entry(SERVE_KERNEL,
                            serving_shape(engine, conv_impl, bucket), best,
                            wall_s=best_t)
    return best


__all__ = ["SERVE_KERNEL", "serving_shape", "default_serving_candidates",
           "load_serving_blocks", "tune_serving_blocks"]
