"""Batched serving for the packed BNN on one device or a serving mesh
(``launch.mesh``): request queue + micro-batcher, shape-bucket ladder or
continuous (ragged) scheduler, executor caches and serving stats.

    from repro_torch.serve import ServingEngine
    eng = ServingEngine(pack_bnn_params_fused(params), engine="xnor")
    eng.warmup()
    rid = eng.submit(images)          # [n, 32, 32, 3] numpy
    eng.step(); eng.drain()
    logits = eng.take(rid)            # [n, 10], bit-identical to
                                      # bnn_apply_fused on images alone

    from repro_torch.serve import ContinuousServingEngine
    eng = ContinuousServingEngine(pack_bnn_params_megakernel(params),
                                  engine="megakernel")

On CUDA every bucket or extent class is served from a captured CUDA
graph (``serve.executor``); ``serve.tuning`` picks a deployment's kernel
tiling.
"""

from repro_torch.serve.buckets import (DEFAULT_BUCKETS, bucket_for,
                                       mesh_buckets, normalize_buckets,
                                       pad_to_bucket)
from repro_torch.serve.continuous import (DEFAULT_MAX_ROWS, ContinuousBatcher,
                                          ContinuousServingEngine, QueueFull)
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.executor import (ExecutorCache, RaggedExecutorCache,
                                        default_extents, extent_for)
from repro_torch.serve.faults import (DeadlineExceeded, DeviceLost,
                                      FallbackPolicy, FaultPlan, FaultSpec,
                                      InjectedFault, NaNLogits, RequestFailed,
                                      RetryPolicy, is_error)
from repro_torch.serve.queue import Batch, MicroBatcher, Request, Segment
from repro_torch.serve.stats import ServeStats, percentile
from repro_torch.serve.tuning import (SERVE_KERNEL, default_serving_candidates,
                                      load_serving_blocks, serving_shape,
                                      tune_serving_blocks)

__all__ = [
    "DEFAULT_BUCKETS", "bucket_for", "mesh_buckets", "normalize_buckets",
    "pad_to_bucket",
    "ServingEngine", "ExecutorCache",
    "ContinuousServingEngine", "ContinuousBatcher", "QueueFull",
    "DEFAULT_MAX_ROWS", "RaggedExecutorCache", "default_extents",
    "extent_for",
    "Batch", "MicroBatcher", "Request", "Segment",
    "ServeStats", "percentile",
    "DeadlineExceeded", "RequestFailed", "is_error", "InjectedFault",
    "NaNLogits", "DeviceLost", "FaultSpec", "FaultPlan", "RetryPolicy", "FallbackPolicy",
    "SERVE_KERNEL", "serving_shape", "default_serving_candidates",
    "load_serving_blocks", "tune_serving_blocks",
]
