"""Batched serving for the packed BNN on one device: request queue +
micro-batcher, shape-bucket ladder or continuous (ragged) scheduler,
executor caches and serving stats.

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
"""

from repro_torch.serve.buckets import (DEFAULT_BUCKETS, bucket_for,
                                       normalize_buckets, pad_to_bucket)
from repro_torch.serve.continuous import (DEFAULT_MAX_ROWS, ContinuousBatcher,
                                          ContinuousServingEngine, QueueFull)
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.executor import (ExecutorCache, RaggedExecutorCache,
                                        default_extents, extent_for)
from repro_torch.serve.faults import (DeadlineExceeded, FallbackPolicy,
                                      FaultPlan, FaultSpec, InjectedFault,
                                      NaNLogits, RequestFailed, RetryPolicy,
                                      is_error)
from repro_torch.serve.queue import Batch, MicroBatcher, Request, Segment
from repro_torch.serve.stats import ServeStats, percentile

__all__ = [
    "DEFAULT_BUCKETS", "bucket_for", "normalize_buckets", "pad_to_bucket",
    "ServingEngine", "ExecutorCache",
    "ContinuousServingEngine", "ContinuousBatcher", "QueueFull",
    "DEFAULT_MAX_ROWS", "RaggedExecutorCache", "default_extents",
    "extent_for",
    "Batch", "MicroBatcher", "Request", "Segment",
    "ServeStats", "percentile",
    "DeadlineExceeded", "RequestFailed", "is_error", "InjectedFault",
    "NaNLogits", "FaultSpec", "FaultPlan", "RetryPolicy", "FallbackPolicy",
]
