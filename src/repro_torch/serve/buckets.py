"""Shape buckets: the ladder of batch sizes the serving engine runs.

Requests are padded up to a small ladder of bucket sizes
(default 1/8/32/128) and every bucket's executor is built once
(ideally at warmup); steady-state traffic then builds none.

Padding is mathematically free for this model: the BNN forward is
per-sample independent (convs act per image, FCs per row, inference BN
uses fixed statistics), so the logits of the real rows are bit-identical
whether the batch carries 3 images or 3 real + 5 padding images — the
core correctness claim of bucketing, asserted for every engine x
conv_impl pair in ``tests/test_torch_serve.py``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# Batch-size ladder. Small enough that warmup stays cheap,
# geometric enough that padding waste is bounded (<= ~4x at the seams,
# far less in aggregate under mixed traffic — BENCH_serving.json
# records the realized padding overhead).
DEFAULT_BUCKETS = (1, 8, 32, 128)


def normalize_buckets(buckets: Sequence[int]) -> tuple[int, ...]:
    """Sorted, deduplicated, validated bucket ladder."""
    out = sorted(set(int(b) for b in buckets))
    if not out or out[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    return tuple(out)


def mesh_buckets(buckets: Sequence[int], devices: int) -> tuple[int, ...]:
    """The ladder a meshed engine serves: every rung rounded up to a
    multiple of ``devices``, then normalized (rungs that collapse merge),
    so each dispatched batch splits into equal shards across the serving
    mesh. With 8 devices the default 1/8/32/128 ladder becomes 8/32/128:
    light traffic pays at most ``devices - 1`` zero pad rows a dispatch,
    the price of a forward without collectives."""
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    if devices == 1:
        return normalize_buckets(buckets)
    return normalize_buckets(-(-int(b) // devices) * devices for b in buckets)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n. ``n`` must not exceed the largest bucket
    (the micro-batcher never assembles more rows than that)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} rows exceeds largest bucket {buckets[-1]}")


def pad_to_bucket(images: np.ndarray, bucket: int) -> np.ndarray:
    """Pad a ``[n, ...]`` image batch with zero rows up to ``bucket``.

    Zero images are valid model inputs (the first conv consumes real
    values), so the padded rows execute normally and their logits are
    discarded; they cannot perturb the real rows (per-sample
    independence, see module docstring).
    """
    n = images.shape[0]
    if n > bucket:
        raise ValueError(f"{n} rows do not fit bucket {bucket}")
    if n == bucket:
        return images
    pad = np.zeros((bucket - n,) + images.shape[1:], dtype=images.dtype)
    return np.concatenate([np.asarray(images), pad], axis=0)


__all__ = ["DEFAULT_BUCKETS", "mesh_buckets", "normalize_buckets",
           "bucket_for", "pad_to_bucket"]
