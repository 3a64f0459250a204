"""Deterministic, shardable synthetic data, as ``repro.data.pipeline``.

Batches are generated from ``(seed, step)`` alone with numpy, so any
step's batch is reproducible and equals the JAX package's byte for
byte; only the containers differ (torch tensors here). Each host takes
its slice of the global batch (``host_shard_slice``).

The LM stream is learnable: Zipf unigrams with about half the positions
overwritten by a deterministic successor ``(tok * 7 + 1) % V``.

Not ported yet: the CIFAR batches and ``Prefetcher`` (with BNN training).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 32
    seq_len: int = 512
    vocab_size: int = 32000
    num_classes: int = 10
    image_size: int = 32
    num_hosts: int = 1
    host_id: int = 0


def host_shard_slice(cfg: DataConfig) -> tuple[int, int]:
    """(start, size) of the global batch owned by this host."""
    if cfg.global_batch % cfg.num_hosts:
        raise ValueError(f"global_batch {cfg.global_batch} not divisible by "
                         f"{cfg.num_hosts} hosts")
    per_host = cfg.global_batch // cfg.num_hosts
    return cfg.host_id * per_host, per_host


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    # Stateless: (seed, step) determines the batch on every host.
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))


def synthetic_lm_batches(cfg: DataConfig) -> Iterator[dict]:
    """``{"tokens", "labels": int32 [per_host, seq_len], "step"}`` for
    steps 0, 1, ...: Zipf(1.1) unigrams, about half the positions
    replaced by their predecessor's successor ``(tok * 7 + 1) % V``;
    labels are the tokens shifted by one. CPU tensors."""
    start, per_host = host_shard_slice(cfg)
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    step = 0
    while True:
        rng = _batch_rng(cfg, step)
        base = rng.choice(cfg.vocab_size,
                          size=(cfg.global_batch, cfg.seq_len + 1), p=probs)
        succ = (base[:, :-1] * 7 + 1) % cfg.vocab_size
        mask = rng.random((cfg.global_batch, cfg.seq_len)) < 0.5
        base[:, 1:][mask] = succ[mask]
        tokens = base.astype(np.int32)[start:start + per_host]
        yield {"tokens": torch.from_numpy(np.ascontiguousarray(tokens[:, :-1])),
               "labels": torch.from_numpy(np.ascontiguousarray(tokens[:, 1:])),
               "step": step}
        step += 1
